// Row-wise inclusive scans of int32 [rows, len] streams for Hopper (sm_90a).
//
// Replaces the per-scan Pallas kernel of the JAX package
// (textblaster_tpu/ops/pallas_scan.py, `_pallas_scan_tuple` + `_scan_body`)
// under its two associative ops:
//
//   * affine (`_affine_op`): the shared-multiplier affine map h -> m*h + a,
//     composed earlier-then-later as (mx*my, ay + my*ax) for 1 or 2
//     accumulator streams (`affine_hash_scan`); only the accumulators are
//     written out.  All arithmetic is uint32, which gives the int32
//     wraparound the JAX op relies on (signed overflow is undefined in C++).
//   * dfa (`_dfa_op`): composition of nibble-packed transition maps of a
//     DFA with n_states <= 8 states, (b . a)(s) = b[a[s]], every nibble at
//     or above n_states cleared (`dfa_compose_scan`).
//
// Neither op is commutative: every combine keeps the earlier operand on
// the left.
//
// Bound: memory.  The scan reads 4*rows*len*(1+k) bytes and writes
// 4*rows*len*k (k accumulator streams; the DFA scan is k = 1 with no
// multiplier): 84 MB at [64, 65536], k = 2, which is 25 us at 3.35 TB/s.
// A row's elements are read into registers once and written once; nothing
// is staged through shared memory.  A row is a dependent chain: its lanes
// are spread over a cluster, not over independent CTAs.
//
// Design: scan_ops.cuh's register-held row scan (scan_row, shared with
// fused.cu), laid out by ops/scan.py's scan_geometry, which is passed in
// and re-checked here: a row is `cluster` chunks of `threads * ITEMS`
// consecutive lanes, one CTA each (a thread block cluster when
// cluster > 1), walked in `segs` segments.
//   * affine: ITEMS = 4, one 16-byte load per stream and thread, so a warp
//     reads 512 contiguous bytes per instruction; the next segment's loads
//     start before this segment's barriers.  Rows of <= 8192 lanes are
//     one CTA of <= 512 threads; wider rows a 2-CTA cluster of 1024 threads
//     walking 8192-lane segments (64 rows: 128 CTAs, about one per SM,
//     streaming).
//   * dfa: ITEMS = 16, to spread each thread's share of the scan's combines
//     over more lanes (the op costs ~10 integer operations, the memory 8
//     bytes, per lane).  Rows of <= 2048 lanes are one CTA; wider ones a
//     cluster of up to 8 CTAs of 64 (<= 8192 lanes) or 128 threads.
// Loads and stores are 16-byte vectors where every stream's base is 16-byte
// aligned and len % 4 == 0 (checked here: a torch view may be offset).
// Trials on the card that lost: one warp per row at <= 512 lanes (no
// faster than this path), eight affine lanes a thread (two 16-byte
// accesses each, half of every sector per instruction), prefetching the
// DFA's 16 lanes (register pressure); 16-CTA clusters (non-portable) gained
// the DFA only a few percent and were not taken.
//
// The ops are scan_ops.cuh's Affine<K> and Dfa<NS> (the DFA combine in
// byte form, __byte_perm lookups).  The plain schedule (`shift_scan_tuple`)
// passes every lane of a row of >= 2 lanes through the op, which clears the
// nibbles at or above n_states; a row of one lane it returns unchanged, and
// so does the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ops.cuh"

namespace {

using tb::Affine;
using tb::Dfa;
using tb::RowPtrs;

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// One CTA (cluster == 1) or a cluster of `cluster` CTAs per row, each CTA
// a chunk of blockDim.x * ITEMS lanes, the row walked in `segs` segments of
// `cluster` chunks: scan_ops.cuh's scan_row.
template <class Op>
__global__ void __launch_bounds__(MAX_THREADS)
scan_rows(RowPtrs p, int len, int cluster, int segs, int vec) {
  __shared__ uint32_t warp_tot[2][32][Op::N];
  __shared__ uint32_t chunk_tot[2][Op::N];
  tb::scan_row<Op>(p, warp_tot, chunk_tot, blockIdx.x / cluster, len, cluster, segs, vec != 0,
                   false);
}

bool aligned16(const void* ptr) { return ptr == nullptr || ((uintptr_t)ptr & 15u) == 0; }

// Launches Op's scan with the geometry of ops/scan.py's scan_geometry:
// `cluster` CTAs of `threads` threads per row, walked in `segs` segments.
template <class Op>
int launch(const RowPtrs& p, int rows, int len, int cluster, int threads, int segs,
           cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  const long long chunk = (long long)threads * Op::ITEMS;
  if (rows < 1 || len < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      cluster < 1 || cluster > MAX_CLUSTER || segs < 1 || chunk * cluster * segs < len ||
      chunk * cluster * (segs - 1) >= len || (long long)rows * cluster > 0x7fffffffLL)
    return bad;
  bool vec = len % 4 == 0;
  for (int k = 0; k < Op::N_IN; ++k) {
    if (p.in[k] == nullptr) return bad;
    vec = vec && aligned16(p.in[k]);
  }
  for (int k = 0; k < Op::N_OUT; ++k) {
    if (p.out[k] == nullptr) return bad;
    vec = vec && aligned16(p.out[k]);
  }
  if (cluster == 1) {  // no cluster: the plain launch
    scan_rows<Op><<<rows, threads, 0, stream>>>(p, len, 1, segs, (int)vec);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, scan_rows<Op>, p, len, cluster, segs, (int)vec);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int NS>
int launch_dfa(const RowPtrs& p, int rows, int len, int cluster, int threads, int segs,
               cudaStream_t stream) {
  return launch<Dfa<NS>>(p, rows, len, cluster, threads, segs, stream);
}

}  // namespace

extern "C" {

// Inclusive affine-hash scan of (m, a1[, a2]) along each row; writes the
// scanned accumulators o1 (and o2 when k == 2).  (cluster, threads, segs)
// is ops/scan.py's scan_geometry(len).  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for an empty shape, a geometry that does not cover
// the row, or a missing pointer.
int tb_affine_scan(const int32_t* m, const int32_t* a1, const int32_t* a2, int32_t* o1,
                   int32_t* o2, int rows, int len, int k, int cluster, int threads, int segs,
                   cudaStream_t stream) {
  const RowPtrs p = {{m, a1, a2}, {o1, o2}};
  if (k == 1) return launch<Affine<1>>(p, rows, len, cluster, threads, segs, stream);
  if (k == 2) return launch<Affine<2>>(p, rows, len, cluster, threads, segs, stream);
  return (int)cudaErrorInvalidValue;
}

// Inclusive composition scan of nibble-packed DFA maps (1 <= n_states <= 8).
int tb_dfa_scan(const int32_t* fns, int32_t* out, int rows, int len, int n_states, int cluster,
                int threads, int segs, cudaStream_t stream) {
  const RowPtrs p = {{fns}, {out}};
  switch (n_states) {
    case 1: return launch_dfa<1>(p, rows, len, cluster, threads, segs, stream);
    case 2: return launch_dfa<2>(p, rows, len, cluster, threads, segs, stream);
    case 3: return launch_dfa<3>(p, rows, len, cluster, threads, segs, stream);
    case 4: return launch_dfa<4>(p, rows, len, cluster, threads, segs, stream);
    case 5: return launch_dfa<5>(p, rows, len, cluster, threads, segs, stream);
    case 6: return launch_dfa<6>(p, rows, len, cluster, threads, segs, stream);
    case 7: return launch_dfa<7>(p, rows, len, cluster, threads, segs, stream);
    case 8: return launch_dfa<8>(p, rows, len, cluster, threads, segs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The runtime's name and message for a CUDA error code, as every entry of
// the port's libraries returns them (kernels/build.py check()).
const char* tb_error_name(int err) { return cudaGetErrorName((cudaError_t)err); }
const char* tb_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
