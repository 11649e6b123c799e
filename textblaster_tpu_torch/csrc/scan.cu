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
// Design (the geometry is ops/scan.py's scan_geometry, passed in and
// re-checked here).  A row is `cluster` chunks of `threads * ITEMS`
// consecutive lanes, one CTA each (a thread block cluster when cluster > 1),
// walked in `segs` segments of `cluster` chunks with the segment totals
// carried from one to the next.  A thread holds ITEMS consecutive lanes in
// registers: a thread walk, a __shfl_up_sync warp scan, the warp totals
// through shared memory and, after the one barrier, a shuffle scan of them
// by every warp (no thread folds alone); in a cluster each CTA publishes its
// chunk's aggregate, and after cluster.sync() every warp reads the
// cluster's aggregates through distributed shared memory and folds them in
// rank order, the earlier chunk on the left; then a re-walk from the
// thread's prefix, stored four lanes at a time.
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
// Loads and stores are 16-byte vectors (uint4) where every stream's base is
// 16-byte aligned and len % 4 == 0 (checked here: a torch view may be
// offset), scalar otherwise; lanes past the row's end hold the identity.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using tb::Affine;
using tb::Dfa;
using tb::shfl_up;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// Up to three input streams (the affine multiplier and two accumulators,
// or one DFA map stream) and two output streams, by value.
struct Ptrs {
  const int32_t* in[3];
  int32_t* out[2];
};

template <class Op>
__device__ __forceinline__ typename Op::State shfl_idx(const typename Op::State& s, int src) {
  typename Op::State r;
#pragma unroll
  for (int k = 0; k < Op::N; ++k) r.v[k] = __shfl_sync(FULL, s.v[k], src);
  return r;
}

// Inclusive scan over lanes 0..n-1 of the warp (earlier lanes on the left).
template <class Op>
__device__ __forceinline__ typename Op::State warp_inclusive(typename Op::State x, int lane,
                                                             int n = 32) {
  for (int off = 1; off < n; off <<= 1) {
    const typename Op::State o = shfl_up<Op>(x, off);
    if (lane >= off) x = Op::combine(o, x);
  }
  return x;
}

// The lane's exclusive prefix from the warp's inclusive scan.
template <class Op>
__device__ __forceinline__ typename Op::State lane_exclusive(const typename Op::State& inc,
                                                             int lane) {
  const typename Op::State e = shfl_up<Op>(inc, 1);
  return lane == 0 ? Op::identity() : e;
}

// Loads the IT consecutive elements at g0.. of the row at `off`; lanes
// past len hold the identity.
template <class Op, int IT>
__device__ __forceinline__ void load(const Ptrs& p, size_t off, long long g0, int len, bool vec,
                                     typename Op::Elem (&e)[IT]) {
  uint32_t raw[IT][Op::N_IN];
  if (vec && g0 + IT <= len) {
#pragma unroll
    for (int k = 0; k < Op::N_IN; ++k) {
      const uint4* src = reinterpret_cast<const uint4*>(p.in[k] + off + g0);
#pragma unroll
      for (int j = 0; j < IT / 4; ++j) {
        const uint4 v = src[j];
        raw[4 * j][k] = v.x;
        raw[4 * j + 1][k] = v.y;
        raw[4 * j + 2][k] = v.z;
        raw[4 * j + 3][k] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < Op::N_IN; ++k) {
#pragma unroll
      for (int j = 0; j < IT; ++j)
        raw[j][k] = g0 + j < len ? (uint32_t)p.in[k][off + g0 + j] : Op::raw_identity(k);
    }
  }
#pragma unroll
  for (int j = 0; j < IT; ++j) e[j] = Op::elem(raw[j]);
}

// The thread's aggregate of its IT elements.
template <class Op, int IT>
__device__ __forceinline__ typename Op::State fold(const typename Op::Elem (&e)[IT]) {
  typename Op::State a = Op::identity();
#pragma unroll
  for (int j = 0; j < IT; ++j) a = Op::step(a, e[j]);
  return a;
}

// Re-walks the IT elements from the prefix `run` and stores the scanned
// output streams, four lanes at a time.
template <class Op, int IT>
__device__ __forceinline__ void rewalk_store(const Ptrs& p, size_t off, long long g0, int len,
                                             bool vec, typename Op::State run,
                                             const typename Op::Elem (&e)[IT]) {
  const bool full = vec && g0 + IT <= len;
#pragma unroll
  for (int j4 = 0; j4 < IT; j4 += 4) {
    uint32_t o[Op::N_OUT][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run = Op::step(run, e[j4 + j]);
#pragma unroll
      for (int k = 0; k < Op::N_OUT; ++k) o[k][j] = Op::out(run, k);
    }
#pragma unroll
    for (int k = 0; k < Op::N_OUT; ++k) {
      if (full) {
        *reinterpret_cast<uint4*>(p.out[k] + off + g0 + j4) =
            make_uint4(o[k][0], o[k][1], o[k][2], o[k][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g0 + j4 + j < len) p.out[k][off + g0 + j4 + j] = (int32_t)o[k][j];
      }
    }
  }
}

// One CTA (cluster == 1) or a cluster of `cluster` CTAs per row, each CTA
// a chunk of blockDim.x * ITEMS lanes, the row walked in `segs` segments of
// `cluster` chunks.
template <class Op>
__global__ void __launch_bounds__(MAX_THREADS)
scan_rows(Ptrs p, int len, int cluster, int segs, int vec) {
  using State = typename Op::State;
  using Elem = typename Op::Elem;
  constexpr int IT = Op::ITEMS;
  __shared__ uint32_t warp_tot[2][32][Op::N];
  __shared__ uint32_t chunk_tot[2][Op::N];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;
  const int rank = cluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t off = (size_t)(blockIdx.x / cluster) * (size_t)len;
  if (len == 1) {  // the plain schedule applies no op to a one-lane row
    if (t == 0 && rank == 0) {
#pragma unroll
      for (int k = 0; k < Op::N_OUT; ++k) p.out[k][off] = p.in[Op::in_of_out(k)][off];
    }
    return;
  }
  const long long chunk = (long long)blockDim.x * IT;
  const long long seg_lanes = chunk * cluster;
  const long long first = rank * chunk + (long long)t * IT;  // in segment 0
  Elem next[IT];
  if (Op::PREFETCH) load<Op, IT>(p, off, first, len, vec != 0, next);
  State carry = Op::identity();  // the segments before this one
  for (int s = 0; s < segs; ++s) {
    const int par = s & 1;
    const long long g0 = s * seg_lanes + first;
    Elem e[IT];
    if (Op::PREFETCH) {
#pragma unroll
      for (int j = 0; j < IT; ++j) e[j] = next[j];
      // The next segment's loads fly during this segment's barriers.
      if (s + 1 < segs) load<Op, IT>(p, off, g0 + seg_lanes, len, vec != 0, next);
    } else {
      load<Op, IT>(p, off, g0, len, vec != 0, e);
    }
    const State inc = warp_inclusive<Op>(fold<Op, IT>(e), lane);
    const State excl = lane_exclusive<Op>(inc, lane);
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < Op::N; ++k) warp_tot[par][warp][k] = inc.v[k];
    }
    __syncthreads();
    // Every warp folds the warp totals in order: lane w holds warp w's.
    State wt = Op::identity();
    if (lane < n_warps) {
#pragma unroll
      for (int k = 0; k < Op::N; ++k) wt.v[k] = warp_tot[par][lane][k];
    }
    const State wi = warp_inclusive<Op>(wt, lane, n_warps);
    const State wp = shfl_idx<Op>(wi, (warp + 31) & 31);
    const State warp_pref = warp == 0 ? Op::identity() : wp;
    State seg_total = shfl_idx<Op>(wi, n_warps - 1);
    State chunk_pref = Op::identity();
    if (cluster > 1) {
      cg::cluster_group cl = cg::this_cluster();
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < Op::N; ++k) chunk_tot[par][k] = seg_total.v[k];
      }
      cl.sync();
      // Lane c holds chunk c's aggregate: the chunks in row order.
      State a = Op::identity();
      if (lane < cluster) {
        const uint32_t* src = cl.map_shared_rank(&chunk_tot[par][0], lane);
#pragma unroll
        for (int k = 0; k < Op::N; ++k) a.v[k] = src[k];
      }
      const State ci = warp_inclusive<Op>(a, lane, cluster);
      const State cp = shfl_idx<Op>(ci, (rank + 31) & 31);
      if (rank > 0) chunk_pref = cp;
      seg_total = shfl_idx<Op>(ci, cluster - 1);
    }
    const State pre = Op::combine(Op::combine(Op::combine(carry, chunk_pref), warp_pref), excl);
    rewalk_store<Op, IT>(p, off, g0, len, vec != 0, pre, e);
    carry = Op::combine(carry, seg_total);
  }
  // No CTA leaves while a peer may still read its chunk aggregates.
  if (cluster > 1) cg::this_cluster().sync();
}

bool aligned16(const void* ptr) { return ptr == nullptr || ((uintptr_t)ptr & 15u) == 0; }

// Launches Op's scan with the geometry of ops/scan.py's scan_geometry:
// `cluster` CTAs of `threads` threads per row, walked in `segs` segments.
template <class Op>
int launch(const Ptrs& p, int rows, int len, int cluster, int threads, int segs,
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
int launch_dfa(const Ptrs& p, int rows, int len, int cluster, int threads, int segs,
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
  const Ptrs p = {{m, a1, a2}, {o1, o2}};
  if (k == 1) return launch<Affine<1>>(p, rows, len, cluster, threads, segs, stream);
  if (k == 2) return launch<Affine<2>>(p, rows, len, cluster, threads, segs, stream);
  return (int)cudaErrorInvalidValue;
}

// Inclusive composition scan of nibble-packed DFA maps (1 <= n_states <= 8).
int tb_dfa_scan(const int32_t* fns, int32_t* out, int rows, int len, int n_states, int cluster,
                int threads, int segs, cudaStream_t stream) {
  const Ptrs p = {{fns, nullptr, nullptr}, {out, nullptr}};
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

}  // extern "C"
