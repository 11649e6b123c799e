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
//     DFA with n_states <= 8 states, (b . a)(s) = b[a[s]], using logical
//     shifts, because the packed maps use all 32 bits (`dfa_compose_scan`).
//
// Neither op is commutative: every combine keeps the earlier operand on
// the left.
//
// Design: the tile scan of scan_ops.cuh (shared with fused.cu and
// chain.cu).  One CTA per row walks the row in tiles of SCAN_TILE elements
// with a carried prefix; a tile is staged through shared memory with
// coalesced loads, each thread composes SCAN_ITEMS consecutive elements, a
// warp scan with __shfl_up_sync combines the thread aggregates, and the
// warp totals are combined through shared memory.  The ragged edge is
// filled with the op's identity, so any [rows, len] shape is accepted.
//
// Bound: memory.  The scan reads 4*rows*len*(1+k) bytes and writes
// 4*rows*len*k (k accumulator streams; the DFA scan is k = 1 with no
// multiplier), so at least 4*rows*len*(1+2k) bytes cross HBM.  Known
// weakness: a batch of 64 rows gives 64 CTAs on 132 SMs; splitting a row
// across CTAs (decoupled look-back) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ops.cuh"

namespace {

using namespace tb;

// Up to three input streams (the affine multiplier and two accumulators,
// or one DFA map stream); the scanned streams Op::FIRST_OUT..N-1 are
// written to out0, out1 (the affine multiplier is internal, the DFA map is
// its own output).
template <class Op>
__global__ void __launch_bounds__(SCAN_THREADS)
row_scan_kernel(const int32_t* __restrict__ in0, const int32_t* __restrict__ in1,
                const int32_t* __restrict__ in2, int32_t* __restrict__ out0,
                int32_t* __restrict__ out1, int len, Op op) {
  constexpr int N = Op::N;
  __shared__ TileSmem<N> sm;
  const int32_t* all_in[3] = {in0, in1, in2};
  int32_t* all_out[2] = {out0, out1};
  const int32_t* ins[N];
  int32_t* outs[N] = {};
#pragma unroll
  for (int k = 0; k < N; ++k) ins[k] = all_in[k];
#pragma unroll
  for (int k = 0; k < N - Op::FIRST_OUT; ++k) outs[k] = all_out[k];
  scan_row(op, sm, ins, outs, false, blockIdx.x, len);
}

}  // namespace

extern "C" {

// Inclusive affine-hash scan of (m, a1[, a2]) along each row; writes the
// scanned accumulators o1 (and o2 when k == 2).  Returns cudaGetLastError().
int tb_affine_scan(const int32_t* m, const int32_t* a1, const int32_t* a2,
                   int32_t* o1, int32_t* o2, int rows, int len, int k,
                   cudaStream_t stream) {
  if (rows <= 0 || len <= 0) return (int)cudaSuccess;
  if (k == 1) {
    row_scan_kernel<<<rows, SCAN_THREADS, 0, stream>>>(m, a1, nullptr, o1, nullptr, len,
                                                       AffineOp<1>{});
  } else if (k == 2) {
    row_scan_kernel<<<rows, SCAN_THREADS, 0, stream>>>(m, a1, a2, o1, o2, len, AffineOp<2>{});
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Inclusive composition scan of nibble-packed DFA maps (n_states <= 8).
int tb_dfa_scan(const int32_t* fns, int32_t* out, int rows, int len, int n_states,
                cudaStream_t stream) {
  if (rows <= 0 || len <= 0) return (int)cudaSuccess;
  if (n_states < 1 || n_states > 8) return (int)cudaErrorInvalidValue;
  row_scan_kernel<<<rows, SCAN_THREADS, 0, stream>>>(fns, nullptr, nullptr, out, nullptr, len,
                                                     DfaOp{n_states});
  return (int)cudaGetLastError();
}

}  // extern "C"
