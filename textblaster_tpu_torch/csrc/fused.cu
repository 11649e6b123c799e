// Fused multi-group row scan of int32 [rows, len] streams for Hopper (sm_90a).
//
// Replaces the fused Pallas megakernel of the JAX package
// (textblaster_tpu/ops/pallas_scan.py, `_fused_call` + `_fused_body`),
// reached through `fused_scan`.  One launch evaluates a list of independent
// scan groups over every row:
//
//   * affine (`_affine_op`): the shared-multiplier affine map h -> m*h + a
//     over (m, a1..ak), composed earlier-then-later as (mx*my, ay + my*ax);
//     only the accumulators are written out.  Accumulators are scanned in
//     units of up to 4 beside the multiplier (a unit re-reads m).
//   * add (`_add_op`): n independent running sums, one unit per stream.
//   * dfa (`_dfa_op`): composition of nibble-packed transition maps with
//     n_states <= 8, (b . a)(s) = b[a[s]], using logical shifts.
//
// Each group emits its scanned streams (emit "scan", [rows, len]) or only
// its final carry (emit "last", [rows, 1]).  The ops and the tile constants
// are in scan_ops.cuh (uint32 arithmetic, earlier operand on the left).
//
// Design: the tile scan of scan_ops.cuh (its ops shared with chain.cu).
// One CTA per row; for each group in order, the CTA walks the
// row in tiles of SCAN_TILE elements with a carried prefix.  A tile is
// staged through shared memory with coalesced loads, each thread composes
// SCAN_ITEMS consecutive elements, a __shfl_up_sync warp scan combines the
// thread aggregates and the warp totals are combined through shared memory.
// An emit-"last" unit skips the re-walk and the stores and writes only its
// carry.  The ragged edge holds the op's identity, so any [rows, len] shape
// is taken.  The group list travels as a by-value kernel parameter block
// (no pointer table copied per call).
//
// Bound: memory.  The launch moves at least
//   4*rows*len*(sum of inputs + sum of scanned outputs) + 4*rows*(sum of last outputs)
// bytes.  Known weakness: 64 rows are 64 CTAs on 132 SMs,
// and the groups of a row run one after another; splitting rows across
// CTAs and staging tiles with cp.async is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ops.cuh"

namespace {

using namespace tb;

constexpr int MAX_GROUPS = 8;
constexpr int MAX_STREAMS = 16;
constexpr int MAX_UNIT = 5;  // streams in one scan unit: m + 4 accumulators
constexpr int MAX_ACCS = MAX_UNIT - 1;

enum Kind { KIND_AFFINE = 0, KIND_ADD = 1, KIND_DFA = 2 };

struct FusedParams {
  int n_groups;
  int kind[MAX_GROUPS];
  int n_in[MAX_GROUPS];
  int emit_last[MAX_GROUPS];
  int n_states[MAX_GROUPS];
  const int32_t* in[MAX_STREAMS];
  int32_t* out[MAX_STREAMS];
};

using Smem = TileSmem<MAX_UNIT>;

// --- kernel ---------------------------------------------------------------

__global__ void __launch_bounds__(SCAN_THREADS) fused_scan_kernel(FusedParams p, int len) {
  __shared__ Smem sm;
  const size_t row = blockIdx.x;
  int in_i = 0, out_i = 0;
  for (int g = 0; g < p.n_groups; ++g) {
    const int n = p.n_in[g];
    const bool last = p.emit_last[g] != 0;
    const int32_t* ins[MAX_UNIT] = {};
    int32_t* outs[MAX_UNIT] = {};
    if (p.kind[g] == KIND_AFFINE) {
      ins[0] = p.in[in_i];
      for (int a = 1; a < n; a += MAX_ACCS) {
        const int k = n - a < MAX_ACCS ? n - a : MAX_ACCS;
        for (int j = 0; j < k; ++j) {
          ins[1 + j] = p.in[in_i + a + j];
          outs[j] = p.out[out_i + a - 1 + j];
        }
        switch (k) {
          case 1: scan_row(AffineOp<1>{}, sm, ins, outs, last, row, len); break;
          case 2: scan_row(AffineOp<2>{}, sm, ins, outs, last, row, len); break;
          case 3: scan_row(AffineOp<3>{}, sm, ins, outs, last, row, len); break;
          default: scan_row(AffineOp<4>{}, sm, ins, outs, last, row, len); break;
        }
      }
      out_i += n - 1;
    } else if (p.kind[g] == KIND_ADD) {
      for (int s = 0; s < n; ++s) {
        ins[0] = p.in[in_i + s];
        outs[0] = p.out[out_i + s];
        scan_row(AddOp{}, sm, ins, outs, last, row, len);
      }
      out_i += n;
    } else {
      ins[0] = p.in[in_i];
      outs[0] = p.out[out_i];
      scan_row(DfaOp{p.n_states[g]}, sm, ins, outs, last, row, len);
      out_i += 1;
    }
    in_i += n;
  }
}

}  // namespace

extern "C" {

// Evaluates n_groups independent scan groups in one launch.  Per group:
// kinds[g] (0 affine, 1 add, 2 dfa), n_in[g] input streams (affine: the
// multiplier then the accumulators), emit_last[g], n_states[g] (dfa only).
// ins: the n_ins input pointers in group order; outs: the n_outs output
// pointers in group order ([rows, len] or, for emit_last, [rows, 1]).
// Host arrays; the pointers are copied into the launch's parameter block.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a list the
// kernel does not take.
int tb_fused_scan(int n_groups, const int* kinds, const int* n_in, const int* emit_last,
                  const int* n_states, const int32_t* const* ins, int n_ins,
                  int32_t* const* outs, int n_outs, int rows, int len,
                  cudaStream_t stream) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || n_ins > MAX_STREAMS ||
      n_outs > MAX_STREAMS || rows < 0 || len < 0)
    return (int)cudaErrorInvalidValue;
  FusedParams p = {};
  p.n_groups = n_groups;
  int want_in = 0, want_out = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int kind = kinds[g], n = n_in[g];
    if (kind == KIND_AFFINE) {
      if (n < 2) return (int)cudaErrorInvalidValue;
      want_out += n - 1;
    } else if (kind == KIND_ADD) {
      if (n < 1) return (int)cudaErrorInvalidValue;
      want_out += n;
    } else if (kind == KIND_DFA) {
      if (n != 1 || n_states[g] < 1 || n_states[g] > 8) return (int)cudaErrorInvalidValue;
      want_out += 1;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    want_in += n;
    p.kind[g] = kind;
    p.n_in[g] = n;
    p.emit_last[g] = emit_last[g];
    p.n_states[g] = n_states[g];
  }
  if (want_in != n_ins || want_out != n_outs) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ins; ++i) p.in[i] = ins[i];
  for (int i = 0; i < n_outs; ++i) p.out[i] = outs[i];
  if (rows == 0) return (int)cudaSuccess;
  fused_scan_kernel<<<rows, SCAN_THREADS, 0, stream>>>(p, len);
  return (int)cudaGetLastError();
}

}  // extern "C"
