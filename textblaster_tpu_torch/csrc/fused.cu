// Fused multi-group row scan of int32 [rows, len] streams for Hopper (sm_90a).
//
// Replaces the fused Pallas megakernel of the JAX package
// (textblaster_tpu/ops/pallas_scan.py, `_fused_call` + `_fused_body`),
// reached through `fused_scan`.  One launch evaluates a list of independent
// scan groups over every row:
//
//   * affine (`_affine_op`): the shared-multiplier affine map h -> m*h + a
//     over (m, a1..ak); only the accumulators are written out;
//   * add (`_add_op`): n independent running sums;
//   * dfa (`_dfa_op`): composition of nibble-packed transition maps with
//     1..8 states.
//
// Each group emits its scanned streams (emit "scan", [rows, len]) or only
// its final carry (emit "last", [rows, 1]).
//
// Bound: memory.  The launch moves at least
//   4*rows*len*(sum of inputs + sum of scanned outputs) + 4*rows*(sum of last outputs)
// bytes: 31.5 MB for fineweb_stats' list at [64, 8192], 9.4 us at 3.35 TB/s.
//
// Design.  The groups are independent, so the entry splits them into scan
// units once per call: an affine group into units of the multiplier and up
// to four accumulators (each unit re-reads the multiplier), an add group
// into one unit per stream, a dfa group into one unit.  The grid is
// (rows, units): one CTA per (row, unit), in no order (fineweb_stats' list
// at 64 rows is 320 CTAs on 132 SMs).  A CTA runs scan_ops.cuh's
// register-held row scan (scan_row, shared with scan.cu) for its unit's op,
// picked by one switch: Affine<1..4>, Add<1> or Dfa<1..8>, with no cluster,
// walking ceil(len / (threads * ITEMS)) segments with a carried prefix
// (ITEMS: 4 lanes a thread for affine and add, 16 for dfa).  `threads` is
// ops/scan.py's fused_geometry(len), one number per launch, re-checked
// here.  An emit-"last" unit skips the re-walk and the stores and writes
// only the row's total.  16-byte loads and stores where the unit's streams
// are 16-byte aligned and len % 4 == 0, scalar otherwise; lanes past the
// row's end hold the identity, so any [rows, len] shape is taken (an empty
// row's carry is the identity; a one-lane row is returned as it is, as the
// plain schedule does).  The units travel in a by-value
// __grid_constant__ parameter block, under 1.5 KB.  The widest op,
// Affine<4> (five words on four lanes, prefetched), sets the kernel's one
// register count: 111, no spills, so two CTAs of 256 threads fit an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ops.cuh"

namespace {

using tb::Add;
using tb::Affine;
using tb::Dfa;
using tb::RowPtrs;

constexpr int MAX_GROUPS = 8;
constexpr int MAX_STREAMS = 16;
constexpr int MAX_UNITS = MAX_STREAMS;  // every unit reads a stream of its own
constexpr int MAX_ACCS = 4;             // accumulators in one affine unit
constexpr int MAX_THREADS = 512;

enum Kind { KIND_AFFINE = 0, KIND_ADD = 1, KIND_DFA = 2 };
// A unit's op: Affine<1..4> as 1..4, Add<1> as 5, Dfa<1..8> as 8 + states.
enum OpCode { OP_ADD = 5, OP_DFA = 8 };

struct Unit {
  int op;
  int last;  // emit "last": the row's total to [rows, 1]
  int vec;   // 16-byte accesses
  RowPtrs p;
};

struct FusedParams {
  Unit unit[MAX_UNITS];
};

// Words of the row scan's shared memory for the widest op (Affine<4>, five
// words): the warp totals and the chunk's aggregate, double-buffered.
constexpr int SMEM_WORDS = 2 * 32 * (MAX_ACCS + 1) + 2 * (MAX_ACCS + 1);

template <class Op>
__device__ __forceinline__ void run_unit(const Unit& u, uint32_t* smem, int len) {
  using WarpTot = uint32_t[2][32][Op::N];
  using ChunkTot = uint32_t[2][Op::N];
  const long long chunk = (long long)blockDim.x * Op::ITEMS;
  const RowPtrs p = u.p;
  tb::scan_row<Op>(p, *reinterpret_cast<WarpTot*>(smem),
                   *reinterpret_cast<ChunkTot*>(smem + 2 * 32 * Op::N), blockIdx.x, len, 1,
                   (int)((len + chunk - 1) / chunk), u.vec != 0, u.last != 0);
}

__global__ void __launch_bounds__(MAX_THREADS)
fused_scan_kernel(const __grid_constant__ FusedParams p, int len) {
  __shared__ uint32_t smem[SMEM_WORDS];
  const Unit& u = p.unit[blockIdx.y];
  switch (u.op) {
    case 1: run_unit<Affine<1>>(u, smem, len); break;
    case 2: run_unit<Affine<2>>(u, smem, len); break;
    case 3: run_unit<Affine<3>>(u, smem, len); break;
    case 4: run_unit<Affine<4>>(u, smem, len); break;
    case OP_ADD: run_unit<Add<1>>(u, smem, len); break;
    case OP_DFA + 1: run_unit<Dfa<1>>(u, smem, len); break;
    case OP_DFA + 2: run_unit<Dfa<2>>(u, smem, len); break;
    case OP_DFA + 3: run_unit<Dfa<3>>(u, smem, len); break;
    case OP_DFA + 4: run_unit<Dfa<4>>(u, smem, len); break;
    case OP_DFA + 5: run_unit<Dfa<5>>(u, smem, len); break;
    case OP_DFA + 6: run_unit<Dfa<6>>(u, smem, len); break;
    case OP_DFA + 7: run_unit<Dfa<7>>(u, smem, len); break;
    default: run_unit<Dfa<8>>(u, smem, len); break;
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

// Appends one unit of `n_in` input and `n_out` output pointers.
bool add_unit(FusedParams& p, int& n_units, int op, bool last, int len,
              const int32_t* const* ins, int n_in, int32_t* const* outs, int n_out) {
  if (n_units == MAX_UNITS) return false;
  Unit& u = p.unit[n_units++];
  u.op = op;
  u.last = last;
  // An empty row's streams may be null (an empty tensor has no storage);
  // only a carry is written then.
  bool vec = len % 4 == 0;
  for (int k = 0; k < n_in; ++k) {
    if (ins[k] == nullptr && len > 0) return false;
    u.p.in[k] = ins[k];
    vec = vec && aligned16(ins[k]);
  }
  for (int k = 0; k < n_out; ++k) {
    if (outs[k] == nullptr && (len > 0 || last)) return false;
    u.p.out[k] = outs[k];
    vec = vec && (last || aligned16(outs[k]));
  }
  u.vec = vec;
  return true;
}

}  // namespace

extern "C" {

// Evaluates n_groups independent scan groups in one launch.  groups: per
// group four ints, kind (0 affine, 1 add, 2 dfa), its input count (affine:
// the multiplier then the accumulators), emit_last and n_states (dfa).
// ptrs: the n_ins input pointers in group order, then the n_outs output
// pointers in group order ([rows, len], or [rows, 1] for emit_last).
// threads: ops/scan.py's fused_geometry(len).  Host arrays; the units are
// written into the launch's parameter block.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a list or geometry the kernel does not take.
int tb_fused_scan(const int* groups, int n_groups, void* const* ptrs, int n_ins, int n_outs,
                  int rows, int len, int threads, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n_groups < 1 || n_groups > MAX_GROUPS || n_ins < 1 || n_ins > MAX_STREAMS ||
      n_outs < 1 || n_outs > MAX_STREAMS || rows < 0 || len < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0)
    return bad;
  const int32_t* const* ins = reinterpret_cast<const int32_t* const*>(ptrs);
  int32_t* const* outs = reinterpret_cast<int32_t* const*>(ptrs + n_ins);
  FusedParams p = {};
  int n_units = 0, in_i = 0, out_i = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int kind = groups[4 * g], n = groups[4 * g + 1], ns = groups[4 * g + 3];
    const bool last = groups[4 * g + 2] != 0;
    const int n_out = kind == KIND_AFFINE ? n - 1 : n;
    if (n < 1 || in_i + n > n_ins || out_i + n_out > n_outs) return bad;
    if (kind == KIND_AFFINE) {
      if (n < 2) return bad;
      for (int a = 1; a < n; a += MAX_ACCS) {
        const int k = n - a < MAX_ACCS ? n - a : MAX_ACCS;
        const int32_t* unit_in[MAX_ACCS + 1] = {ins[in_i]};
        for (int j = 0; j < k; ++j) unit_in[1 + j] = ins[in_i + a + j];
        if (!add_unit(p, n_units, k, last, len, unit_in, k + 1, outs + out_i + a - 1, k))
          return bad;
      }
    } else if (kind == KIND_ADD) {
      for (int s = 0; s < n; ++s)
        if (!add_unit(p, n_units, OP_ADD, last, len, ins + in_i + s, 1, outs + out_i + s, 1))
          return bad;
    } else if (kind == KIND_DFA) {
      if (n != 1 || ns < 1 || ns > 8 ||
          !add_unit(p, n_units, OP_DFA + ns, last, len, ins + in_i, 1, outs + out_i, 1))
        return bad;
    } else {
      return bad;
    }
    in_i += n;
    out_i += n_out;
  }
  if (in_i != n_ins || out_i != n_outs) return bad;
  if (rows == 0) return (int)cudaSuccess;
  fused_scan_kernel<<<dim3((unsigned)rows, (unsigned)n_units), threads, 0, stream>>>(p, len);
  return (int)cudaGetLastError();
}

}  // extern "C"
