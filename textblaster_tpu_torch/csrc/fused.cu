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
// its final carry (emit "last", [rows, 1]).  All arithmetic is uint32, which
// gives the int32 wraparound the JAX ops rely on (signed overflow is
// undefined in C++).  No op here is assumed commutative: every combine keeps
// the earlier operand on the left.
//
// Design: scan.cu's skeleton.  One CTA per row; for each group in order,
// the CTA walks the row in tiles of SCAN_TILE elements with a carried
// prefix.  A tile is staged through shared memory with coalesced loads,
// each thread composes SCAN_ITEMS consecutive elements, a __shfl_up_sync
// warp scan combines the thread aggregates and the warp totals are combined
// through shared memory.  An emit-"last" unit skips the re-walk and the
// stores and writes only its carry.  The ragged edge holds the op's
// identity, so any [rows, len] shape is taken.  The group list travels as
// a by-value kernel parameter block (no pointer table copied per call).
//
// Bound: memory.  The launch moves at least
//   4*rows*len*(sum of inputs + sum of scanned outputs) + 4*rows*(sum of last outputs)
// bytes.  Known weakness: as in scan.cu, 64 rows are 64 CTAs on 132 SMs,
// and the groups of a row run one after another; splitting rows across
// CTAs and staging tiles with cp.async is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
// One padding word every 32 keeps the per-thread consecutive reads (stride
// SCAN_ITEMS) free of bank conflicts.
constexpr int SCAN_SMEM = SCAN_TILE + SCAN_TILE / 32;

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

struct Smem {
  uint32_t tile[MAX_UNIT][SCAN_SMEM];
  uint32_t warp_tot[SCAN_WARPS][MAX_UNIT];
  uint32_t warp_pref[SCAN_WARPS][MAX_UNIT];
  uint32_t carry[MAX_UNIT];
};

__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// --- ops ----------------------------------------------------------------

template <int K>
struct AffineOp {
  static constexpr int N = K + 1;  // multiplier + K accumulators
  static constexpr int FIRST_OUT = 1;
  struct State {
    uint32_t v[N];
  };
  __device__ __forceinline__ State identity() const {
    State s;
    s.v[0] = 1u;
#pragma unroll
    for (int k = 1; k < N; ++k) s.v[k] = 0u;
    return s;
  }
  // x earlier, y later.
  __device__ __forceinline__ State combine(const State& x, const State& y) const {
    State r;
    r.v[0] = x.v[0] * y.v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) r.v[k] = y.v[k] + y.v[0] * x.v[k];
    return r;
  }
};

struct AddOp {
  static constexpr int N = 1;
  static constexpr int FIRST_OUT = 0;
  struct State {
    uint32_t v[1];
  };
  __device__ __forceinline__ State identity() const { return State{{0u}}; }
  __device__ __forceinline__ State combine(const State& x, const State& y) const {
    return State{{x.v[0] + y.v[0]}};
  }
};

struct DfaOp {
  static constexpr int N = 1;
  static constexpr int FIRST_OUT = 0;
  struct State {
    uint32_t v[1];
  };
  int n_states;
  __device__ __forceinline__ State identity() const {
    uint32_t id = 0u;
    for (int q = 0; q < n_states; ++q) id |= (uint32_t)q << (4 * q);
    return State{{id}};
  }
  // (b . a)(q) = b[a[q]]: route each of a's nibbles through b.  Valid
  // packed maps hold states < n_states <= 8; the & 7 keeps the shift
  // defined for any input.
  __device__ __forceinline__ State combine(const State& x, const State& y) const {
    const uint32_t a = x.v[0], b = y.v[0];
    uint32_t out = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < n_states) {
        const uint32_t nib = (a >> (4 * q)) & 15u;
        out |= ((b >> ((nib & 7u) << 2)) & 15u) << (4 * q);
      }
    }
    return State{{out}};
  }
};

template <class Op>
__device__ __forceinline__ typename Op::State shfl_up(const typename Op::State& s,
                                                      int off) {
  typename Op::State r;
#pragma unroll
  for (int k = 0; k < Op::N; ++k) r.v[k] = __shfl_up_sync(0xffffffffu, s.v[k], off);
  return r;
}

template <class Op>
__device__ __forceinline__ typename Op::State load_state(uint32_t (*src)[MAX_UNIT],
                                                         int i) {
  typename Op::State s;
#pragma unroll
  for (int k = 0; k < Op::N; ++k) s.v[k] = src[i][k];
  return s;
}

// --- one scan unit over one row -------------------------------------------

// ins[k]: the Op::N input streams of the unit; outs[k - FIRST_OUT]: the
// streams written back (inputs FIRST_OUT..N-1), [rows, len] when !last,
// [rows, 1] when last.
template <class Op>
__device__ void scan_unit(const Op& op, Smem& sm, const int32_t* (&ins)[MAX_UNIT],
                          int32_t* (&outs)[MAX_UNIT], bool last, size_t row,
                          int len) {
  using State = typename Op::State;
  constexpr int N = Op::N;
  constexpr int FIRST_OUT = Op::FIRST_OUT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_off = row * (size_t)len;
  const State ident = op.identity();

  __syncthreads();  // the previous unit is done with shared memory
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) sm.carry[k] = ident.v[k];
  }

  for (int base = 0; base < len; base += SCAN_TILE) {
    // Coalesced staging; the ragged edge holds the identity.
#pragma unroll
    for (int k = 0; k < N; ++k) {
      for (int i = tid; i < SCAN_TILE; i += SCAN_THREADS) {
        const int g = base + i;
        sm.tile[k][skew(i)] = g < len ? (uint32_t)ins[k][row_off + g] : ident.v[k];
      }
    }
    __syncthreads();

    // Thread-local sequential composition of SCAN_ITEMS consecutive items.
    const int first = tid * SCAN_ITEMS;
    State agg;
#pragma unroll
    for (int k = 0; k < N; ++k) agg.v[k] = sm.tile[k][skew(first)];
#pragma unroll
    for (int j = 1; j < SCAN_ITEMS; ++j) {
      State x;
#pragma unroll
      for (int k = 0; k < N; ++k) x.v[k] = sm.tile[k][skew(first + j)];
      agg = op.combine(agg, x);
    }

    // Inclusive warp scan of the thread aggregates (earlier on the left).
    State inc = agg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const State other = shfl_up<Op>(inc, off);
      if (lane >= off) inc = op.combine(other, inc);
    }
    State excl = shfl_up<Op>(inc, 1);
    if (lane == 0) excl = ident;
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < N; ++k) sm.warp_tot[warp][k] = inc.v[k];
    }
    __syncthreads();

    if (tid == 0) {
      State run;
#pragma unroll
      for (int k = 0; k < N; ++k) run.v[k] = sm.carry[k];
      for (int w = 0; w < SCAN_WARPS; ++w) {
#pragma unroll
        for (int k = 0; k < N; ++k) sm.warp_pref[w][k] = run.v[k];
        run = op.combine(run, load_state<Op>(sm.warp_tot, w));
      }
#pragma unroll
      for (int k = 0; k < N; ++k) sm.carry[k] = run.v[k];
    }
    __syncthreads();

    if (!last) {
      // Re-walk this thread's items from its exclusive prefix.
      State run = op.combine(load_state<Op>(sm.warp_pref, warp), excl);
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) {
        State x;
#pragma unroll
        for (int k = 0; k < N; ++k) x.v[k] = sm.tile[k][skew(first + j)];
        run = op.combine(run, x);
#pragma unroll
        for (int k = FIRST_OUT; k < N; ++k) sm.tile[k][skew(first + j)] = run.v[k];
      }
      __syncthreads();

#pragma unroll
      for (int k = FIRST_OUT; k < N; ++k) {
        for (int i = tid; i < SCAN_TILE; i += SCAN_THREADS) {
          const int g = base + i;
          if (g < len) outs[k - FIRST_OUT][row_off + g] = (int32_t)sm.tile[k][skew(i)];
        }
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

  if (last && tid == 0) {
#pragma unroll
    for (int k = FIRST_OUT; k < N; ++k) outs[k - FIRST_OUT][row] = (int32_t)sm.carry[k];
  }
}

template <int K>
__device__ void affine_unit(Smem& sm, const int32_t* (&ins)[MAX_UNIT],
                            int32_t* (&outs)[MAX_UNIT], bool last, size_t row,
                            int len) {
  scan_unit(AffineOp<K>{}, sm, ins, outs, last, row, len);
}

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
          case 1: affine_unit<1>(sm, ins, outs, last, row, len); break;
          case 2: affine_unit<2>(sm, ins, outs, last, row, len); break;
          case 3: affine_unit<3>(sm, ins, outs, last, row, len); break;
          default: affine_unit<4>(sm, ins, outs, last, row, len); break;
        }
      }
      out_i += n - 1;
    } else if (p.kind[g] == KIND_ADD) {
      for (int s = 0; s < n; ++s) {
        ins[0] = p.in[in_i + s];
        outs[0] = p.out[out_i + s];
        scan_unit(AddOp{}, sm, ins, outs, last, row, len);
      }
      out_i += n;
    } else {
      ins[0] = p.in[in_i];
      outs[0] = p.out[out_i];
      scan_unit(DfaOp{p.n_states[g]}, sm, ins, outs, last, row, len);
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
