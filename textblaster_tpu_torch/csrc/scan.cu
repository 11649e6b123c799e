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
// Neither op is commutative: every combine below keeps the earlier operand
// on the left.
//
// Design: one CTA per row walks the row in tiles of SCAN_TILE elements with
// a carried prefix.  A tile is staged through shared memory with coalesced
// loads; each thread composes SCAN_ITEMS consecutive elements sequentially,
// a warp scan with __shfl_up_sync combines the thread aggregates, and the
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

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
// Shared-memory skew: one padding word every 32 keeps the per-thread
// consecutive reads (stride SCAN_ITEMS) free of bank conflicts.
constexpr int SCAN_SMEM = SCAN_TILE + SCAN_TILE / 32;

__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// --- ops ----------------------------------------------------------------

template <int K>
struct AffineOp {
  static constexpr int N = K + 1;  // multiplier + K accumulators
  struct State {
    uint32_t v[N];
  };
  int n_states;  // unused
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

struct DfaOp {
  static constexpr int N = 1;
  struct State {
    uint32_t v[1];
  };
  int n_states;
  __device__ __forceinline__ State identity() const {
    State s;
    uint32_t id = 0u;
    for (int q = 0; q < n_states; ++q) id |= (uint32_t)q << (4 * q);
    s.v[0] = id;
    return s;
  }
  // (b . a)(q) = b[a[q]]: route each of a's nibbles through b.  Valid
  // packed maps hold states < n_states <= 8, so a nibble is < 8; the & 7
  // keeps the shift defined for any input.
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
    State r;
    r.v[0] = out;
    return r;
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

// --- kernel ---------------------------------------------------------------

// ins[k]: the Op::N input streams; outs: the streams written back, which are
// inputs FIRST_OUT..N-1 (the affine multiplier is internal, the DFA map is
// its own output).
template <class Op, int FIRST_OUT>
__global__ void __launch_bounds__(SCAN_THREADS)
row_scan_kernel(const int32_t* __restrict__ in0, const int32_t* __restrict__ in1,
                const int32_t* __restrict__ in2, int32_t* __restrict__ out0,
                int32_t* __restrict__ out1, int len, Op op) {
  using State = typename Op::State;
  constexpr int N = Op::N;
  __shared__ uint32_t sm[N][SCAN_SMEM];
  __shared__ State warp_tot[SCAN_WARPS];
  __shared__ State warp_pref[SCAN_WARPS];
  __shared__ State carry;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_off = (size_t)blockIdx.x * (size_t)len;
  const int32_t* ins[3] = {in0, in1, in2};
  int32_t* outs[2] = {out0, out1};
  const State ident = op.identity();
  if (tid == 0) carry = ident;

  for (int base = 0; base < len; base += SCAN_TILE) {
    // Coalesced staging; the ragged edge holds the identity.
#pragma unroll
    for (int k = 0; k < N; ++k) {
      for (int i = tid; i < SCAN_TILE; i += SCAN_THREADS) {
        const int g = base + i;
        sm[k][skew(i)] = g < len ? (uint32_t)ins[k][row_off + g] : ident.v[k];
      }
    }
    __syncthreads();

    // Thread-local sequential composition of SCAN_ITEMS consecutive items.
    const int first = tid * SCAN_ITEMS;
    State agg;
#pragma unroll
    for (int k = 0; k < N; ++k) agg.v[k] = sm[k][skew(first)];
#pragma unroll
    for (int j = 1; j < SCAN_ITEMS; ++j) {
      State x;
#pragma unroll
      for (int k = 0; k < N; ++k) x.v[k] = sm[k][skew(first + j)];
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
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();

    if (tid == 0) {
      State run = carry;
      for (int w = 0; w < SCAN_WARPS; ++w) {
        warp_pref[w] = run;
        run = op.combine(run, warp_tot[w]);
      }
      carry = run;
    }
    __syncthreads();

    // Re-walk this thread's items from its exclusive prefix.
    State run = op.combine(warp_pref[warp], excl);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      State x;
#pragma unroll
      for (int k = 0; k < N; ++k) x.v[k] = sm[k][skew(first + j)];
      run = op.combine(run, x);
#pragma unroll
      for (int k = FIRST_OUT; k < N; ++k) sm[k][skew(first + j)] = run.v[k];
    }
    __syncthreads();

#pragma unroll
    for (int k = FIRST_OUT; k < N; ++k) {
      for (int i = tid; i < SCAN_TILE; i += SCAN_THREADS) {
        const int g = base + i;
        if (g < len) outs[k - FIRST_OUT][row_off + g] = (int32_t)sm[k][skew(i)];
      }
    }
    __syncthreads();
  }
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
    AffineOp<1> op{0};
    row_scan_kernel<AffineOp<1>, 1>
        <<<rows, SCAN_THREADS, 0, stream>>>(m, a1, nullptr, o1, nullptr, len, op);
  } else if (k == 2) {
    AffineOp<2> op{0};
    row_scan_kernel<AffineOp<2>, 1>
        <<<rows, SCAN_THREADS, 0, stream>>>(m, a1, a2, o1, o2, len, op);
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
  DfaOp op{n_states};
  row_scan_kernel<DfaOp, 0>
      <<<rows, SCAN_THREADS, 0, stream>>>(fns, nullptr, nullptr, out, nullptr, len, op);
  return (int)cudaGetLastError();
}

}  // extern "C"
