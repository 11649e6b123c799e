// Scan ops shared by scan.cu, fused.cu and chain.cu, and the tile constants
// and tile scan of fused.cu (scan.cu has its own register-held row scan).
//
// Every op composes int32 streams in uint32 arithmetic, which gives the
// int32 wraparound of the JAX package's ops (signed overflow is undefined
// in C++).  No op is assumed commutative: combine(x, y) takes the earlier
// operand on the left.
//
// The tile scan: one CTA walks a row in tiles of SCAN_TILE elements with a
// carried prefix.  A tile is staged in shared memory, each thread composes
// SCAN_ITEMS consecutive elements, a __shfl_up_sync warp scan combines the
// thread aggregates, the warp totals are combined through shared memory,
// and each thread re-walks its items from its exclusive prefix.

#pragma once

#include <stdint.h>

namespace tb {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
// One padding word every 32 keeps the per-thread consecutive reads (stride
// SCAN_ITEMS) free of bank conflicts.
constexpr int SCAN_SMEM = SCAN_TILE + SCAN_TILE / 32;

__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// `_affine_op`: the shared-multiplier affine map h -> m*h + a over
// (m, a1..aK), composed earlier-then-later as (mx*my, ay + my*ax).
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
  __device__ __forceinline__ State combine(const State& x, const State& y) const {
    State r;
    r.v[0] = x.v[0] * y.v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) r.v[k] = y.v[k] + y.v[0] * x.v[k];
    return r;
  }
};

// `_add_op`: one running sum.
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

// `_dfa_op`: composition of nibble-packed transition maps with
// n_states <= 8, (b . a)(q) = b[a[q]], using logical shifts.
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
  // Valid packed maps hold states < n_states <= 8; the & 7 keeps the shift
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

// The ops of scan.cu's register-held row scan, in static form with what the
// row scan needs to load, walk and store a lane: Affine<K> (AffineOp<K>'s
// combine) and Dfa<NS> (`_dfa_op` in byte form, templated on the state
// count).  DfaOp and Dfa<NS> are one op in two forms until fused_scan's
// redesign moves fused.cu and chain.cu to Dfa<NS> and drops DfaOp.
template <int K>
struct Affine {
  static constexpr int ITEMS = 4;  // lanes a thread holds
  static constexpr bool PREFETCH = true;
  static constexpr int N = K + 1;      // words of a state
  static constexpr int N_IN = K + 1;   // streams read
  static constexpr int N_OUT = K;      // streams written (the accumulators)
  using State = typename AffineOp<K>::State;
  using Elem = State;
  __device__ __forceinline__ static State identity() { return AffineOp<K>().identity(); }
  __device__ __forceinline__ static uint32_t raw_identity(int k) { return k == 0 ? 1u : 0u; }
  __device__ __forceinline__ static State combine(const State& x, const State& y) {
    return AffineOp<K>().combine(x, y);
  }
  __device__ __forceinline__ static Elem elem(const uint32_t (&raw)[N_IN]) {
    State s;
#pragma unroll
    for (int k = 0; k < N; ++k) s.v[k] = raw[k];
    return s;
  }
  __device__ __forceinline__ static State step(const State& run, const Elem& e) {
    return combine(run, e);
  }
  __device__ __forceinline__ static uint32_t out(const State& s, int k) { return s.v[k + 1]; }
  __device__ __forceinline__ static int in_of_out(int k) { return k + 1; }
};

// `_dfa_op` with NS states; a state is the nibble-packed map, an element
// its map expanded once to eight bytes (b_lo, b_hi; byte q = the nibble at
// state q).  (b . a) is __byte_perm(b_lo, b_hi, a) for states 0..3 (the
// selector's nibbles are a's states, each below 8, so bit 3, the
// sign-replicate mode, stays clear) and __byte_perm(b_lo, b_hi, a >> 16) for
// states 4..7, repacked to nibbles and masked to NS.
template <int NS>
struct Dfa {
  static constexpr int ITEMS = 16;
  static constexpr bool PREFETCH = false;  // 32 more registers a thread; slower
  static constexpr int N = 1;
  static constexpr int N_IN = 1;
  static constexpr int N_OUT = 1;
  static constexpr uint32_t MASK = NS == 8 ? 0xffffffffu : (1u << (4 * NS)) - 1u;
  struct State {
    uint32_t v[1];
  };
  struct Elem {
    uint32_t lo, hi;  // bytes 0..3 and 4..7
  };
  __device__ __forceinline__ static uint32_t ident_map() {
    uint32_t id = 0u;
#pragma unroll
    for (int q = 0; q < NS; ++q) id |= (uint32_t)q << (4 * q);
    return id;
  }
  __device__ __forceinline__ static State identity() { return State{{ident_map()}}; }
  __device__ __forceinline__ static uint32_t raw_identity(int) { return ident_map(); }
  // Nibbles 0..3 (or 4..7) of f as bytes: duplicate the two bytes that hold
  // them, then keep the low nibble of bytes 0, 2 and the high one of 1, 3.
  __device__ __forceinline__ static uint32_t spread(uint32_t f, uint32_t sel) {
    const uint32_t d = __byte_perm(f, 0u, sel);
    return (d & 0x000F000Fu) | ((d >> 4) & 0x0F000F00u);
  }
  __device__ __forceinline__ static Elem table(uint32_t f) {
    return Elem{spread(f, 0x1100u), spread(f, 0x3322u)};
  }
  // (e . s): nibble q = e[s[q]] for q < NS, the other nibbles 0.  The
  // selected bytes are below 16, so r | (r >> 4) holds two nibbles in each
  // of bytes 0 and 2.
  __device__ __forceinline__ static State apply(const State& s, const Elem& e) {
    const uint32_t r = __byte_perm(e.lo, e.hi, s.v[0]);
    const uint32_t t = r | (r >> 4);
    uint32_t out;
    if (NS > 4) {
      const uint32_t r2 = __byte_perm(e.lo, e.hi, s.v[0] >> 16);
      out = __byte_perm(t, r2 | (r2 >> 4), 0x6420u);
    } else {
      out = __byte_perm(t, 0u, 0x4420u);
    }
    return State{{out & MASK}};
  }
  __device__ __forceinline__ static State combine(const State& x, const State& y) {
    return apply(x, table(y.v[0]));
  }
  __device__ __forceinline__ static Elem elem(const uint32_t (&raw)[1]) { return table(raw[0]); }
  __device__ __forceinline__ static State step(const State& run, const Elem& e) {
    return apply(run, e);
  }
  __device__ __forceinline__ static uint32_t out(const State& s, int) { return s.v[0]; }
  __device__ __forceinline__ static int in_of_out(int) { return 0; }
};

// Shared memory of a tile scan over up to M streams.
template <int M>
struct TileSmem {
  uint32_t tile[M][SCAN_SMEM];
  uint32_t warp_tot[SCAN_WARPS][M];
  uint32_t warp_pref[SCAN_WARPS][M];
  uint32_t carry[M];
};

// Scans streams k0 .. k0+N-1 of the staged tile in place from the carried
// prefix sm.carry[k0..] and advances the carry.  With `last` only the carry
// advances (no re-walk).  The staging must be complete (__syncthreads())
// before the call.  The scanned tile is settled when it returns; with
// `last` no thread touches the tile after the carry's barrier, so the
// caller's next barrier is the only one it needs before restaging.
template <class Op, int M>
__device__ void scan_tile(const Op& op, TileSmem<M>& sm, int k0, bool last) {
  using State = typename Op::State;
  constexpr int N = Op::N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = tid * SCAN_ITEMS;

  // Thread-local sequential composition of SCAN_ITEMS consecutive items.
  State agg;
#pragma unroll
  for (int k = 0; k < N; ++k) agg.v[k] = sm.tile[k0 + k][skew(first)];
#pragma unroll
  for (int j = 1; j < SCAN_ITEMS; ++j) {
    State x;
#pragma unroll
    for (int k = 0; k < N; ++k) x.v[k] = sm.tile[k0 + k][skew(first + j)];
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
  if (lane == 0) excl = op.identity();
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < N; ++k) sm.warp_tot[warp][k0 + k] = inc.v[k];
  }
  __syncthreads();

  if (tid == 0) {
    State run;
#pragma unroll
    for (int k = 0; k < N; ++k) run.v[k] = sm.carry[k0 + k];
    for (int w = 0; w < SCAN_WARPS; ++w) {
      State tot;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        sm.warp_pref[w][k0 + k] = run.v[k];
        tot.v[k] = sm.warp_tot[w][k0 + k];
      }
      run = op.combine(run, tot);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) sm.carry[k0 + k] = run.v[k];
  }
  __syncthreads();

  if (!last) {
    // Re-walk this thread's items from its exclusive prefix.
    State run;
#pragma unroll
    for (int k = 0; k < N; ++k) run.v[k] = sm.warp_pref[warp][k0 + k];
    run = op.combine(run, excl);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      State x;
#pragma unroll
      for (int k = 0; k < N; ++k) x.v[k] = sm.tile[k0 + k][skew(first + j)];
      run = op.combine(run, x);
#pragma unroll
      for (int k = Op::FIRST_OUT; k < N; ++k) sm.tile[k0 + k][skew(first + j)] = run.v[k];
    }
    __syncthreads();
  }
}

// One row's inclusive scan of the Op::N streams ins[k] (each [rows, len]).
// Streams FIRST_OUT..N-1 are written to outs[k - FIRST_OUT]: [rows, len]
// scans, or with `last` only the row's final carry ([rows, 1]).  Loads are
// coalesced; the ragged edge holds the identity, so any len is taken.
template <class Op, int M>
__device__ void scan_row(const Op& op, TileSmem<M>& sm, const int32_t* (&ins)[M],
                         int32_t* (&outs)[M], bool last, size_t row, int len) {
  using State = typename Op::State;
  constexpr int N = Op::N;
  constexpr int FIRST_OUT = Op::FIRST_OUT;
  static_assert(N <= M, "the tile holds every stream of the op");
  const int tid = threadIdx.x;
  const size_t row_off = row * (size_t)len;
  const State ident = op.identity();

  __syncthreads();  // the previous scan is done with shared memory
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) sm.carry[k] = ident.v[k];
  }

  for (int base = 0; base < len; base += SCAN_TILE) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      for (int i = tid; i < SCAN_TILE; i += SCAN_THREADS) {
        const int g = base + i;
        sm.tile[k][skew(i)] = g < len ? (uint32_t)ins[k][row_off + g] : ident.v[k];
      }
    }
    __syncthreads();
    scan_tile(op, sm, 0, last);
    if (!last) {
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

}  // namespace tb
