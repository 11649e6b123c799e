// Scan ops and the register-held row scan shared by scan.cu, fused.cu and
// chain.cu.
//
// Every op composes int32 streams in uint32 arithmetic, which gives the
// int32 wraparound of the JAX package's ops (signed overflow is undefined
// in C++).  No op is assumed commutative: combine(x, y) takes the earlier
// operand on the left.  Each op is one struct of static functions with what
// the row scan needs to load, walk and store a lane; chain.cu calls the same
// structs through its shared-memory chunk scan.
//
// The row scan (scan_row): a row is `cluster` chunks of blockDim.x * ITEMS
// consecutive lanes, one CTA each (a thread block cluster when cluster > 1),
// walked in `segs` segments of `cluster` chunks with the segment totals
// carried from one to the next.  A thread holds ITEMS consecutive lanes in
// registers: a thread walk, a __shfl_up_sync warp scan, the warp totals
// through shared memory and, after the one barrier, a shuffle scan of them
// by every warp (no thread folds alone); in a cluster each CTA publishes its
// chunk's aggregate, and after cluster.sync() every warp reads the cluster's
// aggregates through distributed shared memory and folds them in rank
// order, the earlier chunk on the left; then a re-walk from the thread's
// prefix, stored four lanes at a time (with `last`, no re-walk: the row's
// total is written to [rows, 1]).  Loads and stores are 16-byte vectors
// (uint4) when the caller says every stream is 16-byte aligned and
// len % 4 == 0, scalar otherwise; lanes past the row's end hold the
// identity.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace tb {

// `_affine_op`: the shared-multiplier affine map h -> m*h + a over
// (m, a1..aK), composed earlier-then-later as (mx*my, ay + my*ax); the
// accumulators are the op's outputs.
template <int K>
struct Affine {
  static_assert(1 <= K && K <= 4, "a multiplier and 1..4 accumulators");
  static constexpr int ITEMS = 4;  // lanes a thread holds: one 16-byte access a stream
  static constexpr bool PREFETCH = true;
  static constexpr int N = K + 1;      // words of a state
  static constexpr int N_IN = K + 1;   // streams read
  static constexpr int N_OUT = K;      // streams written (the accumulators)
  static constexpr int FIRST_OUT = 1;  // the first output word of a state
  struct State {
    uint32_t v[N];
  };
  using Elem = State;
  __device__ __forceinline__ static uint32_t raw_identity(int k) { return k == 0 ? 1u : 0u; }
  __device__ __forceinline__ static State identity() {
    State s;
#pragma unroll
    for (int k = 0; k < N; ++k) s.v[k] = raw_identity(k);
    return s;
  }
  __device__ __forceinline__ static State combine(const State& x, const State& y) {
    State r;
    r.v[0] = x.v[0] * y.v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) r.v[k] = y.v[k] + y.v[0] * x.v[k];
    return r;
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

// `_add_op`: M independent running sums.
template <int M>
struct Add {
  static_assert(1 <= M && M <= 5, "1..5 sums");
  static constexpr int ITEMS = 4;
  static constexpr bool PREFETCH = true;
  static constexpr int N = M;
  static constexpr int N_IN = M;
  static constexpr int N_OUT = M;
  static constexpr int FIRST_OUT = 0;
  struct State {
    uint32_t v[M];
  };
  using Elem = State;
  __device__ __forceinline__ static uint32_t raw_identity(int) { return 0u; }
  __device__ __forceinline__ static State identity() {
    State s;
#pragma unroll
    for (int k = 0; k < M; ++k) s.v[k] = 0u;
    return s;
  }
  __device__ __forceinline__ static State combine(const State& x, const State& y) {
    State s;
#pragma unroll
    for (int k = 0; k < M; ++k) s.v[k] = x.v[k] + y.v[k];
    return s;
  }
  __device__ __forceinline__ static Elem elem(const uint32_t (&raw)[N_IN]) {
    State s;
#pragma unroll
    for (int k = 0; k < M; ++k) s.v[k] = raw[k];
    return s;
  }
  __device__ __forceinline__ static State step(const State& run, const Elem& e) {
    return combine(run, e);
  }
  __device__ __forceinline__ static uint32_t out(const State& s, int k) { return s.v[k]; }
  __device__ __forceinline__ static int in_of_out(int k) { return k; }
};

// `_dfa_op` with NS states; a state is the nibble-packed map, an element
// its map expanded once to eight bytes (b_lo, b_hi; byte q = the nibble at
// state q).  (b . a) is __byte_perm(b_lo, b_hi, a) for states 0..3 (the
// selector's nibbles are a's states, each below 8, so bit 3, the
// sign-replicate mode, stays clear) and __byte_perm(b_lo, b_hi, a >> 16) for
// states 4..7, repacked to nibbles and masked to NS.  The earlier operand
// is always a combined state or the identity, never a raw map, so its
// nibbles at or above NS are clear.
template <int NS>
struct Dfa {
  static_assert(1 <= NS && NS <= 8, "1..8 states");
  static constexpr int ITEMS = 16;
  static constexpr bool PREFETCH = false;  // 32 more registers a thread; slower
  static constexpr int N = 1;
  static constexpr int N_IN = 1;
  static constexpr int N_OUT = 1;
  static constexpr int FIRST_OUT = 0;
  static constexpr uint32_t MASK = NS == 8 ? 0xffffffffu : (1u << (4 * NS)) - 1u;
  struct State {
    uint32_t v[1];
  };
  struct Elem {
    uint32_t lo, hi;  // bytes 0..3 and 4..7
  };
  __device__ __forceinline__ static uint32_t raw_identity(int) {
    uint32_t id = 0u;
#pragma unroll
    for (int q = 0; q < NS; ++q) id |= (uint32_t)q << (4 * q);
    return id;
  }
  __device__ __forceinline__ static State identity() { return State{{raw_identity(0)}}; }
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

template <class Op>
__device__ __forceinline__ typename Op::State shfl_up(const typename Op::State& s, int off) {
  typename Op::State r;
#pragma unroll
  for (int k = 0; k < Op::N; ++k) r.v[k] = __shfl_up_sync(0xffffffffu, s.v[k], off);
  return r;
}

template <class Op>
__device__ __forceinline__ typename Op::State shfl_idx(const typename Op::State& s, int src) {
  typename Op::State r;
#pragma unroll
  for (int k = 0; k < Op::N; ++k) r.v[k] = __shfl_sync(0xffffffffu, s.v[k], src);
  return r;
}

// --- the register-held row scan ------------------------------------------------

// A row scan's streams: the op's N_IN inputs and N_OUT outputs, each
// [rows, len] (or, with `last`, each output [rows, 1]).
struct RowPtrs {
  const int32_t* in[5];
  int32_t* out[4];
};

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
__device__ __forceinline__ void load(const RowPtrs& p, size_t off, long long g0, int len,
                                     bool vec, typename Op::Elem (&e)[IT]) {
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
__device__ __forceinline__ void rewalk_store(const RowPtrs& p, size_t off, long long g0, int len,
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

// The inclusive scan of row `row` (its lanes at row * len) by this CTA,
// chunk block_rank() of a cluster of `cluster` CTAs (1: no cluster), the
// row walked in `segs` segments of `cluster` chunks of blockDim.x * ITEMS
// lanes.  With `last` only the row's total is written, to out[k][row]; an
// empty row (len == 0, segs == 0) gives the identity (its streams may be
// null: nothing is read or written at them).  A one-lane row is
// returned as it is: the plain schedule applies no op to it.  warp_tot and
// chunk_tot are the CTA's shared memory for the warp totals and the
// chunk's aggregate, double-buffered by segment parity (two arrays: one
// struct of both cost the affine scan three registers and 2% at 8192
// lanes on the card).
template <class Op>
__device__ __forceinline__ void scan_row(const RowPtrs& p, uint32_t (&warp_tot)[2][32][Op::N],
                                         uint32_t (&chunk_tot)[2][Op::N], size_t row, int len,
                                         int cluster, int segs, bool vec, bool last) {
  using State = typename Op::State;
  using Elem = typename Op::Elem;
  constexpr int IT = Op::ITEMS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = blockDim.x >> 5;
  const int rank = cluster > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const size_t off = row * (size_t)len;
  if (len == 1) {
    if (t == 0 && rank == 0) {
#pragma unroll
      for (int k = 0; k < Op::N_OUT; ++k) p.out[k][row] = p.in[Op::in_of_out(k)][off];
    }
    return;
  }
  const long long chunk = (long long)blockDim.x * IT;
  const long long seg_lanes = chunk * cluster;
  const long long first = rank * chunk + (long long)t * IT;  // in segment 0
  Elem next[IT];
  if (Op::PREFETCH) load<Op, IT>(p, off, first, len, vec, next);
  State carry = Op::identity();  // the segments before this one
  for (int s = 0; s < segs; ++s) {
    const int par = s & 1;
    const long long g0 = s * seg_lanes + first;
    Elem e[IT];
    if (Op::PREFETCH) {
#pragma unroll
      for (int j = 0; j < IT; ++j) e[j] = next[j];
      // The next segment's loads fly during this segment's barriers.
      if (s + 1 < segs) load<Op, IT>(p, off, g0 + seg_lanes, len, vec, next);
    } else {
      load<Op, IT>(p, off, g0, len, vec, e);
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
      cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
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
    if (!last) {
      const State pre =
          Op::combine(Op::combine(Op::combine(carry, chunk_pref), warp_pref), excl);
      rewalk_store<Op, IT>(p, off, g0, len, vec, pre, e);
    }
    carry = Op::combine(carry, seg_total);
  }
  if (last && t == 0 && rank == 0) {
#pragma unroll
    for (int k = 0; k < Op::N_OUT; ++k) p.out[k][row] = (int32_t)Op::out(carry, k);
  }
  // No CTA leaves while a peer may still read its chunk aggregates.
  if (cluster > 1) cooperative_groups::this_cluster().sync();
}

}  // namespace tb
