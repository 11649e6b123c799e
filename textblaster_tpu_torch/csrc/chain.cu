// Dependency-chained multi-pass row scan of int32 [rows, len] streams for
// Hopper (sm_90a).
//
// Replaces the chain Pallas megakernel of the JAX package
// (textblaster_tpu/ops/pallas_scan.py, `_chain_call` + `_chain_body` +
// `_chain_plan`), reached through `chain_scan`.  One launch evaluates an
// ordered list of passes over every row.  A pass holds groups; a group reads
// dependencies -- external [rows, len] operands, or taps of the streams an
// earlier pass emitted (shift 0, or shift 1: the previous walk position,
// `fill` at walk position 0) -- maps them elementwise to the op's operands
// with a prep (below), and scans them:
//
//   * affine (`_affine_op`, m + 1..4 accumulators; the accumulators are
//     emitted), add (`_add_op`, independent sums), dfa (`_dfa_op`, <= 8
//     states): scan_ops.cuh's Affine<K>, Add<M> and Dfa<NS> (a group's
//     n_states picks the instantiation; the DFA combine is __byte_perm
//     lookups);
//   * segmax (`_segmax_op`): a segmented running max over (value, reset),
//     a SIGNED max restarted where the later element resets, identity
//     (INT32_MIN, 0); the value stream is emitted;
//   * copy: no scan; the operands are emitted as they are.
//
// A group emits its streams in full (emit "scan", [rows, len]; emit "none",
// tap-only) or only its final carry (emit "last", [rows, 1]).  A reverse
// pass walks the row back to front and writes its streams in natural lane
// order, which is the staged rev(scan(rev(x))).
//
// Preps.  The JAX preps are jnp closures traced into the kernel.  Here each
// is a struct below with an id, its dependency and operand counts and a
// __device__ apply(); the plan names it by id, and ops/scan.py (PREPS) and
// ops/stats.py hold the same table and the plain versions.  Preps compute
// in signed int32 (signed compares, arithmetic >>); scans compute in uint32.
//
// What bounds it on this card.  The external operands are read once and the
// emit "scan" streams and "last" carries written once: at the main path's
// sizes (64 rows of 512..16384 lanes, 2..12 operands) that is 0.2..15 us of
// HBM time, so a launch is bound by latency -- barriers and the dependent
// walk of each group -- unless it keeps the SMs busy and its tapped streams
// on chip.
//
// Design.  A row is cut into `cluster` chunks of `chunk` lanes, one CTA
// each (the geometry of ops/scan.py's chain_geometry, which the launch
// re-checks):
//   * rows of <= 2048 lanes: one CTA of up to 1024 threads per row, two
//     lanes a thread.  64 such rows leave half the SMs idle, so a row's
//     time is its latency, and the more warps share its lanes (each lane a
//     round trip to memory per group) the shorter it is: one warp per row,
//     several rows per CTA, was slower on this card at every width;
//   * wider rows: a thread block cluster of up to 8 CTAs per row, each CTA
//     owning one contiguous chunk of lanes for every pass, 8 lanes a thread
//     (64 rows of 8192 lanes are 512 CTAs, which fill the card).
// For each group, every thread stages the operands of its strided lanes
// (coalesced loads, the prep applied in registers) into shared memory,
// composes `items` consecutive staged lanes, a __shfl_up_sync warp scan
// combines the thread aggregates and the warp totals are combined through
// shared memory.  In a cluster each CTA publishes its chunk's aggregate in
// shared memory; after a cluster barrier warp 0 scans the chunk aggregates
// read through distributed shared memory (left to right in a forward pass,
// right to left in a reverse one) into the chunk's carry, and every thread
// re-walks its lanes from its prefix.  A chunk is walked once, whatever its
// width: no 2048-lane tiles padded with the identity.
//
// Streams that a later pass taps stay in the shared memory of the CTA that
// owns their lanes for the whole program ("keep" rows); a shift tap at a
// chunk edge reads the neighbour CTA's copy through distributed shared
// memory, after the cluster barrier that ends the producing pass.  Only
// emit "scan" streams and "last" carries go to global memory, each written
// once.  The largest main-path program, `structure` with hashes (5 passes,
// 7 groups, 6 tapped streams, 3 operands), takes 9 x 4 bytes of shared
// memory per lane: 76 KiB per CTA at a 2048-lane chunk.  A program whose
// tapped streams do not fit the 227 KiB a CTA may have at its chunk (more
// than about 20 tapped streams at 16384 lanes; no site's program comes
// near) runs with global taps instead: its tapped streams go to the
// outputs and a workspace, and taps read them back through L2 (`__ldcg`).
//
// Encoding.  tb_chain_encode parses and validates a program once and keeps
// it under a handle; tb_chain_launch fills in the pointers and launches.
// The program travels as a by-value kernel parameter block,
// __grid_constant__ (no copy per thread): ChainParams is under 3 KB, within
// the 4 KB that kernel parameters had before CUDA 12.1.  It covers every
// site with room: the largest has 5 passes, 7 groups, 40 deps, 10 external
// operands and 10 streams (12 external operands at most, in
// gopher_quality, gopher_rep and C4's sentence mode).  The kernel allocates
// nothing: the wrapper allocates the outputs and any workspace.
//
// Known weakness: the groups of a pass still run one after another, with
// two to four barriers each (a cluster barrier per scanned group in a
// cluster); programs of many small groups are bound by that latency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <memory>
#include <mutex>
#include <vector>

#include "scan_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tb;

constexpr int MAX_PASSES = 8;
constexpr int MAX_GROUPS = 16;
constexpr int MAX_DEPS = 64;
constexpr int MAX_EXT = 16;
constexpr int MAX_SLOTS = 32;
constexpr int MAX_OPS = 5;
constexpr int MAX_THREADS = 1024;    // threads of a CTA (one row's chunk)
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a CTA may have

enum Kind { KIND_AFFINE = 0, KIND_ADD = 1, KIND_DFA = 2, KIND_SEGMAX = 3, KIND_COPY = 4 };
enum Emit { EMIT_SCAN = 0, EMIT_LAST = 1, EMIT_NONE = 2 };

struct Dep {
  int tap;    // 0: external operand `src`; 1: stream slot `src`
  int src;
  int shift;  // 1: the previous walk position, `fill` at walk position 0
  int fill;
};

struct Group {
  int kind, prep, emit, n_states, n_deps, n_ops, n_emit, dep0;
  int slot[MAX_OPS];  // the emitted streams' slots
  int keep[MAX_OPS];  // their keep rows (-1: no later pass taps them)
};

struct Pass {
  int reverse, group0, n_groups;
  int edge;  // a later pass taps one of its streams with a shift
};

// A validated program, without pointers.
struct Program {
  int n_passes, n_groups, n_ext, n_slots;
  int n_keep;   // tapped streams
  int n_stage;  // operands of the widest group
  Pass pass[MAX_PASSES];
  Group group[MAX_GROUPS];
  Dep dep[MAX_DEPS];
  int slot_keep[MAX_SLOTS];  // keep row of each slot, -1 if never tapped
};

struct ChainParams {
  Program prog;
  const int32_t* ext[MAX_EXT];
  int32_t* slot[MAX_SLOTS];  // the outputs, then the workspace streams (global taps)
  int len;
  int cluster, threads, items, chunk;
  int tap_smem;  // 1: tapped streams in shared memory; 0: in slot[] (global)
  int sk;        // words of one skewed chunk row
};
static_assert(sizeof(ChainParams) <= 4096, "the plan must fit a 4 KB parameter block");

// A staged chunk row holds one padding word every 32, so that a thread's
// consecutive reads (stride `items`) fall in different banks.
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// Words of a skewed chunk row.
__host__ __device__ inline int skew_len(int chunk) { return chunk + chunk / 32 + 1; }

// Words of a CTA's shared memory: the staged operands, the keep rows, the
// warp totals (two buffers), the chunk aggregate (two buffers), the chunk's
// carry and the walk's total.
inline int smem_words(int n_stage, int n_keep_rows, int threads, int chunk) {
  return (n_stage + n_keep_rows) * skew_len(chunk) + 2 * (threads / 32) * MAX_OPS +
         4 * MAX_OPS;
}

// `_segmax_op`: (value, reset), a signed max restarted at resets.
struct SegmaxOp {
  static constexpr int N = 2;
  static constexpr int FIRST_OUT = 0;
  struct State {
    uint32_t v[2];
  };
  __device__ __forceinline__ State identity() const { return State{{0x80000000u, 0u}}; }
  __device__ __forceinline__ State combine(const State& x, const State& y) const {
    const int32_t av = (int32_t)x.v[0], bv = (int32_t)y.v[0];
    const uint32_t v = y.v[1] != 0u ? y.v[0] : (uint32_t)(av > bv ? av : bv);
    return State{{v, x.v[1] | y.v[1]}};
  }
};

// --- preps ------------------------------------------------------------------
// Twins of the plain versions in ops/stats.py (the sites' preps) and
// ops/scan.py (the kernel-layer ones); the comment names each.

__device__ __forceinline__ int32_t b2i(bool b) { return b ? 1 : 0; }

// in_unit / unit_start from the held scans (stats._derive).
__device__ __forceinline__ void derive(const int32_t* d, bool* iu, bool* us) {
  const int32_t held = d[0], hs = d[1], shh = d[2], e = d[3], w = d[4], br = d[5],
                she = d[6], shw = d[7];
  const bool iw = e != 0 ? held > 0 : w != 0;
  const bool bs = !iw && br != 0;
  const bool sym = bs || (e != 0 && !iw && hs > 0);
  const bool piw = she != 0 ? shh > 0 : shw != 0;
  *iu = iw || sym;
  *us = (iw && !piw) || bs;
}

struct PrepStructureSym {  // structure_sym
  static constexpr int ID = 1, N_DEPS = 4, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    const bool iw = d[1] != 0 ? d[0] > 0 : d[2] != 0;
    o[0] = d[1];
    o[1] = b2i(!iw && d[3] != 0);
  }
};

struct PrepStructureAgg {  // structure_agg
  static constexpr int ID = 2, N_DEPS = 11, N_OPS = 3;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    bool iu, us;
    derive(d, &iu, &us);
    o[0] = us ? 0 : 1;
    o[1] = (int32_t)((iu ? 1u << 17 : 0u) + (iu ? (uint32_t)d[8] : 0u));
    o[2] = (int32_t)((iu ? (uint32_t)d[9] : 0u) * 65536u + (iu ? (uint32_t)d[10] : 0u));
  }
};

struct PrepStructureHash {  // structure_hash
  static constexpr int ID = 3, N_DEPS = 10, N_OPS = 3;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    bool iu, us;
    derive(d, &iu, &us);
    o[0] = us ? 0 : (iu ? 31 : 1);
    o[1] = iu ? d[8] : 0;
    o[2] = iu ? d[9] : 0;
  }
};

struct PrepStructureCopy {  // structure_copy
  static constexpr int ID = 4, N_DEPS = 8, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    bool iu, us;
    derive(d, &iu, &us);
    o[0] = b2i(iu);
    o[1] = b2i(us);
  }
};

struct PrepStructureVend {  // structure_vend
  static constexpr int ID = 5, N_DEPS = 4, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    const bool ue = d[0] != 0 && (d[1] == 0 || d[2] != 0);
    o[0] = b2i(ue && (d[3] >> 16) > 0);
  }
};

struct PrepLineFlags {  // line_flags
  static constexpr int ID = 6, N_DEPS = 7, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    const int32_t lead_cnt = d[0], cnt_r = d[1], dot_run = d[2], nw = d[3], bul = d[4],
                  ell = d[5], dt = d[6];
    o[0] = b2i(nw != 0 && lead_cnt == 1 && bul != 0);
    o[1] = b2i(nw != 0 && cnt_r == 1 && (ell != 0 || (dt != 0 && dot_run >= 3)));
  }
};

struct PrepNlRunTotal {  // nl_run_total
  static constexpr int ID = 7, N_DEPS = 2, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    o[0] = d[1] != 0 ? d[0] : 0;
    o[1] = d[1];
  }
};

// The paragraph frame from run-total taps (stats._para_frame).
__device__ __forceinline__ void para_frame(const int32_t* d, bool* p_c, bool* p_s) {
  const int32_t rt = d[0], sh_rt = d[1], nl = d[2], sh_nl = d[3], it = d[4], t0f = d[5];
  const bool sep = nl != 0 && rt >= 2;
  const bool sh_sep = sh_nl != 0 && sh_rt >= 2;
  *p_c = it != 0 && !sep;
  *p_s = *p_c && (sh_sep || t0f != 0);
}

struct PrepParaHash {  // para_hash
  static constexpr int ID = 8, N_DEPS = 7, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    bool p_c, p_s;
    para_frame(d, &p_c, &p_s);
    o[0] = p_s ? 0 : (p_c ? 31 : 1);
    o[1] = p_c ? d[6] : 0;
  }
};

struct PrepParaBytes {  // para_bytes
  static constexpr int ID = 9, N_DEPS = 7, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    bool p_c, p_s;
    para_frame(d, &p_c, &p_s);
    o[0] = p_s ? 0 : 1;
    o[1] = p_c ? d[6] : 0;
  }
};

struct PrepSentenceHst {  // sentence_hst
  static constexpr int ID = 10, N_DEPS = 4, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    const int32_t pk = d[0], pk_prev = d[1], t = d[2], s = d[3];
    o[0] = (t != 0 && (pk_prev & 15) != 1) ? 0 : 1;
    o[1] = (pk & 15) > 0 ? s : 0;
  }
};

struct PrepSentenceCnt {  // sentence_cnt
  static constexpr int ID = 11, N_DEPS = 11, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    const int32_t st = d[0] & 15, pst = d[1] & 15, hst_prev = d[2], t = d[3], shd = d[4],
                  lo = d[5], al = d[6], shp = d[7], mk = d[8], ex = d[9], nw = d[10];
    const bool fresh = t != 0 && (pst == 2 || pst == 3);
    const bool cand = mk != 0 && pst > 0 && (st == 0 || fresh);
    const bool dot_last = shd != 0 && pst == 1;
    const bool nb = !(hst_prev > 0) && ((dot_last && al != 0) || lo != 0);
    const bool boundary = (cand && !nb) || (shp != 0 && mk != 0);
    o[0] = (boundary || ex != 0) ? 0 : 1;
    o[1] = nw;
  }
};

struct PrepSentenceFirst {  // sentence_first
  static constexpr int ID = 12, N_DEPS = 2, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    o[0] = b2i(d[1] != 0 && d[0] == 1);
  }
};

struct PrepResetValue {  // reset_value
  static constexpr int ID = 13, N_DEPS = 2, N_OPS = 2;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    o[0] = d[1] != 0 ? d[0] : 0;
    o[1] = d[1];
  }
};

struct PrepSum2 {  // sum2
  static constexpr int ID = 14, N_DEPS = 2, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    o[0] = (int32_t)((uint32_t)d[0] + (uint32_t)d[1]);
  }
};

struct PrepOver50 {  // over_50
  static constexpr int ID = 15, N_DEPS = 1, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) { o[0] = b2i(d[0] > 50); }
};

struct PrepLowBit {  // low_bit
  static constexpr int ID = 16, N_DEPS = 1, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) { o[0] = d[0] & 1; }
};

struct PrepTwice {  // twice
  static constexpr int ID = 17, N_DEPS = 1, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) {
    o[0] = (int32_t)((uint32_t)d[0] * 2u);
  }
};

struct PrepStateIsOne {  // state_is_one
  static constexpr int ID = 18, N_DEPS = 1, N_OPS = 1;
  static __device__ void apply(const int32_t* d, int32_t* o) { o[0] = b2i((d[0] & 15) == 1); }
};

#define CHAIN_PREPS(X)                                                                 \
  X(PrepStructureSym) X(PrepStructureAgg) X(PrepStructureHash) X(PrepStructureCopy)    \
  X(PrepStructureVend) X(PrepLineFlags) X(PrepNlRunTotal) X(PrepParaHash)              \
  X(PrepParaBytes) X(PrepSentenceHst) X(PrepSentenceCnt) X(PrepSentenceFirst)          \
  X(PrepResetValue) X(PrepSum2) X(PrepOver50) X(PrepLowBit) X(PrepTwice) X(PrepStateIsOne)

// --- one row's chunk --------------------------------------------------------------

// Where a thread stands: its row, chunk and shared memory.
struct Team {
  int t;          // thread index in the CTA
  int rank;       // chunk index of the CTA in its cluster (0 without one)
  int lane0;      // the chunk's first lane in the row
  size_t row;
  size_t row_off;
  uint32_t* stage;  // n_stage skewed rows: operands, in walk order
  uint32_t* keep;   // n_keep skewed rows: tapped streams, in lane order
  uint32_t* warp_tot;    // [2][warps][MAX_OPS]
  uint32_t* chunk_agg;   // [2][MAX_OPS]
  uint32_t* chunk_pref;  // [MAX_OPS]
  uint32_t* total;       // [MAX_OPS]
};

__device__ __forceinline__ uint32_t identity_of(const Group& g, int k) {
  switch (g.kind) {
    case KIND_AFFINE:
      return k == 0 ? 1u : 0u;
    case KIND_DFA: {
      uint32_t id = 0u;
      for (int q = 0; q < g.n_states; ++q) id |= (uint32_t)q << (4 * q);
      return id;
    }
    case KIND_SEGMAX:
      return k == 0 ? 0x80000000u : 0u;
    default:
      return 0u;
  }
}

// Dependency d at lane `l` of the chunk (natural lane `nat` of the row).
__device__ __forceinline__ int32_t load_dep(const ChainParams& p, const Team& tm, const Dep& d,
                                            int l, int nat, bool reverse) {
  if (!d.tap) return __ldg(p.ext[d.src] + tm.row_off + nat);
  if (d.shift) {
    if (nat == (reverse ? p.len - 1 : 0)) return d.fill;
    nat += reverse ? 1 : -1;
    l += reverse ? 1 : -1;
  }
  if (!p.tap_smem) return __ldcg(p.slot[d.src] + tm.row_off + nat);
  const uint32_t* row = tm.keep + p.prog.slot_keep[d.src] * p.sk;
  if (l < 0 || l >= p.chunk) {
    // The neighbour chunk's edge lane (only in a cluster: the first chunk's
    // lane -1 and the last chunk's lane `chunk` are walk position 0).
    const uint32_t* nb = cg::this_cluster().map_shared_rank(const_cast<uint32_t*>(row),
                                                            tm.rank + (l < 0 ? -1 : 1));
    return (int32_t)nb[skew(l < 0 ? p.chunk - 1 : 0)];
  }
  return (int32_t)row[skew(l)];
}

// Stages the operands of group g: operand k of the lane at walk position w
// of the chunk goes to stage[k][skew(w)].  Thread t takes lanes t + r*threads
// (coalesced); lanes past the row hold the op's identity.  P: the prep, or
// Direct<N> (operand k is dependency k).  (Loading several lanes' deps
// before applying the prep raised the kernel past 128 registers and
// spilled; more threads a row hide the loads' latency instead.)
template <class P>
__device__ __forceinline__ void stage_lanes(const ChainParams& p, const Group& g, const Team& tm,
                                            bool reverse) {
  for (int r = 0; r < p.items; ++r) {
    const int l = tm.t + r * p.threads;
    const int w = reverse ? p.chunk - 1 - l : l;
    const int nat = tm.lane0 + l;
    if (nat < p.len) {
      int32_t d[P::N_DEPS];
#pragma unroll
      for (int j = 0; j < P::N_DEPS; ++j)
        d[j] = load_dep(p, tm, p.prog.dep[g.dep0 + j], l, nat, reverse);
      int32_t o[P::N_OPS];
      P::apply(d, o);
#pragma unroll
      for (int k = 0; k < P::N_OPS; ++k) tm.stage[k * p.sk + skew(w)] = (uint32_t)o[k];
    } else {
#pragma unroll
      for (int k = 0; k < P::N_OPS; ++k) tm.stage[k * p.sk + skew(w)] = identity_of(g, k);
    }
  }
}

template <int N>
struct Direct {
  static constexpr int N_DEPS = N, N_OPS = N;
  static __device__ void apply(const int32_t* d, int32_t* o) {
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = d[k];
  }
};

__device__ __forceinline__ void stage(const ChainParams& p, const Group& g, const Team& tm,
                                      bool reverse) {
  switch (g.prep) {
#define STAGE_CASE(P)                       \
  case P::ID:                               \
    stage_lanes<P>(p, g, tm, reverse);    \
    return;
    CHAIN_PREPS(STAGE_CASE)
#undef STAGE_CASE
    default:
      switch (g.n_ops) {
        case 1: stage_lanes<Direct<1>>(p, g, tm, reverse); return;
        case 2: stage_lanes<Direct<2>>(p, g, tm, reverse); return;
        case 3: stage_lanes<Direct<3>>(p, g, tm, reverse); return;
        case 4: stage_lanes<Direct<4>>(p, g, tm, reverse); return;
        default: stage_lanes<Direct<5>>(p, g, tm, reverse); return;
      }
  }
}

template <class Op>
__device__ __forceinline__ typename Op::State read_state(const uint32_t* a) {
  typename Op::State s;
#pragma unroll
  for (int k = 0; k < Op::N; ++k) s.v[k] = a[k];
  return s;
}

template <class Op>
__device__ __forceinline__ void write_state(uint32_t* a, const typename Op::State& s) {
#pragma unroll
  for (int k = 0; k < Op::N; ++k) a[k] = s.v[k];
}

// Scans the staged operands of one group over the row, in place in walk
// order, from the chunk's carry; with `last` only the walk's total is
// written (slots of `g`, [rows, 1]).  `parity` selects the buffers that the
// next group may fill while a slow thread still reads this one's.  The
// staging must be complete (__syncthreads) before the call; the scanned stage
// is complete when it returns.
template <class Op>
__device__ __forceinline__ void scan_chunk(const ChainParams& p, const Op& op, const Group& g,
                                           const Team& tm, bool reverse, int parity) {
  using State = typename Op::State;
  constexpr int N = Op::N;
  const bool last = g.emit == EMIT_LAST;
  const int t = tm.t, lane = t & 31, warp = t >> 5, n_warps = p.threads >> 5;
  const int w0 = t * p.items;
  const State ident = op.identity();

  // Thread-local composition of `items` consecutive walk positions.
  State agg = ident;
  for (int j = 0; j < p.items; ++j) {
    State x;
#pragma unroll
    for (int k = 0; k < N; ++k) x.v[k] = tm.stage[k * p.sk + skew(w0 + j)];
    agg = op.combine(agg, x);
  }
  State inc = agg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const State other = shfl_up<Op>(inc, off);
    if (lane >= off) inc = op.combine(other, inc);
  }
  State excl = shfl_up<Op>(inc, 1);
  if (lane == 0) excl = ident;
  uint32_t* wt = tm.warp_tot + parity * n_warps * MAX_OPS;
  if (lane == 31) write_state<Op>(wt + warp * MAX_OPS, inc);
  __syncthreads();

  State pref = ident;  // the warps before this one
  for (int w = 0; w < warp; ++w) pref = op.combine(pref, read_state<Op>(wt + w * MAX_OPS));
  State carry = ident, total;
  if (p.cluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    uint32_t* agg_buf = tm.chunk_agg + parity * MAX_OPS;
    if (t == 0) {
      State tot = ident;
      for (int w = 0; w < n_warps; ++w) tot = op.combine(tot, read_state<Op>(wt + w * MAX_OPS));
      write_state<Op>(agg_buf, tot);
    }
    cluster.sync();
    if (warp == 0) {
      // Lane c holds the chunk at walk index c: the chunks in walk order.
      State a = ident;
      if (lane < p.cluster) {
        const int rank = reverse ? p.cluster - 1 - lane : lane;
        a = read_state<Op>(cluster.map_shared_rank(agg_buf, rank));
      }
      State ci = a;
#pragma unroll
      for (int off = 1; off < MAX_CLUSTER; off <<= 1) {
        const State other = shfl_up<Op>(ci, off);
        if (lane >= off) ci = op.combine(other, ci);
      }
      State ce = shfl_up<Op>(ci, 1);
      if (lane == 0) ce = ident;
      const int walk_idx = reverse ? p.cluster - 1 - tm.rank : tm.rank;
      const State mine = shfl_idx<Op>(ce, walk_idx);
      const State tot = shfl_idx<Op>(ci, p.cluster - 1);
      if (lane == 0) {
        write_state<Op>(tm.chunk_pref, mine);
        write_state<Op>(tm.total, tot);
      }
    }
    __syncthreads();
    carry = read_state<Op>(tm.chunk_pref);
    total = read_state<Op>(tm.total);
  } else {
    total = ident;
    if (last && t == 0)
      for (int w = 0; w < n_warps; ++w) total = op.combine(total, read_state<Op>(wt + w * MAX_OPS));
  }

  if (last) {
    if (t == 0 && tm.rank == 0)
      for (int j = 0; j < g.n_emit; ++j)
        p.slot[g.slot[j]][tm.row] = (int32_t)total.v[Op::FIRST_OUT + j];
    return;
  }
  State run = op.combine(op.combine(carry, pref), excl);
  for (int j = 0; j < p.items; ++j) {
    State x;
#pragma unroll
    for (int k = 0; k < N; ++k) x.v[k] = tm.stage[k * p.sk + skew(w0 + j)];
    run = op.combine(run, x);
#pragma unroll
    for (int k = Op::FIRST_OUT; k < N; ++k) tm.stage[k * p.sk + skew(w0 + j)] = run.v[k];
  }
  __syncthreads();
}

__device__ __forceinline__ void scan_group(const ChainParams& p, const Group& g, const Team& tm,
                                           bool reverse, int parity) {
  switch (g.kind) {
    case KIND_AFFINE:
      switch (g.n_ops) {
        case 2: scan_chunk(p, Affine<1>{}, g, tm, reverse, parity); break;
        case 3: scan_chunk(p, Affine<2>{}, g, tm, reverse, parity); break;
        case 4: scan_chunk(p, Affine<3>{}, g, tm, reverse, parity); break;
        default: scan_chunk(p, Affine<4>{}, g, tm, reverse, parity); break;
      }
      break;
    case KIND_ADD:
      switch (g.n_ops) {
        case 1: scan_chunk(p, Add<1>{}, g, tm, reverse, parity); break;
        case 2: scan_chunk(p, Add<2>{}, g, tm, reverse, parity); break;
        case 3: scan_chunk(p, Add<3>{}, g, tm, reverse, parity); break;
        case 4: scan_chunk(p, Add<4>{}, g, tm, reverse, parity); break;
        default: scan_chunk(p, Add<5>{}, g, tm, reverse, parity); break;
      }
      break;
    case KIND_DFA:
      switch (g.n_states) {
        case 1: scan_chunk(p, Dfa<1>{}, g, tm, reverse, parity); break;
        case 2: scan_chunk(p, Dfa<2>{}, g, tm, reverse, parity); break;
        case 3: scan_chunk(p, Dfa<3>{}, g, tm, reverse, parity); break;
        case 4: scan_chunk(p, Dfa<4>{}, g, tm, reverse, parity); break;
        case 5: scan_chunk(p, Dfa<5>{}, g, tm, reverse, parity); break;
        case 6: scan_chunk(p, Dfa<6>{}, g, tm, reverse, parity); break;
        case 7: scan_chunk(p, Dfa<7>{}, g, tm, reverse, parity); break;
        default: scan_chunk(p, Dfa<8>{}, g, tm, reverse, parity); break;
      }
      break;
    default:
      scan_chunk(p, SegmaxOp{}, g, tm, reverse, parity);
      break;
  }
}

// Writes group g's emitted streams from the stage: to their keep rows (a
// later pass taps them) and, for emit "scan" (or, with global taps, every
// full stream), to global memory.  Same lane mapping as the staging.
__device__ __forceinline__ void emit_streams(const ChainParams& p, const Group& g, const Team& tm,
                                             bool reverse) {
  const int first_out = g.kind == KIND_AFFINE ? 1 : 0;
  for (int j = 0; j < g.n_emit; ++j) {
    const uint32_t* src = tm.stage + (first_out + j) * p.sk;
    const int keep = p.tap_smem ? g.keep[j] : -1;
    uint32_t* krow = keep >= 0 ? tm.keep + keep * p.sk : nullptr;
    int32_t* dst = g.emit == EMIT_SCAN || (!p.tap_smem && g.keep[j] >= 0)
                       ? p.slot[g.slot[j]] + tm.row_off
                       : nullptr;
    for (int r = 0; r < p.items; ++r) {
      const int l = tm.t + r * p.threads;
      const int w = reverse ? p.chunk - 1 - l : l;
      const uint32_t v = src[skew(w)];
      if (krow) krow[skew(l)] = v;
      const int nat = tm.lane0 + l;
      if (dst && nat < p.len) dst[nat] = (int32_t)v;
    }
  }
}

// Every device function is inlined into the kernel, so that the chunk's
// shared-memory pointers stay in registers.  Up to 1024 threads: at most
// 64 registers a thread (a few spill).
__global__ void __launch_bounds__(MAX_THREADS)
    chain_scan_kernel(const __grid_constant__ ChainParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  Team tm;
  tm.rank = p.cluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  tm.row = blockIdx.x / p.cluster;
  tm.t = threadIdx.x;
  tm.lane0 = tm.rank * p.chunk;
  tm.row_off = tm.row * (size_t)p.len;
  tm.stage = smem;
  tm.keep = smem + p.prog.n_stage * p.sk;
  tm.warp_tot = tm.keep + (p.tap_smem ? p.prog.n_keep : 0) * p.sk;
  tm.chunk_agg = tm.warp_tot + 2 * (p.threads / 32) * MAX_OPS;
  tm.chunk_pref = tm.chunk_agg + 2 * MAX_OPS;
  tm.total = tm.chunk_pref + MAX_OPS;

  int parity = 0;
  for (int ps = 0; ps < p.prog.n_passes; ++ps) {
    const Pass& pass = p.prog.pass[ps];
    const bool reverse = pass.reverse != 0;
    for (int gi = pass.group0; gi < pass.group0 + pass.n_groups; ++gi) {
      const Group& g = p.prog.group[gi];
      stage(p, g, tm, reverse);
      if (g.kind != KIND_COPY) {
        __syncthreads();
        scan_group(p, g, tm, reverse, parity);
        parity ^= 1;
      }
      if (g.emit != EMIT_LAST) emit_streams(p, g, tm, reverse);
    }
    // Later passes read this pass's streams at other lanes: at the
    // neighbour chunk's edge too if they tap one with a shift.
    if (p.cluster > 1 && pass.edge) {
      if (!p.tap_smem) __threadfence();
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  // No CTA leaves while another may still read its shared memory.
  if (p.cluster > 1) cg::this_cluster().sync();
}

// --- encoding -----------------------------------------------------------------

bool prep_arity(int id, int* n_deps, int* n_ops) {
  switch (id) {
#define ARITY_CASE(P)    \
  case P::ID:            \
    *n_deps = P::N_DEPS; \
    *n_ops = P::N_OPS;   \
    return true;
    CHAIN_PREPS(ARITY_CASE)
#undef ARITY_CASE
    default:
      return false;
  }
}

// Streams a group of `kind` with n_ops operands emits, or -1 if the kernel
// does not take the group.
int emitted_streams(int kind, int n_ops, int n_states, int emit) {
  switch (kind) {
    case KIND_AFFINE: return n_ops >= 2 ? n_ops - 1 : -1;
    case KIND_ADD: return n_ops;
    case KIND_DFA: return n_ops == 1 && n_states >= 1 && n_states <= 8 ? 1 : -1;
    case KIND_SEGMAX: return n_ops == 2 ? 1 : -1;
    case KIND_COPY: return emit != EMIT_LAST ? n_ops : -1;
    default: return -1;
  }
}

// Parses and validates a program (the format of tb_chain_encode); false for
// a program the kernel does not take.
bool parse(const int* code, int n_code, int n_ext, int n_slots, Program* out) {
  if (n_ext < 1 || n_ext > MAX_EXT || n_slots < 0 || n_slots > MAX_SLOTS) return false;
  Program pr = {};
  pr.n_ext = n_ext;
  pr.n_slots = n_slots;
  int slot_pass[MAX_SLOTS], slot_last[MAX_SLOTS];
  for (int s = 0; s < MAX_SLOTS; ++s) slot_pass[s] = slot_last[s] = pr.slot_keep[s] = -1;
  int pos = 0;
  auto next = [&](int* v) {
    if (pos >= n_code) return false;
    *v = code[pos++];
    return true;
  };
  if (!next(&pr.n_passes) || pr.n_passes < 1 || pr.n_passes > MAX_PASSES) return false;
  int n_groups = 0, n_deps = 0;
  for (int ps = 0; ps < pr.n_passes; ++ps) {
    Pass& pass = pr.pass[ps];
    if (!next(&pass.reverse) || !next(&pass.n_groups)) return false;
    if ((pass.reverse != 0 && pass.reverse != 1) || pass.n_groups < 1 ||
        n_groups + pass.n_groups > MAX_GROUPS)
      return false;
    pass.group0 = n_groups;
    for (int gi = 0; gi < pass.n_groups; ++gi) {
      Group& g = pr.group[n_groups++];
      if (!next(&g.kind) || !next(&g.prep) || !next(&g.emit) || !next(&g.n_states) ||
          !next(&g.n_deps) || !next(&g.n_ops) || !next(&g.n_emit))
        return false;
      if (g.emit < EMIT_SCAN || g.emit > EMIT_NONE || g.n_ops < 1 || g.n_ops > MAX_OPS ||
          g.n_deps < 1 || n_deps + g.n_deps > MAX_DEPS)
        return false;
      if (g.prep == 0) {
        if (g.n_deps != g.n_ops) return false;
      } else {
        int want_deps, want_ops;
        if (!prep_arity(g.prep, &want_deps, &want_ops) || want_deps != g.n_deps ||
            want_ops != g.n_ops)
          return false;
      }
      if (emitted_streams(g.kind, g.n_ops, g.n_states, g.emit) != g.n_emit) return false;
      if (g.n_ops > pr.n_stage) pr.n_stage = g.n_ops;
      g.dep0 = n_deps;
      for (int j = 0; j < g.n_deps; ++j) {
        Dep& d = pr.dep[n_deps++];
        if (!next(&d.tap) || !next(&d.src) || !next(&d.shift) || !next(&d.fill)) return false;
        if (d.tap == 0) {
          if (d.src < 0 || d.src >= n_ext || d.shift != 0) return false;
        } else if (d.tap == 1) {
          if (d.src < 0 || d.src >= n_slots || (d.shift != 0 && d.shift != 1) ||
              slot_pass[d.src] < 0 || slot_pass[d.src] >= ps || slot_last[d.src] == 1)
            return false;
          if (pr.slot_keep[d.src] < 0) pr.slot_keep[d.src] = pr.n_keep++;
          if (d.shift) pr.pass[slot_pass[d.src]].edge = 1;
        } else {
          return false;
        }
      }
      for (int j = 0; j < g.n_emit; ++j) {
        int s;
        if (!next(&s) || s < 0 || s >= n_slots || slot_pass[s] >= 0) return false;
        slot_pass[s] = ps;
        slot_last[s] = g.emit == EMIT_LAST ? 1 : 0;
        g.slot[j] = s;
      }
    }
  }
  if (pos != n_code) return false;
  pr.n_groups = n_groups;
  // Keep rows are known once every tap is read.
  for (int gi = 0; gi < n_groups; ++gi) {
    Group& g = pr.group[gi];
    for (int j = 0; j < MAX_OPS; ++j) g.keep[j] = j < g.n_emit ? pr.slot_keep[g.slot[j]] : -1;
  }
  *out = pr;
  return true;
}

std::mutex g_mu;
std::vector<std::unique_ptr<Program>> g_programs;
constexpr int MAX_DEVICES = 64;
bool g_attr_set[MAX_DEVICES] = {};

}  // namespace

extern "C" {

// Parses and validates a chain program once and keeps it; returns its
// handle (>= 0), or -cudaErrorInvalidValue for a program the kernel does not
// take (a bad index, a tap of a later, the same or a "last" stream, a slot
// written twice, a prep whose counts differ).  `code` (n_code ints) is the
// program as ops/scan.py's _chain_code writes it: n_passes; per pass
// reverse, n_groups; per group kind, prep id, emit, n_states, n_deps, n_ops,
// n_emit, then per dep (tap, index, shift, fill) and the n_emit slots it
// writes.  n_ext external operands; n_slots streams (the outputs, then the
// emit "none" streams).  `info` receives (n_keep, n_stage).
int tb_chain_encode(const int* code, int n_code, int n_ext, int n_slots, int* info) {
  std::unique_ptr<Program> pr(new Program);
  if (!parse(code, n_code, n_ext, n_slots, pr.get())) return -(int)cudaErrorInvalidValue;
  info[0] = pr->n_keep;
  info[1] = pr->n_stage;
  std::lock_guard<std::mutex> lock(g_mu);
  g_programs.push_back(std::move(pr));
  return (int)g_programs.size() - 1;
}

// Launches the program `handle` over rows x len int32 streams: ext, the
// n_ext external operands; slots, the n_slots streams ([rows, len], or
// [rows, 1] for emit "last"; the emit "none" ones may be null unless
// tap_smem is 0).  The geometry (CTAs per row, threads and lanes per thread
// of a chunk, taps in shared memory or not) is ops/scan.py's
// chain_geometry; it is re-checked here.  Returns the launch's
// CUDA error, or cudaErrorInvalidValue for a geometry or pointer table
// that does not fit the program.
int tb_chain_launch(int handle, const int32_t* const* ext, int n_ext, int32_t* const* slots,
                    int n_slots, int rows, int len, int cluster, int threads, int items,
                    int tap_smem, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  ChainParams p;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (handle < 0 || handle >= (int)g_programs.size()) return bad;
    p.prog = *g_programs[handle];
  }
  if (n_ext != p.prog.n_ext || n_slots != p.prog.n_slots || rows < 0 || len < 0) return bad;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || items < 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || (tap_smem != 0 && tap_smem != 1))
    return bad;
  const long long chunk = (long long)threads * items;
  if (chunk * cluster < len || chunk > (1 << 20)) return bad;
  p.len = len;
  p.cluster = cluster;
  p.threads = threads;
  p.items = items;
  p.chunk = (int)chunk;
  p.tap_smem = tap_smem;
  p.sk = skew_len(p.chunk);
  const long long smem =
      4LL * smem_words(p.prog.n_stage, tap_smem ? p.prog.n_keep : 0, threads, p.chunk);
  if (smem > SMEM_LIMIT) return bad;
  for (int i = 0; i < n_ext; ++i) {
    if (ext[i] == nullptr) return bad;
    p.ext[i] = ext[i];
  }
  for (int s = 0; s < n_slots; ++s) p.slot[s] = slots[s];
  for (int gi = 0; gi < p.prog.n_groups; ++gi) {
    const Group& g = p.prog.group[gi];
    for (int j = 0; j < g.n_emit; ++j)
      if (p.slot[g.slot[j]] == nullptr &&
          (g.emit == EMIT_LAST || (len > 0 && (g.emit == EMIT_SCAN || !tap_smem))))
        return bad;
  }
  if (rows == 0) return (int)cudaSuccess;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_attr_set[dev]) {
      err = cudaFuncSetAttribute(chain_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
      if (err != cudaSuccess) return (int)err;
      g_attr_set[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, chain_scan_kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
