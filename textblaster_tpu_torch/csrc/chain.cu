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
//     states): the ops of fused.cu, from scan_ops.cuh;
//   * segmax (`_segmax_op`): a segmented running max over (value, reset),
//     a SIGNED max restarted where the later element resets, identity
//     (INT32_MIN, 0); the value stream is emitted;
//   * copy: no scan; the operands are emitted as they are.
//
// A group emits its streams in full (emit "scan", [rows, len]; emit "none",
// the same into the caller's workspace, tap-only) or only its final carry
// (emit "last", [rows, 1]).  A reverse pass walks the row back to front and
// writes its streams in natural lane order, which is the staged
// rev(scan(rev(x))).
//
// Preps.  The JAX preps are jnp closures traced into the kernel.  Here each
// is a struct below with an id, its dependency and operand counts and a
// __device__ apply(); the plan names it by id, and ops/scan.py (PREPS) and
// ops/stats.py hold the same table and the plain versions.  Preps compute
// in signed int32 (signed compares, arithmetic >>); scans compute in uint32.
//
// Design.  One CTA per row, the passes in order with __syncthreads()
// between them, so a later pass's taps -- shift taps across a tile boundary
// included -- read settled data without a grid-wide sync.  For each group
// the CTA walks the row in tiles of SCAN_TILE lanes: every thread loads
// the dependencies of its strided lanes (coalesced; tap loads bypass L1
// with __ldcg, the streams being written by this launch), applies the prep
// and stages the operands in shared memory; the tile is then scanned by
// scan_ops.cuh's scan_tile (SCAN_ITEMS consecutive items per thread, a
// __shfl_up_sync warp scan, the warp totals combined through shared
// memory, a carried prefix), as in scan.cu and fused.cu, and written back.  The ragged edge holds the op's identity, so any width
// is taken, and in a reverse pass the ragged tile is the walk's last.
//
// The program travels as a by-value kernel parameter block, __grid_constant__
// (no copy per thread): counted below, ChainParams is 2,344 bytes, within
// the 4 KB that kernel parameters had before CUDA 12.1.  It covers every
// site with room: the largest, `structure` with hashes, has 5 passes, 7
// groups, 40 deps, 10 external operands and 10 streams (12 external
// operands at most, in gopher_quality, gopher_rep and C4's sentence mode).
// The kernel allocates nothing: the wrapper allocates the outputs and the
// workspace.
//
// Bound: memory.  The external operands are read once and the emit "scan"
// streams and "last" carries written once; taps and workspace streams stay
// in the 50 MB L2 at the main path's sizes and are left out of the bound.
// Known weakness: one CTA per row (64 rows on 132 SMs), and the groups and
// passes of a row run one after another; staging workspace streams in
// shared memory and splitting rows across CTAs are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ops.cuh"

namespace {

using namespace tb;

constexpr int MAX_PASSES = 8;
constexpr int MAX_GROUPS = 16;
constexpr int MAX_DEPS = 64;
constexpr int MAX_EXT = 16;
constexpr int MAX_SLOTS = 32;
constexpr int MAX_OPS = 5;

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
};

struct Pass {
  int reverse, group0, n_groups;
};

struct ChainParams {
  int n_passes;
  Pass pass[MAX_PASSES];
  Group group[MAX_GROUPS];
  Dep dep[MAX_DEPS];
  const int32_t* ext[MAX_EXT];
  int32_t* slot[MAX_SLOTS];  // the outputs, then the workspace streams
};
static_assert(sizeof(ChainParams) <= 4096, "the plan must fit a 4 KB parameter block");

using ChainSmem = TileSmem<MAX_OPS>;

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

// --- staging ----------------------------------------------------------------

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

// Dependency d at natural lane `nat` (walk position w) of the row at row_off.
__device__ __forceinline__ int32_t load_dep(const ChainParams& p, const Dep& d, size_t row_off,
                                            int nat, int w, bool reverse) {
  if (!d.tap) return __ldg(p.ext[d.src] + row_off + nat);
  if (d.shift) {
    if (w == 0) return d.fill;
    nat += reverse ? 1 : -1;
  }
  return __ldcg(p.slot[d.src] + row_off + nat);
}

// Stages the operands of group g for the tile at walk position `base`:
// operand k of lane i goes to sm.tile[k][skew(i)].
template <class P>
__device__ void stage_prep(const ChainParams& p, const Group& g, ChainSmem& sm, size_t row_off,
                           int len, bool reverse, int base) {
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const int w = base + i;
    if (w < len) {
      const int nat = reverse ? len - 1 - w : w;
      int32_t d[P::N_DEPS];
#pragma unroll
      for (int j = 0; j < P::N_DEPS; ++j)
        d[j] = load_dep(p, p.dep[g.dep0 + j], row_off, nat, w, reverse);
      int32_t o[P::N_OPS];
      P::apply(d, o);
#pragma unroll
      for (int k = 0; k < P::N_OPS; ++k) sm.tile[k][skew(i)] = (uint32_t)o[k];
    } else {
#pragma unroll
      for (int k = 0; k < P::N_OPS; ++k) sm.tile[k][skew(i)] = identity_of(g, k);
    }
  }
}

// No prep: operand k is dependency k.
__device__ void stage_direct(const ChainParams& p, const Group& g, ChainSmem& sm,
                             size_t row_off, int len, bool reverse, int base) {
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const int w = base + i;
    const int nat = reverse ? len - 1 - w : w;
    for (int k = 0; k < g.n_ops; ++k)
      sm.tile[k][skew(i)] = w < len
          ? (uint32_t)load_dep(p, p.dep[g.dep0 + k], row_off, nat, w, reverse)
          : identity_of(g, k);
  }
}

__device__ void stage(const ChainParams& p, const Group& g, ChainSmem& sm, size_t row_off,
                      int len, bool reverse, int base) {
  switch (g.prep) {
#define STAGE_CASE(P)                                          \
  case P::ID:                                                  \
    stage_prep<P>(p, g, sm, row_off, len, reverse, base);      \
    return;
    CHAIN_PREPS(STAGE_CASE)
#undef STAGE_CASE
    default:
      stage_direct(p, g, sm, row_off, len, reverse, base);
  }
}

// --- one group over one row -------------------------------------------------

__device__ void run_group(const ChainParams& p, const Group& g, ChainSmem& sm, size_t row,
                          int len, bool reverse) {
  const int tid = threadIdx.x;
  const size_t row_off = row * (size_t)len;
  const bool last = g.emit == EMIT_LAST;
  const int first_out = g.kind == KIND_AFFINE ? 1 : 0;

  __syncthreads();  // the previous group is done with shared memory
  if (tid < g.n_ops) sm.carry[tid] = identity_of(g, tid);

  for (int base = 0; base < len; base += SCAN_TILE) {
    stage(p, g, sm, row_off, len, reverse, base);
    __syncthreads();
    switch (g.kind) {
      case KIND_AFFINE:
        switch (g.n_ops) {
          case 2: scan_tile(AffineOp<1>{}, sm, 0, last); break;
          case 3: scan_tile(AffineOp<2>{}, sm, 0, last); break;
          case 4: scan_tile(AffineOp<3>{}, sm, 0, last); break;
          default: scan_tile(AffineOp<4>{}, sm, 0, last); break;
        }
        break;
      case KIND_ADD:
        for (int s = 0; s < g.n_ops; ++s) scan_tile(AddOp{}, sm, s, last);
        break;
      case KIND_DFA:
        scan_tile(DfaOp{g.n_states}, sm, 0, last);
        break;
      case KIND_SEGMAX:
        scan_tile(SegmaxOp{}, sm, 0, last);
        break;
      default:  // copy: the staged operands are the stream
        break;
    }
    if (!last) {
      for (int j = 0; j < g.n_emit; ++j) {
        int32_t* dst = p.slot[g.slot[j]] + row_off;
        const uint32_t* src = sm.tile[first_out + j];
        for (int i = tid; i < SCAN_TILE; i += SCAN_THREADS) {
          const int w = base + i;
          if (w < len) dst[reverse ? len - 1 - w : w] = (int32_t)src[skew(i)];
        }
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }
  __syncthreads();  // the carry is settled (also for an empty row)
  if (last && tid < g.n_emit) p.slot[g.slot[tid]][row] = (int32_t)sm.carry[first_out + tid];
}

__global__ void __launch_bounds__(SCAN_THREADS)
    chain_scan_kernel(const __grid_constant__ ChainParams p, int len) {
  __shared__ ChainSmem sm;
  const size_t row = blockIdx.x;
  for (int ps = 0; ps < p.n_passes; ++ps) {
    const Pass& pass = p.pass[ps];
    for (int gi = pass.group0; gi < pass.group0 + pass.n_groups; ++gi)
      run_group(p, p.group[gi], sm, row, len, pass.reverse != 0);
    __syncthreads();  // this pass's streams are written before a later pass taps them
  }
}

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

}  // namespace

extern "C" {

// Evaluates a chain program over rows x len int32 streams in one launch.
// `code` (n_code ints) is the program as ops/scan.py's _chain_code writes
// it: n_passes; per pass reverse, n_groups; per group kind, prep id, emit,
// n_states, n_deps, n_ops, n_emit, then per dep (tap, index, shift, fill)
// and the n_emit slots it writes.  ext: the n_ext external operands;
// slots: the n_slots streams ([rows, len], or [rows, 1] for emit "last").
// Host arrays; everything is copied into the launch's parameter block.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a program the
// kernel does not take (a bad index, a tap of a later, the same or a "last"
// stream, a slot written twice, a prep whose counts differ).
int tb_chain_scan(const int* code, int n_code, const int32_t* const* ext, int n_ext,
                  int32_t* const* slots, int n_slots, int rows, int len, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (rows < 0 || len < 0 || n_ext < 1 || n_ext > MAX_EXT || n_slots < 0 || n_slots > MAX_SLOTS)
    return bad;
  ChainParams p = {};
  int slot_pass[MAX_SLOTS], slot_last[MAX_SLOTS];
  for (int s = 0; s < MAX_SLOTS; ++s) slot_pass[s] = slot_last[s] = -1;
  int pos = 0;
  auto next = [&](int* v) {
    if (pos >= n_code) return false;
    *v = code[pos++];
    return true;
  };
  if (!next(&p.n_passes) || p.n_passes < 1 || p.n_passes > MAX_PASSES) return bad;
  int n_groups = 0, n_deps = 0;
  for (int ps = 0; ps < p.n_passes; ++ps) {
    Pass& pass = p.pass[ps];
    if (!next(&pass.reverse) || !next(&pass.n_groups)) return bad;
    if ((pass.reverse != 0 && pass.reverse != 1) || pass.n_groups < 1 ||
        n_groups + pass.n_groups > MAX_GROUPS)
      return bad;
    pass.group0 = n_groups;
    for (int gi = 0; gi < pass.n_groups; ++gi) {
      Group& g = p.group[n_groups++];
      if (!next(&g.kind) || !next(&g.prep) || !next(&g.emit) || !next(&g.n_states) ||
          !next(&g.n_deps) || !next(&g.n_ops) || !next(&g.n_emit))
        return bad;
      if (g.emit < EMIT_SCAN || g.emit > EMIT_NONE || g.n_ops < 1 || g.n_ops > MAX_OPS ||
          g.n_deps < 1 || n_deps + g.n_deps > MAX_DEPS)
        return bad;
      if (g.prep == 0) {
        if (g.n_deps != g.n_ops) return bad;
      } else {
        int want_deps, want_ops;
        if (!prep_arity(g.prep, &want_deps, &want_ops) || want_deps != g.n_deps ||
            want_ops != g.n_ops)
          return bad;
      }
      if (emitted_streams(g.kind, g.n_ops, g.n_states, g.emit) != g.n_emit) return bad;
      g.dep0 = n_deps;
      for (int j = 0; j < g.n_deps; ++j) {
        Dep& d = p.dep[n_deps++];
        if (!next(&d.tap) || !next(&d.src) || !next(&d.shift) || !next(&d.fill)) return bad;
        if (d.tap == 0) {
          if (d.src < 0 || d.src >= n_ext || d.shift != 0) return bad;
        } else if (d.tap == 1) {
          if (d.src < 0 || d.src >= n_slots || (d.shift != 0 && d.shift != 1) ||
              slot_pass[d.src] < 0 || slot_pass[d.src] >= ps || slot_last[d.src] == 1)
            return bad;
        } else {
          return bad;
        }
      }
      for (int j = 0; j < g.n_emit; ++j) {
        int s;
        if (!next(&s) || s < 0 || s >= n_slots || slot_pass[s] >= 0) return bad;
        slot_pass[s] = ps;
        slot_last[s] = g.emit == EMIT_LAST ? 1 : 0;
        g.slot[j] = s;
      }
    }
  }
  if (pos != n_code) return bad;
  for (int i = 0; i < n_ext; ++i) p.ext[i] = ext[i];
  for (int i = 0; i < n_slots; ++i) p.slot[i] = slots[i];
  if (rows == 0) return (int)cudaSuccess;
  chain_scan_kernel<<<rows, SCAN_THREADS, 0, stream>>>(p, len);
  return (int)cudaGetLastError();
}

}  // extern "C"
