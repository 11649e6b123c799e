// Row-wise ascending lexicographic sort of int32 key pairs (sort2) and key
// triples (sort3) for Hopper (sm_90a): bitonic networks over packed keys.
//
// Replaces the Pallas bitonic sorter of the JAX package
// (textblaster_tpu/ops/pallas_sort.py, `_pallas_sort_n` + `_bitonic_kernel`,
// reached through `sort2` and `sort3`).
//
// Keys.  sort2 packs ((uint64)((uint32)k1 ^ 0x80000000) << 32) | (uint32)k2.
// Its unsigned order is signed-k1-then-k2 for the non-negative payloads k2
// that every caller passes, which is the order of both the TPU network and
// the JAX CPU path's packed int64 sort; the sign flip keeps negative hashes
// first.  sort3's three keys do not fit 64 bits: its element is a pair
// (hi = flip(k1) << 32 | flip(k2), lo = flip(k3)) compared hi then lo, every
// key sign-flipped, so any int32 keys sort in signed lexicographic order
// (`lax.sort(num_keys=3)`).  Equal elements are equal tuples, so a network
// being unstable changes no output.  Rows of real width m are padded to mp
// (a power of two) with the element of INT32_MAX keys, which sorts last.
//
// What bounds a sort on this card.  The keys cross HBM once each way
// (16 bytes per sort2 element, 24 per sort3 element), but a bitonic network
// does log2(mp)*(log2(mp)+1)/2 stages over every element: 105 at 16384.  A
// network held in shared memory pays a full shared-memory pass and a block
// barrier per stage, so it is bound by shared-memory traffic and barrier
// latency, 18-40x above the byte bound.
//
// The register network (`sort_warp_kernel`, `sort_cta_kernel`) is one
// network for both elements, templated on the key type: `Key2` (one u64 a
// key) and `Key3` (a u64 and a u32).  The key type owns what depends on the
// element: loads and stores (int4 where the row allows), the compare, the
// XOR shuffle (two 32-bit shuffles for Key2, three for Key3) and the
// shared-memory slots (Key3: a swizzled u64 array for hi and a u32 array for
// lo, 12 bytes a key).  Each thread holds E consecutive keys (a "blocked"
// layout: element i lives in thread i / E, register i % E):
//   * stages of stride < E compare registers of one thread: no memory, no
//     barrier;
//   * strides E .. 16E pair threads of one warp: shuffles;
//   * strides 32E .. n/2 (n = the keys of one CTA) cross warps.  Those run
//     in shared memory: the CTA writes its registers out once per merge
//     (XOR swizzles keep a warp's accesses on distinct banks), runs the wide
//     strides there two at a time (each thread exchanges four keys between
//     barriers), and reads its registers back;
//   * strides >= n, in a cluster of 2 or 4 CTAs (rank r holds
//     [r*n, (r+1)*n)): each CTA writes its keys to shared memory and reads
//     its partner's (rank ^ stride/n) through distributed shared memory
//     between two cluster barriers.  In a cluster of 4 the direction bit of
//     a merge of 2n lies in the rank bits: ranks 0-1 ascend, 2-3 descend.
// Rows of up to 32E keys are sorted by one warp each, four rows per CTA,
// with no block barrier.  The layout of a row (E, threads, CTAs, rows a
// CTA) is chosen by ops/sort.py's `sort_geometry`, which holds the table of
// the card sweep that chose it; the entries take only the variants this
// library instantiates (a build with -DTB_SORT_SWEEP adds the ones the
// sweep in kernel_ab.py tries beside them).
//
// Wider rows (sort2 above 16384 keys, sort3 above 32768: beyond the JAX
// package's Pallas range, and off the default path, where the tables use
// scatter) keep the earlier shared-memory network (`bitonic_tile_kernel`):
// sort each tile in shared memory with the global network's directions, run
// each stage whose stride is at least the tile as a global-memory pass over
// a packed scratch buffer, and finish every merge's small strides tile by
// tile.
//
// Each kernel's shared-memory limit is raised once per process and device,
// by its launcher.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int SORT_THREADS = 1024;
// The register network: rows per CTA in the warp path, the most keys one CTA
// holds.
constexpr int WARP_ROWS = 4;
constexpr int CTA_MAX = 8192;
constexpr u64 PAD2 = 0xFFFFFFFF7FFFFFFFull;  // (INT32_MAX, INT32_MAX)
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t flip(int32_t k) { return (uint32_t)k ^ 0x80000000u; }
__device__ __forceinline__ int32_t unflip(uint32_t v) { return (int32_t)(v ^ 0x80000000u); }

// Shared-memory slot of element i in an 8-byte array: the low four index
// bits XOR the next four, so that the 16 threads of a half-warp that write
// register e of 16 consecutive threads (i = E t + e, E = 8 or 16) hit 16
// distinct 8-byte bank pairs, as do 16 consecutive elements.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }
// The same for a 4-byte array, whose 32 banks a whole warp shares: the low
// five bits XOR the next five (32 distinct banks for i = E t + e over a
// warp, E = 8 or 16, and for 32 consecutive elements).
__device__ __forceinline__ int swz32(int i) { return i ^ ((i >> 5) & 31); }

struct Ptrs {
  const int32_t* k[3];
  int32_t* o[3];
};

struct Key2 {
  typedef u64 T;
  static constexpr int TILE = 16384;    // the shared-memory network's tile
  static constexpr int SMEM_BYTES = 8;  // a key's shared memory in the register network
  static constexpr int MIN_CTAS = 2;    // two 512-thread CTAs an SM: 64 registers
  static __device__ __forceinline__ T pad() { return PAD2; }
  static __device__ __forceinline__ T pack(int32_t a, int32_t b) {
    return ((u64)flip(a) << 32) | (uint32_t)b;
  }
  static __device__ __forceinline__ T load(const Ptrs& p, size_t i) {
    return pack(p.k[0][i], p.k[1][i]);
  }
  // Column c of the row at `row`, through the read-only cache.
  static __device__ __forceinline__ T ldg(const Ptrs& p, size_t row, int c) {
    return pack(__ldg(p.k[0] + row + c), __ldg(p.k[1] + row + c));
  }
  // Columns c + 4q .. c + 4q + 3 (c 16-byte aligned).
  static __device__ __forceinline__ void ldg4(const Ptrs& p, size_t row, int c, int q, T& v0,
                                              T& v1, T& v2, T& v3) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p.k[0] + row + c) + q);
    const int4 y = __ldg(reinterpret_cast<const int4*>(p.k[1] + row + c) + q);
    v0 = pack(x.x, y.x);
    v1 = pack(x.y, y.y);
    v2 = pack(x.z, y.z);
    v3 = pack(x.w, y.w);
  }
  static __device__ __forceinline__ void store(const T& v, const Ptrs& p, size_t row, int c) {
    p.o[0][row + c] = unflip((uint32_t)(v >> 32));
    p.o[1][row + c] = (int32_t)(uint32_t)(v & 0xFFFFFFFFull);
  }
  static __device__ __forceinline__ void store4(const T& v0, const T& v1, const T& v2,
                                                const T& v3, const Ptrs& p, size_t row, int c,
                                                int q) {
    reinterpret_cast<int4*>(p.o[0] + row + c)[q] =
        make_int4(unflip((uint32_t)(v0 >> 32)), unflip((uint32_t)(v1 >> 32)),
                  unflip((uint32_t)(v2 >> 32)), unflip((uint32_t)(v3 >> 32)));
    reinterpret_cast<int4*>(p.o[1] + row + c)[q] = make_int4((int32_t)(uint32_t)v0, (int32_t)(uint32_t)v1,
                                                     (int32_t)(uint32_t)v2, (int32_t)(uint32_t)v3);
  }
  static __device__ __forceinline__ bool less(const T& a, const T& b) { return a < b; }
  static __device__ __forceinline__ T shfl_xor(const T& v, int lm) {
    return __shfl_xor_sync(FULL, v, lm);
  }
  // The register network's shared memory: n swizzled u64 slots.
  struct Slots {
    u64* hi;
    __device__ __forceinline__ Slots(unsigned char* raw, int) : hi(reinterpret_cast<u64*>(raw)) {}
    __device__ __forceinline__ explicit Slots(u64* h) : hi(h) {}
    __device__ __forceinline__ void put(int i, const T& v) const { hi[swz(i)] = v; }
    __device__ __forceinline__ T get(int i) const { return hi[swz(i)]; }
    __device__ __forceinline__ Slots remote(cg::cluster_group& c, int rank) const {
      return Slots(c.map_shared_rank(hi, rank));
    }
  };
};

struct Key3 {
  struct T {
    u64 hi;
    uint32_t lo;
  };
  static constexpr int TILE = 8192;
  static constexpr int SMEM_BYTES = 12;
  static constexpr int MIN_CTAS = 1;  // E = 8: 1024 threads, 64 registers; E = 16: 512, 128
  static __device__ __forceinline__ T pad() { return T{~0ull, ~0u}; }  // INT32_MAX x 3
  static __device__ __forceinline__ T pack(int32_t a, int32_t b, int32_t c) {
    return T{((u64)flip(a) << 32) | (u64)flip(b), flip(c)};
  }
  static __device__ __forceinline__ T load(const Ptrs& p, size_t i) {
    return pack(p.k[0][i], p.k[1][i], p.k[2][i]);
  }
  static __device__ __forceinline__ T ldg(const Ptrs& p, size_t row, int c) {
    return pack(__ldg(p.k[0] + row + c), __ldg(p.k[1] + row + c), __ldg(p.k[2] + row + c));
  }
  static __device__ __forceinline__ void ldg4(const Ptrs& p, size_t row, int c, int q, T& v0,
                                              T& v1, T& v2, T& v3) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p.k[0] + row + c) + q);
    const int4 y = __ldg(reinterpret_cast<const int4*>(p.k[1] + row + c) + q);
    const int4 z = __ldg(reinterpret_cast<const int4*>(p.k[2] + row + c) + q);
    v0 = pack(x.x, y.x, z.x);
    v1 = pack(x.y, y.y, z.y);
    v2 = pack(x.z, y.z, z.z);
    v3 = pack(x.w, y.w, z.w);
  }
  static __device__ __forceinline__ void store(const T& v, const Ptrs& p, size_t row, int c) {
    p.o[0][row + c] = unflip((uint32_t)(v.hi >> 32));
    p.o[1][row + c] = unflip((uint32_t)(v.hi & 0xFFFFFFFFull));
    p.o[2][row + c] = unflip(v.lo);
  }
  static __device__ __forceinline__ void store4(const T& v0, const T& v1, const T& v2,
                                                const T& v3, const Ptrs& p, size_t row, int c,
                                                int q) {
    reinterpret_cast<int4*>(p.o[0] + row + c)[q] =
        make_int4(unflip((uint32_t)(v0.hi >> 32)), unflip((uint32_t)(v1.hi >> 32)),
                  unflip((uint32_t)(v2.hi >> 32)), unflip((uint32_t)(v3.hi >> 32)));
    reinterpret_cast<int4*>(p.o[1] + row + c)[q] =
        make_int4(unflip((uint32_t)v0.hi), unflip((uint32_t)v1.hi), unflip((uint32_t)v2.hi),
                  unflip((uint32_t)v3.hi));
    reinterpret_cast<int4*>(p.o[2] + row + c)[q] =
        make_int4(unflip(v0.lo), unflip(v1.lo), unflip(v2.lo), unflip(v3.lo));
  }
  static __device__ __forceinline__ bool less(const T& a, const T& b) {
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo));  // no branch
  }
  static __device__ __forceinline__ T shfl_xor(const T& v, int lm) {
    return T{__shfl_xor_sync(FULL, v.hi, lm), __shfl_xor_sync(FULL, v.lo, lm)};
  }
  // Two arrays, not one 16-byte struct: n swizzled u64 slots for hi, then
  // n swizzled u32 slots for lo.
  struct Slots {
    u64* hi;
    uint32_t* lo;
    __device__ __forceinline__ Slots(unsigned char* raw, int n)
        : hi(reinterpret_cast<u64*>(raw)), lo(reinterpret_cast<uint32_t*>(raw + 8 * (size_t)n)) {}
    __device__ __forceinline__ Slots(u64* h, uint32_t* l) : hi(h), lo(l) {}
    __device__ __forceinline__ void put(int i, const T& v) const {
      hi[swz(i)] = v.hi;
      lo[swz32(i)] = v.lo;
    }
    __device__ __forceinline__ T get(int i) const { return T{hi[swz(i)], lo[swz32(i)]}; }
    __device__ __forceinline__ Slots remote(cg::cluster_group& c, int rank) const {
      return Slots(c.map_shared_rank(hi, rank), c.map_shared_rank(lo, rank));
    }
  };
};

// --- the register network ------------------------------------------------------

// Orders (a, b) ascending where `asc`, else descending: one compare and
// two selects.
template <class K>
__device__ __forceinline__ void exchange(typename K::T& a, typename K::T& b, bool asc) {
  const bool swap = K::less(b, a) == asc;
  const typename K::T x = a;
  a = swap ? b : a;
  b = swap ? x : b;
}

// Loads E consecutive keys of a row from column c0 (padding past m).
template <class K, int E>
__device__ __forceinline__ void load_keys(const Ptrs& p, size_t row_off, int m, int c0, bool vec,
                                          typename K::T (&v)[E]) {
  if (E % 4 == 0 && vec && c0 + E <= m) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      K::ldg4(p, row_off, c0, q, v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = c0 + e;
    v[e] = c < m ? K::ldg(p, row_off, c) : K::pad();
  }
}

// Stores E consecutive sorted keys from column c0 (only columns < m).
template <class K, int E>
__device__ __forceinline__ void store_keys(const Ptrs& p, size_t row_off, int m, int c0, bool vec,
                                           const typename K::T (&v)[E]) {
  if (E % 4 == 0 && vec && c0 + E <= m) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      K::store4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3], p, row_off, c0, q);
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = c0 + e;
    if (c < m) K::store(v[e], p, row_off, c);
  }
}

// The stages of a merge of size k whose stride is below 32E: shuffles, then
// registers.  `base` is the row index of v[0]; `lane` the thread's lane.
// A pair (i, i + j) sorts ascending where (i & k) == 0; the lower index
// keeps the minimum of an ascending pair.
template <class K, int E>
__device__ __forceinline__ void warp_stages(typename K::T (&v)[E], int base, int lane, int k) {
  for (int j = (k / 2 < 16 * E ? k / 2 : 16 * E); j >= E; j >>= 1) {
    // k > j >= E: the direction bit lies above the register bits.
    const int lm = j / E;
    const bool keep_min = ((lane & lm) == 0) == ((base & k) == 0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const typename K::T o = K::shfl_xor(v[e], lm);
      v[e] = K::less(o, v[e]) == keep_min ? o : v[e];
    }
  }
#pragma unroll
  for (int j = E / 2; j >= 1; j >>= 1) {
    if (j < k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & j) == 0) exchange<K>(v[e], v[e | j], ((base + e) & k) == 0);
      }
    }
  }
}

// One warp per row (mp = 32E), WARP_ROWS rows per CTA.
template <class K, int E>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    sort_warp_kernel(Ptrs p, int rows, int m, bool vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only: no barrier in this kernel
  const size_t row_off = (size_t)row * (size_t)m;
  const int base = lane * E;
  typename K::T v[E];
  load_keys<K, E>(p, row_off, m, base, vec, v);
  for (int k = 2; k <= 32 * E; k <<= 1) warp_stages<K, E>(v, base, lane, k);
  store_keys<K, E>(p, row_off, m, base, vec, v);
}

// Writes the registers to shared memory in the blocked layout.
template <class K, int E>
__device__ __forceinline__ void regs_to_smem(const typename K::Slots& s, int t,
                                             const typename K::T (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) s.put(t * E + e, v[e]);
}

template <class K, int E>
__device__ __forceinline__ void smem_to_regs(const typename K::Slots& s, int t,
                                             typename K::T (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = s.get(t * E + e);
}

// A CTA of T = blockDim.x threads holds n = T * E consecutive keys of a
// row; with CLUSTER > 1 the row is CLUSTER CTAs' parts (rank r holds
// [r*n, (r+1)*n)) and the strides >= n run through distributed shared
// memory.  Dynamic shared memory: n keys.  The launch bounds cap the
// registers: Key2 at E = 16, 64 a thread (two 512-thread CTAs an SM);
// Key3 at E = 8, 64 (1024 threads), at E = 16, 128 (512 threads).
template <class K, int E, int CLUSTER>
__global__ void __launch_bounds__(CTA_MAX / E, K::MIN_CTAS)
    sort_cta_kernel(Ptrs p, int rows, int m, bool vec) {
  typedef typename K::T T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int n = blockDim.x * E;
  const typename K::Slots s(smem_raw, n);
  const int rank = CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row = blockIdx.x / CLUSTER;
  const int mp = n * CLUSTER;
  const size_t row_off = (size_t)row * (size_t)m;
  const int base = rank * n + t * E;  // row index of v[0]
  (void)rows;

  T v[E];
  load_keys<K, E>(p, row_off, m, base, vec, v);
  for (int k = 2; k <= mp; k <<= 1) {
    int j = k / 2;
#pragma unroll
    for (int d = CLUSTER / 2; d >= 1; d /= 2) {
      if (j < d * n) continue;
      // The stride d*n crosses CTAs: the partner is rank ^ d, and the
      // lower rank of an ascending pair keeps the minima.  In a pair of
      // CTAs the one such stride is the last merge's (ascending).  Each
      // warp reads 32 consecutive slots of the partner (element t + r T),
      // and the registers come back in the blocked layout afterwards.
      cg::cluster_group cluster = cg::this_cluster();
      __syncthreads();  // earlier shared-memory reads are done
      regs_to_smem<K, E>(s, t, v);
      cluster.sync();
      const typename K::Slots o = s.remote(cluster, rank ^ d);
      const bool keep_min =
          CLUSTER == 2 ? rank == 0 : ((rank & d) == 0) == (((rank * n) & k) == 0);
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int i = t + r * blockDim.x;
        const T x = o.get(i), y = s.get(i);
        v[r] = K::less(x, y) == keep_min ? x : y;
      }
      cluster.sync();  // the partner has read this CTA's keys
#pragma unroll
      for (int r = 0; r < E; ++r) s.put(t + r * blockDim.x, v[r]);
      __syncthreads();
      smem_to_regs<K, E>(s, t, v);
      j >>= 1;
    }
    if (j >= 32 * E) {
      __syncthreads();  // earlier shared-memory reads are done
      regs_to_smem<K, E>(s, t, v);
      __syncthreads();
      for (; j >= 64 * E; j >>= 2) {
        // Two strides per barrier: n/4 quadruples (b, b + j/2, b + j,
        // b + 3j/2), E/4 per thread, exchanged at stride j, then j/2.
#pragma unroll
        for (int r = 0; r < E / 4; ++r) {
          const int q = t + r * blockDim.x;
          const int h = j / 2;
          const int b = 2 * j * (q / h) + (q % h);
          const bool asc = ((rank * n + b) & k) == 0;
          T x0 = s.get(b), x1 = s.get(b + h), x2 = s.get(b + j), x3 = s.get(b + j + h);
          exchange<K>(x0, x2, asc);
          exchange<K>(x1, x3, asc);
          exchange<K>(x0, x1, asc);
          exchange<K>(x2, x3, asc);
          s.put(b, x0);
          s.put(b + h, x1);
          s.put(b + j, x2);
          s.put(b + j + h, x3);
        }
        __syncthreads();
      }
      if (j >= 32 * E) {
        // One stride left: n/2 pairs, E/2 per thread; consecutive threads
        // take consecutive pairs (consecutive slots).
#pragma unroll
        for (int r = 0; r < E / 2; ++r) {
          const int q = t + r * blockDim.x;
          const int lo = 2 * j * (q / j) + (q % j);
          T a = s.get(lo), b = s.get(lo + j);
          exchange<K>(a, b, ((rank * n + lo) & k) == 0);
          s.put(lo, a);
          s.put(lo + j, b);
        }
        __syncthreads();
        j >>= 1;
      }
      smem_to_regs<K, E>(s, t, v);
    }
    warp_stages<K, E>(v, base, lane, k);
  }
  store_keys<K, E>(p, row_off, m, base, vec, v);
}

// --- the shared-memory network (sort2 above 16384 keys, sort3 above 32768) -----

// One compare-exchange of a bitonic stage: pair i of the row, where the
// partner distance is `stride` and the sort direction flips every `size`
// elements of the GLOBAL row index (gbase + local index).
__device__ __forceinline__ void pair_index(int i, int stride, int* lo, int* hi) {
  *lo = 2 * stride * (i / stride) + (i % stride);
  *hi = *lo + stride;
}

// Sorts (or merges) one tile of `tile` elements in shared memory.  Stages
// run for size = size_first .. size_last (powers of two), strides from
// min(size, tile) / 2 down to 1.  LOAD_KEYS reads the int32 keys (with
// padding past m) instead of the packed buffer; STORE_KEYS writes the
// unpacked keys (only the first m columns) instead of the packed buffer.
template <class K, bool LOAD_KEYS, bool STORE_KEYS>
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_tile_kernel(Ptrs p, typename K::T* __restrict__ buf, int m, int mp, int tile,
                    int size_first, int size_last) {
  using T = typename K::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int row = blockIdx.y;
  const int gbase = blockIdx.x * tile;
  const size_t key_row = (size_t)row * (size_t)m;
  const size_t buf_row = (size_t)row * (size_t)mp;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int g = gbase + i;
    if (LOAD_KEYS) {
      s[i] = g < m ? K::load(p, key_row + g) : K::pad();
    } else {
      s[i] = buf[buf_row + g];
    }
  }
  __syncthreads();

  const int half = tile / 2;
  for (int size = size_first; size <= size_last; size <<= 1) {
    const int first_stride = (size < tile ? size : tile) / 2;
    for (int stride = first_stride; stride >= 1; stride >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        int lo, hi;
        pair_index(i, stride, &lo, &hi);
        const bool asc = ((gbase + lo) & size) == 0;
        const T a = s[lo], b = s[hi];
        if (K::less(b, a) == asc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int g = gbase + i;
    if (STORE_KEYS) {
      if (g < m) K::store(s[i], p, key_row, g);
    } else {
      buf[buf_row + g] = s[i];
    }
  }
}

// One global-memory bitonic stage (stride >= K::TILE) over every row.
template <class K>
__global__ void bitonic_global_step(typename K::T* __restrict__ buf, int rows, int mp,
                                    int size, int stride) {
  using T = typename K::T;
  const long long pairs_per_row = mp / 2;
  const long long total = (long long)rows * pairs_per_row;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(t / pairs_per_row);
    const int i = (int)(t % pairs_per_row);
    int lo, hi;
    pair_index(i, stride, &lo, &hi);
    const bool asc = (lo & size) == 0;
    T* r = buf + (size_t)row * (size_t)mp;
    const T a = r[lo], b = r[hi];
    if (K::less(b, a) == asc) {
      r[lo] = b;
      r[hi] = a;
    }
  }
}

// --- launch -------------------------------------------------------------------

std::mutex attr_mu;

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device the first time; `done` is the kernel's own record.
template <class F>
cudaError_t smem_limit_once(bool (&done)[MAX_DEVICES], F* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(attr_mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <class K, bool L, bool S>
cudaError_t launch_tile(const Ptrs& p, typename K::T* buf, int rows, int m, int mp, int tile,
                        int size_first, int size_last, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  const int smem = tile * (int)sizeof(typename K::T);
  cudaError_t err = smem_limit_once(done, bitonic_tile_kernel<K, L, S>,
                                    K::TILE * (int)sizeof(typename K::T));
  if (err != cudaSuccess) return err;
  const int threads = tile / 2 < SORT_THREADS ? tile / 2 : SORT_THREADS;
  dim3 grid(mp / tile, rows);
  bitonic_tile_kernel<K, L, S><<<grid, threads, smem, stream>>>(p, buf, m, mp, tile, size_first,
                                                                 size_last);
  return cudaGetLastError();
}

// Sorts each row of p.k [rows, m] into p.o [rows, m] with the shared-memory
// network.  mp is m rounded up to a power of two, above K::TILE; `scratch`
// holds rows*mp elements.
template <class K>
int sort_rows(const Ptrs& p, typename K::T* scratch, int rows, int m, int mp,
              cudaStream_t stream) {
  if (mp <= K::TILE || scratch == nullptr) return (int)cudaErrorInvalidValue;
  // Pack and sort every tile with the global network's directions.
  cudaError_t err =
      launch_tile<K, true, false>(p, scratch, rows, m, mp, K::TILE, 2, K::TILE, stream);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)rows * (mp / 2);
  const int threads = 256;
  long long blocks = (pairs + threads - 1) / threads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  for (int size = 2 * K::TILE; size <= mp; size <<= 1) {
    for (int stride = size / 2; stride >= K::TILE; stride >>= 1) {
      bitonic_global_step<K><<<(unsigned)blocks, threads, 0, stream>>>(scratch, rows, mp, size,
                                                                       stride);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (size == mp) {
      err = launch_tile<K, false, true>(p, scratch, rows, m, mp, K::TILE, size, size, stream);
    } else {
      err = launch_tile<K, false, false>(p, scratch, rows, m, mp, K::TILE, size, size, stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// A row's layout in the register network (ops/sort.py's SortGeometry):
// `keys` a thread (E), `threads` a row in one CTA, `ctas` a row, and
// `rows_per_cta` (WARP_ROWS for the warp path, else 1).
struct Geo {
  int keys, threads, ctas, rows_per_cta;
};

// Whether g tiles a padded row of mp keys (rows below 64 keys take the
// 64-key warp layout).
bool tiles(const Geo& g, int mp) {
  const long long width = (long long)g.keys * g.threads * g.ctas;
  if (width < mp || (width != mp && width > 64)) return false;
  if (g.rows_per_cta == WARP_ROWS) return g.threads == 32 && g.ctas == 1;
  return g.rows_per_cta == 1 && g.threads >= 32 && g.threads % 32 == 0 &&
         (long long)g.threads * g.keys <= CTA_MAX;
}

template <class K, int E>
cudaError_t launch_warp(const Ptrs& p, int rows, int m, bool vec, cudaStream_t stream) {
  sort_warp_kernel<K, E><<<(rows + WARP_ROWS - 1) / WARP_ROWS, 32 * WARP_ROWS, 0, stream>>>(
      p, rows, m, vec);
  return cudaGetLastError();
}

// The launch of sort_cta_kernel<K, E, CLUSTER> on `rows` rows (`attr`
// holds its cluster dimension), its shared-memory limit raised.
template <class K, int E, int CLUSTER>
cudaError_t cta_config(int rows, int threads, cudaStream_t stream, cudaLaunchAttribute* attr,
                       cudaLaunchConfig_t* cfg) {
  static bool done[MAX_DEVICES] = {};
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CLUSTER * rows);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = threads * E * K::SMEM_BYTES;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = CLUSTER > 1 ? 1 : 0;
  return smem_limit_once(done, sort_cta_kernel<K, E, CLUSTER>, CTA_MAX * K::SMEM_BYTES);
}

template <class K, int E, int CLUSTER>
cudaError_t launch_cta(const Ptrs& p, int rows, int m, int threads, bool vec,
                       cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cta_config<K, E, CLUSTER>(rows, threads, stream, &attr, &cfg);
  if (err != cudaSuccess) return err;
  if (CLUSTER == 1) {
    sort_cta_kernel<K, E, CLUSTER><<<cfg.gridDim, cfg.blockDim, cfg.dynamicSmemBytes, stream>>>(
        p, rows, m, vec);
    return cudaGetLastError();
  }
  err = cudaLaunchKernelEx(&cfg, sort_cta_kernel<K, E, CLUSTER>, p, rows, m, vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

#ifdef TB_SORT_SWEEP
// The most clusters (CTAs where CLUSTER is 1) of sort3's layout the card
// holds at once: the sweep prints it beside the layout's time.
template <int E, int CLUSTER>
int max_clusters(int threads) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cta_config<Key3, E, CLUSTER>(1024, threads, 0, &attr, &cfg);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, sort_cta_kernel<Key3, E, CLUSTER>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}
#endif

// sort2's variants: one warp a row up to 1024 keys (E = mp / 32), one CTA
// of E = 16 up to 8192, a 2-CTA cluster at 16384.
cudaError_t sort2_registers(const Ptrs& p, int rows, int m, const Geo& g, bool vec,
                            cudaStream_t s) {
  if (g.rows_per_cta == WARP_ROWS) {
    switch (g.keys) {
      case 2: return launch_warp<Key2, 2>(p, rows, m, vec, s);
      case 4: return launch_warp<Key2, 4>(p, rows, m, vec, s);
      case 8: return launch_warp<Key2, 8>(p, rows, m, vec, s);
      case 16: return launch_warp<Key2, 16>(p, rows, m, vec, s);
      case 32: return launch_warp<Key2, 32>(p, rows, m, vec, s);
    }
  } else if (g.keys == 16) {
    if (g.ctas == 1) return launch_cta<Key2, 16, 1>(p, rows, m, g.threads, vec, s);
    if (g.ctas == 2) return launch_cta<Key2, 16, 2>(p, rows, m, g.threads, vec, s);
  }
  return cudaErrorInvalidValue;
}

// sort3's variants (the sweep's choice, ops/sort.py `sort_geometry`): one
// warp a row up to 128 keys, one CTA of E = 8 to 1024, 2-CTA clusters of
// E = 8 to 8192, of E = 16 at 16384, 4-CTA clusters of E = 16 at 32768.
// The sweep build adds the warp path at 256 .. 1024 keys, one E = 16 CTA
// and 4-CTA clusters of E = 8.
cudaError_t sort3_registers(const Ptrs& p, int rows, int m, const Geo& g, bool vec,
                            cudaStream_t s) {
  if (g.rows_per_cta == WARP_ROWS) {
    switch (g.keys) {
      case 2: return launch_warp<Key3, 2>(p, rows, m, vec, s);
      case 4: return launch_warp<Key3, 4>(p, rows, m, vec, s);
#ifdef TB_SORT_SWEEP
      case 8: return launch_warp<Key3, 8>(p, rows, m, vec, s);
      case 16: return launch_warp<Key3, 16>(p, rows, m, vec, s);
      case 32: return launch_warp<Key3, 32>(p, rows, m, vec, s);
#endif
    }
  } else if (g.keys == 8) {
    if (g.ctas == 1) return launch_cta<Key3, 8, 1>(p, rows, m, g.threads, vec, s);
    if (g.ctas == 2) return launch_cta<Key3, 8, 2>(p, rows, m, g.threads, vec, s);
#ifdef TB_SORT_SWEEP
    if (g.ctas == 4) return launch_cta<Key3, 8, 4>(p, rows, m, g.threads, vec, s);
#endif
  } else if (g.keys == 16) {
#ifdef TB_SORT_SWEEP
    if (g.ctas == 1) return launch_cta<Key3, 16, 1>(p, rows, m, g.threads, vec, s);
#endif
    if (g.ctas == 2) return launch_cta<Key3, 16, 2>(p, rows, m, g.threads, vec, s);
    if (g.ctas == 4) return launch_cta<Key3, 16, 4>(p, rows, m, g.threads, vec, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* x) { return ((uintptr_t)x & 15u) == 0; }

bool bad_shape(int rows, int m, int mp) {
  return mp < 2 || (mp & (mp - 1)) != 0 || mp < m || rows > 65535 || (mp >= 2 * m && mp > 2);
}

}  // namespace

extern "C" {

// Sorts each row of (k1, k2) [rows, m] into (o1, o2).  mp is m rounded up
// to a power of two (>= 2).  (keys, threads, ctas, rows_per_cta) is the
// register network's layout of a row, or keys = 0 for the shared-memory
// network, which needs `scratch` (rows*mp u64) and mp > 16384.  Returns the
// first CUDA error, or 0.
int tb_sort2(const int32_t* k1, const int32_t* k2, int32_t* o1, int32_t* o2, void* scratch,
             int rows, int m, int mp, int keys, int threads, int ctas, int rows_per_cta,
             cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (bad_shape(rows, m, mp)) return (int)cudaErrorInvalidValue;
  const Ptrs p = {{k1, k2, nullptr}, {o1, o2, nullptr}};
  if (keys == 0) return sort_rows<Key2>(p, static_cast<Key2::T*>(scratch), rows, m, mp, stream);
  const Geo g = {keys, threads, ctas, rows_per_cta};
  if (!tiles(g, mp)) return (int)cudaErrorInvalidValue;
  const bool vec =
      m % 4 == 0 && aligned16(k1) && aligned16(k2) && aligned16(o1) && aligned16(o2);
  return (int)sort2_registers(p, rows, m, g, vec, stream);
}

// Sorts each row of (k1, k2, k3) [rows, m] into (o1, o2, o3); the layout
// as for tb_sort2, keys = 0 (mp > 8192) taking `scratch` (rows*mp 16-byte
// elements).
int tb_sort3(const int32_t* k1, const int32_t* k2, const int32_t* k3, int32_t* o1, int32_t* o2,
             int32_t* o3, void* scratch, int rows, int m, int mp, int keys, int threads,
             int ctas, int rows_per_cta, cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (bad_shape(rows, m, mp)) return (int)cudaErrorInvalidValue;
  const Ptrs p = {{k1, k2, k3}, {o1, o2, o3}};
  if (keys == 0) return sort_rows<Key3>(p, static_cast<Key3::T*>(scratch), rows, m, mp, stream);
  const Geo g = {keys, threads, ctas, rows_per_cta};
  if (!tiles(g, mp)) return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && aligned16(k1) && aligned16(k2) && aligned16(k3) &&
                   aligned16(o1) && aligned16(o2) && aligned16(o3);
  return (int)sort3_registers(p, rows, m, g, vec, stream);
}

#ifdef TB_SORT_SWEEP
int tb_sort3_max_clusters(int keys, int threads, int ctas) {
  switch (keys * 8 + ctas) {
    case 8 * 8 + 1: return max_clusters<8, 1>(threads);
    case 8 * 8 + 2: return max_clusters<8, 2>(threads);
    case 8 * 8 + 4: return max_clusters<8, 4>(threads);
    case 16 * 8 + 1: return max_clusters<16, 1>(threads);
    case 16 * 8 + 2: return max_clusters<16, 2>(threads);
    case 16 * 8 + 4: return max_clusters<16, 4>(threads);
  }
  return -(int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
