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
// (16 bytes per sort2 element), but a bitonic network does
// log2(mp)*(log2(mp)+1)/2 stages over every element: 105 at 16384.  A
// network held in shared memory pays a full shared-memory pass and a block
// barrier per stage, so it is bound by shared-memory traffic and barrier
// latency, 18-32x above the byte bound.
//
// sort2's network for mp <= 16384 (`sort2_warp_kernel`, `sort2_cta_kernel`)
// keeps the keys in registers.  Each thread holds E consecutive packed keys
// (a "blocked" layout: element i lives in thread i / E, register i % E):
//   * stages of stride < E compare registers of one thread: no memory, no
//     barrier;
//   * strides E .. 16E pair threads of one warp: __shfl_xor_sync;
//   * only strides >= 32E cross warps.  Those run in shared memory: the
//     CTA writes its registers out once per merge (an XOR swizzle on the low
//     four index bits keeps the 8-byte accesses of a half-warp on distinct
//     banks), runs the wide strides there two at a time (each thread
//     exchanges four keys between barriers), and reads its registers back.
//     At 16384 that is 14 of the 105 stages, in 8 steps.
// Rows of mp <= 1024 are sorted by one warp each (E = mp / 32, at least 2),
// four rows per CTA, with no block barrier.  Rows of 2048..8192 are one CTA
// of mp / 16 threads (E = 16, 16..64 KiB of shared memory, so several CTAs
// share an SM).  A 16384 row is a 2-CTA cluster: each CTA holds 8192 keys
// (64 KiB), and the one stride-8192 stage reads the partner CTA's keys
// through distributed shared memory between two cluster barriers.
//
// Wider rows (mp > 16384; off the default path, where the tables use
// scatter) and every sort3 keep the earlier shared-memory network
// (`bitonic_tile_kernel`): sort each tile in shared memory with the global
// network's directions, run each stage whose stride is at least the tile as
// a global-memory pass over a packed scratch buffer, and finish every
// merge's small strides tile by tile.
//
// The shared-memory attributes are set once per process and device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int SORT_THREADS = 1024;
// sort2's register network: keys per thread in a CTA, rows per CTA in the
// warp path, the widest row a CTA or a cluster sorts.
constexpr int CTA_E = 16;
constexpr int WARP_ROWS = 4;
constexpr int CTA_MAX = 8192;
constexpr int REG_MAX = 16384;
constexpr u64 PAD2 = 0xFFFFFFFF7FFFFFFFull;  // (INT32_MAX, INT32_MAX)

__device__ __forceinline__ uint32_t flip(int32_t k) { return (uint32_t)k ^ 0x80000000u; }
__device__ __forceinline__ int32_t unflip(uint32_t v) { return (int32_t)(v ^ 0x80000000u); }

struct Ptrs {
  const int32_t* k[3];
  int32_t* o[3];
};

struct Key2 {
  typedef u64 T;
  static constexpr int N = 2;
  static constexpr int TILE = 16384;
  static __device__ T pad() { return PAD2; }
  static __device__ T load(const Ptrs& p, size_t i) {
    return ((u64)flip(p.k[0][i]) << 32) | (u64)(uint32_t)p.k[1][i];
  }
  static __device__ void store(const T& v, const Ptrs& p, size_t i) {
    p.o[0][i] = unflip((uint32_t)(v >> 32));
    p.o[1][i] = (int32_t)(uint32_t)(v & 0xFFFFFFFFull);
  }
  static __device__ bool gt(const T& a, const T& b) { return a > b; }
};

struct Key3 {
  struct T {
    u64 hi;
    uint32_t lo;
  };
  static constexpr int N = 3;
  static constexpr int TILE = 8192;
  static __device__ T pad() { return T{~0ull, ~0u}; }  // (INT32_MAX, INT32_MAX, INT32_MAX)
  static __device__ T load(const Ptrs& p, size_t i) {
    return T{((u64)flip(p.k[0][i]) << 32) | (u64)flip(p.k[1][i]), flip(p.k[2][i])};
  }
  static __device__ void store(const T& v, const Ptrs& p, size_t i) {
    p.o[0][i] = unflip((uint32_t)(v.hi >> 32));
    p.o[1][i] = unflip((uint32_t)(v.hi & 0xFFFFFFFFull));
    p.o[2][i] = unflip(v.lo);
  }
  static __device__ bool gt(const T& a, const T& b) {
    return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
  }
};

// --- sort2: the register network ---------------------------------------------

// Orders (a, b) ascending where `asc`, else descending: one 64-bit compare
// and two selects.
__device__ __forceinline__ void exchange(u64& a, u64& b, bool asc) {
  const bool swap = (a > b) == asc;
  const u64 x = a;
  a = swap ? b : a;
  b = swap ? x : b;
}

// Shared-memory slot of element i: the low four index bits XOR the next
// four, so that the 16 threads of a half-warp that write register e of 16
// consecutive threads (i = 16t + e) hit 16 distinct 8-byte bank pairs, as
// do 16 consecutive elements.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

// Loads E consecutive keys of a row from column c0 (padding past m).
template <int E>
__device__ __forceinline__ void load_keys(const Ptrs& p, size_t row_off, int m, int c0, bool vec,
                                          u64 (&v)[E]) {
  if (E % 4 == 0 && vec && c0 + E <= m) {
    const int4* a = reinterpret_cast<const int4*>(p.k[0] + row_off + c0);
    const int4* b = reinterpret_cast<const int4*>(p.k[1] + row_off + c0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int4 x = __ldg(a + q), y = __ldg(b + q);
      v[4 * q + 0] = ((u64)flip(x.x) << 32) | (uint32_t)y.x;
      v[4 * q + 1] = ((u64)flip(x.y) << 32) | (uint32_t)y.y;
      v[4 * q + 2] = ((u64)flip(x.z) << 32) | (uint32_t)y.z;
      v[4 * q + 3] = ((u64)flip(x.w) << 32) | (uint32_t)y.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = c0 + e;
    v[e] = c < m ? ((u64)flip(__ldg(p.k[0] + row_off + c)) << 32) |
                       (uint32_t)__ldg(p.k[1] + row_off + c)
                 : PAD2;
  }
}

// Stores E consecutive sorted keys from column c0 (only columns < m).
template <int E>
__device__ __forceinline__ void store_keys(const Ptrs& p, size_t row_off, int m, int c0, bool vec,
                                           const u64 (&v)[E]) {
  if (E % 4 == 0 && vec && c0 + E <= m) {
    int4* a = reinterpret_cast<int4*>(p.o[0] + row_off + c0);
    int4* b = reinterpret_cast<int4*>(p.o[1] + row_off + c0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      a[q] = make_int4(unflip((uint32_t)(v[4 * q] >> 32)), unflip((uint32_t)(v[4 * q + 1] >> 32)),
                       unflip((uint32_t)(v[4 * q + 2] >> 32)),
                       unflip((uint32_t)(v[4 * q + 3] >> 32)));
      b[q] = make_int4((int32_t)(uint32_t)v[4 * q], (int32_t)(uint32_t)v[4 * q + 1],
                       (int32_t)(uint32_t)v[4 * q + 2], (int32_t)(uint32_t)v[4 * q + 3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = c0 + e;
    if (c < m) {
      p.o[0][row_off + c] = unflip((uint32_t)(v[e] >> 32));
      p.o[1][row_off + c] = (int32_t)(uint32_t)v[e];
    }
  }
}

// The stages of a merge of size k whose stride is below 32E: shuffles, then
// registers.  `base` is the row index of v[0]; `lane` the thread's lane.
// A pair (i, i + j) sorts ascending where (i & k) == 0; the lower index
// keeps the minimum of an ascending pair.
template <int E>
__device__ __forceinline__ void warp_stages(u64 (&v)[E], int base, int lane, int k) {
  for (int j = (k / 2 < 16 * E ? k / 2 : 16 * E); j >= E; j >>= 1) {
    // k > j >= E: the direction bit lies above the register bits.
    const int lm = j / E;
    const bool keep_min = ((lane & lm) == 0) == ((base & k) == 0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const u64 o = __shfl_xor_sync(FULL, v[e], lm);
      v[e] = (o < v[e]) == keep_min ? o : v[e];
    }
  }
#pragma unroll
  for (int j = E / 2; j >= 1; j >>= 1) {
    if (j < k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & j) == 0) exchange(v[e], v[e | j], ((base + e) & k) == 0);
      }
    }
  }
}

// One warp per row (mp = 32E <= 1024), WARP_ROWS rows per CTA.
template <int E>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    sort2_warp_kernel(Ptrs p, int rows, int m, bool vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only: no barrier in this kernel
  const size_t row_off = (size_t)row * (size_t)m;
  const int base = lane * E;
  u64 v[E];
  load_keys<E>(p, row_off, m, base, vec, v);
  for (int k = 2; k <= 32 * E; k <<= 1) warp_stages<E>(v, base, lane, k);
  store_keys<E>(p, row_off, m, base, vec, v);
}

// Writes the registers to shared memory in the blocked layout.
__device__ __forceinline__ void regs_to_smem(u64* s, int t, const u64 (&v)[CTA_E]) {
#pragma unroll
  for (int e = 0; e < CTA_E; ++e) s[swz(t * CTA_E + e)] = v[e];
}

__device__ __forceinline__ void smem_to_regs(const u64* s, int t, u64 (&v)[CTA_E]) {
#pragma unroll
  for (int e = 0; e < CTA_E; ++e) v[e] = s[swz(t * CTA_E + e)];
}

// A CTA of T = blockDim.x threads holds n = T * CTA_E consecutive keys of a
// row; with CLUSTER == 2 the row is two CTAs' halves (rank r holds
// [r*n, (r+1)*n)) and the stride-n stage runs through distributed shared
// memory.  Dynamic shared memory: n keys.  Registers are held to 64 a
// thread, so that two CTAs of 512 threads share an SM.
template <int CLUSTER>
__global__ void __launch_bounds__(CTA_MAX / CTA_E, 2)
    sort2_cta_kernel(Ptrs p, int rows, int m, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* s = reinterpret_cast<u64*>(smem_raw);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int n = blockDim.x * CTA_E;
  const int rank = CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row = blockIdx.x / CLUSTER;
  const int mp = n * CLUSTER;
  const size_t row_off = (size_t)row * (size_t)m;
  const int base = rank * n + t * CTA_E;  // row index of v[0]
  (void)rows;

  u64 v[CTA_E];
  load_keys<CTA_E>(p, row_off, m, base, vec, v);
  for (int k = 2; k <= mp; k <<= 1) {
    int j = k / 2;
    if (CLUSTER > 1 && j >= n) {
      // The stride-n stage (k == mp: ascending): rank 0 keeps the minima.
      cg::cluster_group cluster = cg::this_cluster();
      __syncthreads();  // earlier shared-memory reads are done
      regs_to_smem(s, t, v);
      cluster.sync();
      const u64* o = cluster.map_shared_rank(s, rank ^ 1);
#pragma unroll
      for (int e = 0; e < CTA_E; ++e) {
        const u64 x = o[swz(t * CTA_E + e)];
        v[e] = (x < v[e]) == (rank == 0) ? x : v[e];
      }
      cluster.sync();  // the partner has read this CTA's keys
      j >>= 1;
    }
    if (j >= 32 * CTA_E) {
      __syncthreads();  // earlier shared-memory reads are done
      regs_to_smem(s, t, v);
      __syncthreads();
      for (; j >= 64 * CTA_E; j >>= 2) {
        // Two strides per barrier: n/4 quadruples (b, b + j/2, b + j,
        // b + 3j/2), CTA_E/4 per thread, exchanged at stride j, then j/2.
#pragma unroll
        for (int r = 0; r < CTA_E / 4; ++r) {
          const int q = t + r * blockDim.x;
          const int h = j / 2;
          const int b = 2 * j * (q / h) + (q % h);
          const bool asc = ((rank * n + b) & k) == 0;
          u64 x0 = s[swz(b)], x1 = s[swz(b + h)], x2 = s[swz(b + j)], x3 = s[swz(b + j + h)];
          exchange(x0, x2, asc);
          exchange(x1, x3, asc);
          exchange(x0, x1, asc);
          exchange(x2, x3, asc);
          s[swz(b)] = x0;
          s[swz(b + h)] = x1;
          s[swz(b + j)] = x2;
          s[swz(b + j + h)] = x3;
        }
        __syncthreads();
      }
      if (j >= 32 * CTA_E) {
        // One stride left: n/2 pairs, CTA_E/2 per thread; consecutive
        // threads take consecutive pairs (consecutive slots).
#pragma unroll
        for (int r = 0; r < CTA_E / 2; ++r) {
          const int q = t + r * blockDim.x;
          const int lo = 2 * j * (q / j) + (q % j);
          u64 a = s[swz(lo)], b = s[swz(lo + j)];
          exchange(a, b, ((rank * n + lo) & k) == 0);
          s[swz(lo)] = a;
          s[swz(lo + j)] = b;
        }
        __syncthreads();
        j >>= 1;
      }
      smem_to_regs(s, t, v);
    }
    warp_stages<CTA_E>(v, base, lane, k);
  }
  store_keys<CTA_E>(p, row_off, m, base, vec, v);
}

// --- the shared-memory network (sort3; sort2 above 16384) ----------------------

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
        if (K::gt(a, b) == asc) {
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
      if (g < m) K::store(s[i], p, key_row + g);
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
    if (K::gt(a, b) == asc) {
      r[lo] = b;
      r[hi] = a;
    }
  }
}

// --- launch -------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// Raises every kernel's dynamic shared-memory limit once per device.
cudaError_t set_attributes_once() {
  static std::mutex mu;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int tile2 = Key2::TILE * (int)sizeof(Key2::T), tile3 = Key3::TILE * (int)sizeof(Key3::T);
  const int cta = CTA_MAX * (int)sizeof(u64);
  const cudaError_t errs[] = {
      cudaFuncSetAttribute(sort2_cta_kernel<1>, a, cta),
      cudaFuncSetAttribute(sort2_cta_kernel<2>, a, cta),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key2, true, true>, a, tile2),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key2, true, false>, a, tile2),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key2, false, true>, a, tile2),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key2, false, false>, a, tile2),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key3, true, true>, a, tile3),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key3, true, false>, a, tile3),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key3, false, true>, a, tile3),
      cudaFuncSetAttribute(bitonic_tile_kernel<Key3, false, false>, a, tile3),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

template <class K, bool L, bool S>
cudaError_t launch_tile(const Ptrs& p, typename K::T* buf, int rows, int m, int mp, int tile,
                        int size_first, int size_last, cudaStream_t stream) {
  const int smem = tile * (int)sizeof(typename K::T);
  const int threads = tile / 2 < SORT_THREADS ? tile / 2 : SORT_THREADS;
  dim3 grid(mp / tile, rows);
  bitonic_tile_kernel<K, L, S><<<grid, threads, smem, stream>>>(p, buf, m, mp, tile, size_first,
                                                                 size_last);
  return cudaGetLastError();
}

// Sorts each row of p.k [rows, m] into p.o [rows, m] with the shared-memory
// network.  mp is m rounded up to a power of two (>= 2); `scratch` holds
// rows*mp elements and is used only when mp > K::TILE.
template <class K>
int sort_rows(const Ptrs& p, typename K::T* scratch, int rows, int m, int mp,
              cudaStream_t stream) {
  cudaError_t err;
  if (mp <= K::TILE) {
    return (int)launch_tile<K, true, true>(p, nullptr, rows, m, mp, mp, 2, mp, stream);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  // Pack and sort every tile with the global network's directions.
  err = launch_tile<K, true, false>(p, scratch, rows, m, mp, K::TILE, 2, K::TILE, stream);
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

template <int E>
cudaError_t launch_warp(const Ptrs& p, int rows, int m, bool vec, cudaStream_t stream) {
  sort2_warp_kernel<E><<<(rows + WARP_ROWS - 1) / WARP_ROWS, 32 * WARP_ROWS, 0, stream>>>(
      p, rows, m, vec);
  return cudaGetLastError();
}

// sort2's register network for mp <= REG_MAX: the geometry of ops/sort.py's
// sort2_geometry (keys per thread, threads per CTA, CTAs per row).
cudaError_t sort2_registers(const Ptrs& p, int rows, int m, int mp, bool vec,
                            cudaStream_t stream) {
  switch (mp <= 64 ? 64 : mp) {
    case 64: return launch_warp<2>(p, rows, m, vec, stream);
    case 128: return launch_warp<4>(p, rows, m, vec, stream);
    case 256: return launch_warp<8>(p, rows, m, vec, stream);
    case 512: return launch_warp<16>(p, rows, m, vec, stream);
    case 1024: return launch_warp<32>(p, rows, m, vec, stream);
    case 2048:
    case 4096:
    case CTA_MAX: {
      const int threads = mp / CTA_E;
      sort2_cta_kernel<1><<<rows, threads, mp * (int)sizeof(u64), stream>>>(p, rows, m, vec);
      return cudaGetLastError();
    }
    case REG_MAX: {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(2 * rows);
      cfg.blockDim = dim3(CTA_MAX / CTA_E);
      cfg.dynamicSmemBytes = CTA_MAX * sizeof(u64);
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 2;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t err = cudaLaunchKernelEx(&cfg, sort2_cta_kernel<2>, p, rows, m, vec);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* x) { return ((uintptr_t)x & 15u) == 0; }

}  // namespace

extern "C" {

// Sorts each row of (k1, k2) [rows, m] into (o1, o2).  mp is m rounded up
// to a power of two (>= 2).  `scratch`: rows*mp u64 when mp > 16384, else
// unused.  Returns the first CUDA error, or 0.
int tb_sort2(const int32_t* k1, const int32_t* k2, int32_t* o1, int32_t* o2, void* scratch,
             int rows, int m, int mp, cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (mp < 2 || (mp & (mp - 1)) != 0 || mp < m || rows > 65535 || (mp >= 2 * m && mp > 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes_once();
  if (err != cudaSuccess) return (int)err;
  const Ptrs p = {{k1, k2, nullptr}, {o1, o2, nullptr}};
  if (mp <= REG_MAX) {
    const bool vec = m % 4 == 0 && aligned16(k1) && aligned16(k2) && aligned16(o1) &&
                     aligned16(o2);
    return (int)sort2_registers(p, rows, m, mp, vec, stream);
  }
  return sort_rows<Key2>(p, static_cast<Key2::T*>(scratch), rows, m, mp, stream);
}

// Sorts each row of (k1, k2, k3) [rows, m] into (o1, o2, o3).  `scratch`:
// rows*mp 16-byte elements when mp > 8192, else unused.
int tb_sort3(const int32_t* k1, const int32_t* k2, const int32_t* k3, int32_t* o1, int32_t* o2,
             int32_t* o3, void* scratch, int rows, int m, int mp, cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (mp < 2 || (mp & (mp - 1)) != 0 || mp < m || rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes_once();
  if (err != cudaSuccess) return (int)err;
  const Ptrs p = {{k1, k2, k3}, {o1, o2, o3}};
  return sort_rows<Key3>(p, static_cast<Key3::T*>(scratch), rows, m, mp, stream);
}

}  // extern "C"
