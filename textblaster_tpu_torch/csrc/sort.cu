// Row-wise ascending lexicographic sort of int32 key pairs (sort2) and key
// triples (sort3) for Hopper (sm_90a): one bitonic network over packed keys.
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
// (`lax.sort(num_keys=3)`).  Equal elements are equal triples, so the
// network being unstable changes no output.
//
// Widths: a row of mp (a power of two) packed keys is sorted by one CTA in
// shared memory while mp <= K::TILE (sort2 16384, sort3 8192: 128 KiB of
// dynamic shared memory either way).  Wider rows first sort each K::TILE
// tile in shared memory with the global network's directions, then run each
// stage whose stride is at least K::TILE as a global-memory pass over a
// packed scratch buffer, and finish every merge's small strides tile by tile
// in shared memory.  Rows of real width m < mp are padded with the element
// of INT32_MAX keys, which sorts last.
//
// Bound: memory.  At least 8*K::N*rows*m bytes cross HBM (the keys in and
// out); the network does about rows*m*log2(m)^2/4 compare-exchanges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int SORT_THREADS = 1024;

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
  static __device__ T pad() { return 0xFFFFFFFF7FFFFFFFull; }  // (INT32_MAX, INT32_MAX)
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

template <class K, bool L, bool S>
cudaError_t launch_tile(const Ptrs& p, typename K::T* buf, int rows, int m, int mp, int tile,
                        int size_first, int size_last, cudaStream_t stream) {
  const int smem = tile * (int)sizeof(typename K::T);
  cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel<K, L, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         K::TILE * (int)sizeof(typename K::T));
  if (err != cudaSuccess) return err;
  const int threads = tile / 2 < SORT_THREADS ? tile / 2 : SORT_THREADS;
  dim3 grid(mp / tile, rows);
  bitonic_tile_kernel<K, L, S><<<grid, threads, smem, stream>>>(p, buf, m, mp, tile, size_first,
                                                                 size_last);
  return cudaGetLastError();
}

// Sorts each row of p.k [rows, m] into p.o [rows, m].  mp is m rounded up to
// a power of two (>= 2); `scratch` holds rows*mp elements and is used only
// when mp > K::TILE.  Returns the first CUDA error, or 0.
template <class K>
int sort_rows(const Ptrs& p, typename K::T* scratch, int rows, int m, int mp,
              cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (mp < 2 || (mp & (mp - 1)) != 0 || mp < m || rows > 65535)
    return (int)cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// Sorts each row of (k1, k2) [rows, m] into (o1, o2).  `scratch`: rows*mp
// u64 when mp > 16384, else unused.
int tb_sort2(const int32_t* k1, const int32_t* k2, int32_t* o1, int32_t* o2, void* scratch,
             int rows, int m, int mp, cudaStream_t stream) {
  const Ptrs p = {{k1, k2, nullptr}, {o1, o2, nullptr}};
  return sort_rows<Key2>(p, static_cast<Key2::T*>(scratch), rows, m, mp, stream);
}

// Sorts each row of (k1, k2, k3) [rows, m] into (o1, o2, o3).  `scratch`:
// rows*mp 16-byte elements when mp > 8192, else unused.
int tb_sort3(const int32_t* k1, const int32_t* k2, const int32_t* k3, int32_t* o1, int32_t* o2,
             int32_t* o3, void* scratch, int rows, int m, int mp, cudaStream_t stream) {
  const Ptrs p = {{k1, k2, k3}, {o1, o2, o3}};
  return sort_rows<Key3>(p, static_cast<Key3::T*>(scratch), rows, m, mp, stream);
}

}  // extern "C"
