// Row-wise ascending lexicographic sort of int32 (k1, k2) pairs for Hopper
// (sm_90a): a bitonic network over 64-bit packed keys.
//
// Replaces the Pallas bitonic sorter of the JAX package
// (textblaster_tpu/ops/pallas_sort.py, `_pallas_sort_n` + `_bitonic_kernel`,
// reached through `sort2`).
//
// Key packing: ((uint64)((uint32)k1 ^ 0x80000000) << 32) | (uint32)k2.  Its
// unsigned order is signed-k1-then-k2 for the non-negative payloads k2 that
// every caller passes, which is the order of both the TPU network and the
// JAX CPU path's packed int64 sort.  The sign flip is what keeps negative
// hashes first.
//
// Widths: a row of mp (a power of two) packed keys is sorted by one CTA in
// shared memory while 8*mp bytes fit the dynamic shared memory opted into
// below (mp <= SORT_TILE = 16384, 128 KiB).  Wider rows (32768, 65536) first
// sort each SORT_TILE tile in shared memory with the global network's
// directions, then run each stage whose stride is at least SORT_TILE as a
// global-memory pass over a packed scratch buffer, and finish every merge's
// small strides tile by tile in shared memory.  Rows of real width m < mp
// are padded with the (INT32_MAX, INT32_MAX) key, which sorts last.
//
// Bound: memory.  At least 16*rows*m bytes cross HBM (two int32 keys in,
// two out); the network does about rows*m*log2(m)^2/4 compare-exchanges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int SORT_TILE = 16384;
constexpr int SORT_THREADS = 1024;
constexpr u64 PAD_KEY = 0xFFFFFFFF7FFFFFFFull;  // pack(INT32_MAX, INT32_MAX)

__device__ __forceinline__ u64 pack(int32_t k1, int32_t k2) {
  return ((u64)((uint32_t)k1 ^ 0x80000000u) << 32) | (u64)(uint32_t)k2;
}

__device__ __forceinline__ void unpack(u64 v, int32_t* k1, int32_t* k2) {
  *k1 = (int32_t)((uint32_t)(v >> 32) ^ 0x80000000u);
  *k2 = (int32_t)(uint32_t)(v & 0xFFFFFFFFull);
}

// One compare-exchange of a bitonic stage: pair i of the row, where the
// partner distance is `stride` and the sort direction flips every `size`
// elements of the GLOBAL row index (gbase + local index).
__device__ __forceinline__ void pair_index(int i, int stride, int* lo, int* hi) {
  *lo = 2 * stride * (i / stride) + (i % stride);
  *hi = *lo + stride;
}

// Sorts (or merges) one tile of `tile` keys in shared memory.  Stages run
// for size = size_first .. size_last (powers of two), strides from
// min(size, tile) / 2 down to 1.  LOAD_KEYS reads the int32 key pair (with
// padding past m) instead of the packed buffer; STORE_KEYS writes the
// unpacked pair (only the first m columns) instead of the packed buffer.
template <bool LOAD_KEYS, bool STORE_KEYS>
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_tile_kernel(const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
                    u64* __restrict__ buf, int32_t* __restrict__ o1,
                    int32_t* __restrict__ o2, int m, int mp, int tile,
                    int size_first, int size_last) {
  extern __shared__ u64 s[];
  const int row = blockIdx.y;
  const int gbase = blockIdx.x * tile;
  const size_t key_row = (size_t)row * (size_t)m;
  const size_t buf_row = (size_t)row * (size_t)mp;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int g = gbase + i;
    if (LOAD_KEYS) {
      s[i] = g < m ? pack(k1[key_row + g], k2[key_row + g]) : PAD_KEY;
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
        const u64 a = s[lo], b = s[hi];
        if ((a > b) == asc) {
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
      if (g < m) {
        int32_t a, b;
        unpack(s[i], &a, &b);
        o1[key_row + g] = a;
        o2[key_row + g] = b;
      }
    } else {
      buf[buf_row + g] = s[i];
    }
  }
}

// One global-memory bitonic stage (stride >= SORT_TILE) over every row.
__global__ void bitonic_global_step(u64* __restrict__ buf, int rows, int mp, int size,
                                    int stride) {
  const long long pairs_per_row = mp / 2;
  const long long total = (long long)rows * pairs_per_row;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(t / pairs_per_row);
    const int i = (int)(t % pairs_per_row);
    int lo, hi;
    pair_index(i, stride, &lo, &hi);
    const bool asc = (lo & size) == 0;
    u64* r = buf + (size_t)row * (size_t)mp;
    const u64 a = r[lo], b = r[hi];
    if ((a > b) == asc) {
      r[lo] = b;
      r[hi] = a;
    }
  }
}

template <bool L, bool S>
cudaError_t launch_tile(const int32_t* k1, const int32_t* k2, u64* buf, int32_t* o1,
                        int32_t* o2, int rows, int m, int mp, int tile, int size_first,
                        int size_last, cudaStream_t stream) {
  const int smem = tile * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel<L, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SORT_TILE * (int)sizeof(u64));
  if (err != cudaSuccess) return err;
  const int threads = tile / 2 < SORT_THREADS ? tile / 2 : SORT_THREADS;
  dim3 grid(mp / tile, rows);
  bitonic_tile_kernel<L, S><<<grid, threads, smem, stream>>>(
      k1, k2, buf, o1, o2, m, mp, tile, size_first, size_last);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Sorts each row of (k1, k2) [rows, m] into (o1, o2) [rows, m].  mp is m
// rounded up to a power of two (>= 2).  `scratch` holds rows*mp u64 and is
// used only when mp > SORT_TILE.  Returns the first CUDA error, or 0.
int tb_sort2(const int32_t* k1, const int32_t* k2, int32_t* o1, int32_t* o2,
             u64* scratch, int rows, int m, int mp, cudaStream_t stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (mp < 2 || (mp & (mp - 1)) != 0 || mp < m || rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (mp <= SORT_TILE) {
    err = launch_tile<true, true>(k1, k2, nullptr, o1, o2, rows, m, mp, mp, 2, mp,
                                  stream);
    return (int)err;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  // Pack and sort every tile with the global network's directions.
  err = launch_tile<true, false>(k1, k2, scratch, nullptr, nullptr, rows, m, mp,
                                 SORT_TILE, 2, SORT_TILE, stream);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)rows * (mp / 2);
  const int threads = 256;
  long long blocks = (pairs + threads - 1) / threads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  for (int size = 2 * SORT_TILE; size <= mp; size <<= 1) {
    for (int stride = size / 2; stride >= SORT_TILE; stride >>= 1) {
      bitonic_global_step<<<(unsigned)blocks, threads, 0, stream>>>(scratch, rows, mp,
                                                                   size, stride);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (size == mp) {
      err = launch_tile<false, true>(nullptr, nullptr, scratch, o1, o2, rows, m, mp,
                                     SORT_TILE, size, size, stream);
    } else {
      err = launch_tile<false, false>(nullptr, nullptr, scratch, nullptr, nullptr, rows,
                                      m, mp, SORT_TILE, size, size, stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
