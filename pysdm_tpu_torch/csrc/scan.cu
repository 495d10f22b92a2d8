// Inclusive prefix sum of a 1D array, for Hopper (sm_90a). Plain C entry
// point, loaded with ctypes by pysdm_tpu_torch/ops/cuda/scan.py, which also
// holds the plain PyTorch twin (torch.cumsum in the input's dtype).
//
// Replaces the TPU kernel cumsum -> _cumsum_pallas
// (pysdm_tpu/ops/pallas/scan.py:105/:63, body _cumsum_kernel :30): there
// the sequential TPU grid walks 32768-element tiles and carries a scalar
// from one tile to the next. Blocks on the card run in parallel and in no
// order, so the carry becomes a reduce-then-scan in three launches:
//   1. every block scans its 2048-element tile and writes the tile's total;
//   2. one block scans the tile totals into tile offsets;
//   3. every block scans its tile again, adds its offset and writes.
// Each pass sums in one fixed order (a thread's 8 items in sequence, then a
// warp-shuffle scan of the thread totals, then a scan of the warp totals),
// so two runs give the same bits and integer results are exact. No atomics
// and no decoupled look-back (a single-pass scan is later work). A thread
// scans 8 consecutive items, but loads and stores go through shared memory
// so that neighbouring threads touch neighbouring addresses.
//
// What bounds it on the card: bytes. A call reads the input twice and
// writes the output once: 12 B per float32 element, ~31 MB at 2.56 M
// elements, ~9 us at 3.35 TB/s; the least any scan can move is 8 B per
// element (~6 us), which pass 1 costs over it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
// shared-memory index of tile item j, padded by one word per 32 so that a
// thread's ITEMS consecutive items fall in distinct banks across a warp
constexpr int TILE_PADDED = TILE + TILE / 32;

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}

template <>
__device__ __forceinline__ float add<float>(float a, float b) {
  return __fadd_rn(a, b);
}

// inclusive scan of the tile's THREADS x ITEMS values held in `v` (thread t
// holds items t*ITEMS .. t*ITEMS+ITEMS-1 of the tile); on return v holds the
// tile-local inclusive scan, and the tile's total is returned to every
// thread
template <typename T>
__device__ __forceinline__ T tile_scan(T (&v)[ITEMS], T* warp_totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) v[i] = add(v[i - 1], v[i]);
  // inclusive scan of the thread totals within the warp
  T inc = v[ITEMS - 1];
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T up = __shfl_up_sync(0xffffffffu, inc, k);
    if (lane >= k) inc = add(up, inc);
  }
  if (lane == 31) warp_totals[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < WARPS ? warp_totals[lane] : T(0);
#pragma unroll
    for (int k = 1; k < WARPS; k <<= 1) {
      const T up = __shfl_up_sync(0xffffffffu, w, k);
      if (lane >= k) w = add(up, w);
    }
    if (lane < WARPS) warp_totals[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  // exclusive prefix of this thread: the warps before it, then the lanes
  // before it in its warp
  T before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (warp > 0) {
    before = lane == 0 ? warp_totals[warp - 1]
                       : add(warp_totals[warp - 1], before);
  }
  if (threadIdx.x > 0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) v[i] = add(before, v[i]);
  }
  const T total = warp_totals[WARPS - 1];
  __syncthreads();  // warp_totals is reused by the next call
  return total;
}

// thread t's items t*ITEMS .. t*ITEMS+ITEMS-1 of the tile at base (0 past
// n), read coalesced into shared memory first
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int64_t n,
                                          int64_t base, T (&v)[ITEMS],
                                          T* buf) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + threadIdx.x;
    buf[padded(j)] = base + j < n ? x[base + j] : T(0);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) v[i] = buf[padded(threadIdx.x * ITEMS + i)];
  __syncthreads();  // buf is reused by the next call
}

// pass 1: the total of every tile
template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_totals_kernel(const T* __restrict__ x, int64_t n,
                       T* __restrict__ totals) {
  __shared__ T warp_totals[WARPS];
  __shared__ T buf[TILE_PADDED];
  T v[ITEMS];
  load_tile(x, n, (int64_t)blockIdx.x * TILE, v, buf);
  const T total = tile_scan(v, warp_totals);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// pass 2 (one block): offsets[0] = 0 and offsets[b + 1] = totals[0] + ... +
// totals[b], chunk by chunk with a running carry
template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_offsets_kernel(const T* __restrict__ totals, int64_t n_tiles,
                        T* __restrict__ offsets) {
  __shared__ T warp_totals[WARPS];
  __shared__ T buf[TILE_PADDED];
  if (threadIdx.x == 0) offsets[0] = T(0);
  T carry = T(0);
  for (int64_t base = 0; base < n_tiles; base += TILE) {
    T v[ITEMS];
    load_tile(totals, n_tiles, base, v, buf);
    const T chunk = tile_scan(v, warp_totals);
    const int64_t first = base + (int64_t)threadIdx.x * ITEMS;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t j = first + i;
      if (j < n_tiles) offsets[j + 1] = base == 0 ? v[i] : add(carry, v[i]);
    }
    carry = base == 0 ? chunk : add(carry, chunk);
  }
}

// pass 3: scan each tile again, add its offset and write
template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_scan_kernel(const T* __restrict__ x, int64_t n,
                     const T* __restrict__ offsets, T* __restrict__ out) {
  __shared__ T warp_totals[WARPS];
  __shared__ T buf[TILE_PADDED];
  T v[ITEMS];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  load_tile(x, n, base, v, buf);
  tile_scan(v, warp_totals);
  const T offset = offsets[blockIdx.x];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    buf[padded(threadIdx.x * ITEMS + i)] =
        blockIdx.x == 0 ? v[i] : add(offset, v[i]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + threadIdx.x;
    if (base + j < n) out[base + j] = buf[padded(j)];
  }
}

template <typename T>
int launch(const void* x, long long n, void* scratch, void* out,
           cudaStream_t s) {
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  T* totals = (T*)scratch;
  T* offsets = totals + n_tiles;
  tile_totals_kernel<T><<<(unsigned)n_tiles, THREADS, 0, s>>>(
      (const T*)x, n, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_offsets_kernel<T><<<1, THREADS, 0, s>>>(totals, n_tiles, offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<T><<<(unsigned)n_tiles, THREADS, 0, s>>>(
      (const T*)x, n, offsets, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elements of scratch (in the input's dtype) the caller allocates for n
// inputs: the tile totals and the tile offsets
long long pysdm_cumsum_scratch(long long n) {
  const long long n_tiles = (n + TILE - 1) / TILE;
  return 2 * n_tiles + 1;
}

// inclusive cumsum of x (n > 0 elements) into out, same dtype; dtype 0 =
// float32, 1 = int32, 2 = int64. Returns cudaGetLastError() after the
// launches (0 = success).
int pysdm_cumsum(const void* x, int dtype, long long n, void* scratch,
                 void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, n, scratch, out, s);
    case 1:
      return launch<int>(x, n, scratch, out, s);
    case 2:
      return launch<long long>(x, n, scratch, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
