// Inclusive prefix sum along the rows of a contiguous (rows, n) array, for
// Hopper (sm_90a). Plain C entry point, loaded with ctypes by
// pysdm_tpu_torch/ops/cuda/scan.py, which also holds the plain PyTorch twin
// (torch.cumsum in the input's dtype).
//
// Replaces the TPU kernel cumsum -> _cumsum_pallas
// (pysdm_tpu/ops/pallas/scan.py:105/:63, body _cumsum_kernel :30): there
// the sequential TPU grid walks 32768-element tiles and carries a scalar
// from one tile to the next. Blocks on the card run in parallel and in no
// order, so the carry becomes a look-back over published tile totals.
//
// What bounds it on the card: bytes, 8 B per float32 element (each input
// read once, each output written once). The design moves exactly those:
// - one launch, one pass. A block takes a ticket from an atomic counter
//   (so a tile never waits on one that has not started; atomicInc wraps
//   the counter back to 0 with the launch's last ticket, so nothing resets
//   it), which names its row and its 4096-element tile. It reads the tile
//   with 16-byte loads (lane l of a warp takes items 4l..4l+3 of each of
//   four 128-item chunks, so a warp's load covers 512 contiguous bytes and
//   nothing is staged through shared memory), scans it in registers,
//   publishes the tile's total, gathers its exclusive prefix from the
//   totals published before it, adds and writes with 16-byte stores. A
//   tile that is ragged or whose row is not 16-byte aligned takes scalar
//   loads and stores in the same arrangement.
// - a tile's total is published in a slot together with the generation
//   number of the launch (for the 4-byte types both in one 8-byte word, so
//   that a reader needs one load and no fence; for int64 a flag word,
//   written after a fence, beside the value). The wrapper keeps one scratch
//   buffer per device, stream and shape and passes a new generation with
//   every launch, so no launch clears flags and two streams never share
//   them.
// - few readers, few slots: a tile waits for at most 31 + 31 + 31 slots,
//   one lane each of three warps (see step 4), and sleeps between two looks
//   at a slot. A first version in which every thread of a tile polled up to
//   four of all the totals before it ran at 0.025 ms at 2.56 M elements,
//   twice the library call's time: the polling of ~600 waiting tiles kept
//   the L2 from serving the loads.
//
// The order of the additions depends on the position in the row only, never
// on timing, so two runs give the same bits, a row of a (rows, n) call
// equals its 1D scan, and integers are exact:
//   1. in a lane, the 4 items of a chunk left to right;
//   2. across the lanes of the chunk, a shuffle scan (distances 1, 2, 4, 8,
//      16); the four chunk totals of a warp left to right;
//   3. the eight warp totals of the tile left to right;
//   4. the tile's exclusive prefix from *totals* alone (never from a
//      predecessor's prefix, which would arrive at a time that depends on
//      scheduling), on three levels: tiles, groups of 32 tiles, groups of
//      1024 tiles. S0 is the sum of the totals of the tiles before it in
//      its group of 32, S1 of the groups of 32 before its group in its
//      group of 1024, S2 of the groups of 1024 before its own; each is the
//      butterfly (xor 16, 8, 4, 2, 1) over 32 lanes that hold one total each
//      or zero (S2, past 32 groups of 1024: such sums of 32 left to right).
//      prefix = (S2 + S1) + S0. The last tile of a group of 32 publishes
//      the group's total S0 + own total, the last of a group of 1024
//      (S1 + S0) + own total; neither waits for another group's tiles, so
//      no chain of waits grows with the row. At 2.56 M elements: 625
//      tiles, 20 groups of 32, one group of 1024;
//   5. out = ((prefix + warps before) + chunks and lanes before) + item.
// A float32 output is a chain of at most ~35 roundings of 2^-24 of the
// prefix each.
//
// Measured times and the earlier design's (a reduce-then-scan in three
// launches, 12 B per element) stand in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;     // consecutive items of a lane in a chunk
constexpr int CHUNKS = 4;  // chunks of 32 * VEC items a warp scans
constexpr int WARP_ITEMS = CHUNKS * 32 * VEC;
constexpr int TILE = WARPS * WARP_ITEMS;  // 4096
constexpr int GROUP = 32;                 // slots a warp sums in step 4
constexpr int SLOT_WORDS = 2;             // 8-byte words of a slot

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}

template <>
__device__ __forceinline__ float add<float>(float a, float b) {
  return __fadd_rn(a, b);
}

// VEC items at p, which is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_vec(T (&v)[VEC], const T* p) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < VEC / PER; ++q) {
    const int4 raw = reinterpret_cast<const int4*>(p)[q];
    *reinterpret_cast<int4*>(&v[q * PER]) = raw;
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < VEC / PER; ++q) {
    reinterpret_cast<int4*>(p)[q] = *reinterpret_cast<const int4*>(&v[q * PER]);
  }
}

// a slot: for the 4-byte types word 0 holds (generation << 32) | value;
// for int64 word 0 holds the generation and word 1 the value
template <typename T>
__device__ __forceinline__ void publish(volatile unsigned long long* slots,
                                        int64_t slot, T value, unsigned gen) {
  volatile unsigned long long* w = slots + slot * SLOT_WORDS;
  if constexpr (sizeof(T) == 4) {
    unsigned bits;
    memcpy(&bits, &value, 4);
    w[0] = ((unsigned long long)gen << 32) | bits;
  } else {
    w[1] = (unsigned long long)value;
    __threadfence();  // the value is visible before its flag
    w[0] = gen;
  }
}

// the value of a slot, once this launch has published it
template <typename T>
__device__ __forceinline__ T wait_for(const volatile unsigned long long* slots,
                                      int64_t slot, unsigned gen) {
  const volatile unsigned long long* w = slots + slot * SLOT_WORDS;
  if constexpr (sizeof(T) == 4) {
    unsigned long long word = w[0];
    while ((unsigned)(word >> 32) != gen) {
      __nanosleep(40);
      word = w[0];
    }
    const unsigned bits = (unsigned)word;
    T value;
    memcpy(&value, &bits, 4);
    return value;
  } else {
    while (w[0] != gen) __nanosleep(40);
    __threadfence();  // the value is read after its flag
    return (T)w[1];
  }
}

// step 4's sum of the `count` (<= 32) slots from `first` on, by one warp:
// lane l holds slot first + l or zero; the butterfly leaves the sum in
// every lane
template <typename T>
__device__ __forceinline__ T warp_sum_of_slots(
    const volatile unsigned long long* slots, int64_t first, int count,
    unsigned gen) {
  const int lane = threadIdx.x & 31;
  T part = lane < count ? wait_for<T>(slots, first + lane, gen) : T(0);
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    part = add(part, __shfl_xor_sync(0xffffffffu, part, k));
  }
  return part;
}

// blocks that share an SM, for the 4-byte types: the compiler keeps the
// registers under 65536 / (6 * 256) = 42 (it took 45 for float32 when left
// alone, five blocks an SM). int64 needs 64 registers and would spill under
// that limit
constexpr int MIN_BLOCKS = 6;

template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? MIN_BLOCKS : 1)
    scan_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                int64_t tiles, int64_t groups, int64_t big_groups,
                unsigned* counter, volatile unsigned long long* tile_slots,
                volatile unsigned long long* group_slots,
                volatile unsigned long long* big_slots, unsigned gen) {
  __shared__ unsigned ticket_shared;
  __shared__ T warp_sums[WARPS];
  __shared__ T level_sums[3];
  if (threadIdx.x == 0) ticket_shared = atomicInc(counter, gridDim.x - 1);
  __syncthreads();
  const int64_t ticket = ticket_shared;
  const int64_t row = ticket / tiles;
  const int64_t tile = ticket % tiles;
  const T* xr = x + row * n;
  T* outr = out + row * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile_base = tile * TILE;
  // the lane's items of chunk k start at first + k * 32 * VEC
  const int64_t first = tile_base + warp * WARP_ITEMS + lane * VEC;
  const bool whole = tile_base + TILE <= n;

  alignas(16) T v[CHUNKS][VEC];
  if (whole && reinterpret_cast<uintptr_t>(xr + tile_base) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) load_vec(v[k], xr + first + k * 32 * VEC);
  } else {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        const int64_t e = first + k * 32 * VEC + m;
        v[k][m] = e < n ? xr[e] : T(0);
      }
    }
  }

  // steps 1 and 2: the warp's 512 items; before[k] is what precedes the
  // lane's items of chunk k in the warp
  T before[CHUNKS];
  T warp_total = T(0);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
    for (int m = 1; m < VEC; ++m) v[k][m] = add(v[k][m - 1], v[k][m]);
    T inc = v[k][VEC - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T up = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc = add(up, inc);
    }
    T lanes_before = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) lanes_before = T(0);
    const T chunk_total = __shfl_sync(0xffffffffu, inc, 31);
    before[k] = k == 0 ? lanes_before : add(warp_total, lanes_before);
    warp_total = k == 0 ? chunk_total : add(warp_total, chunk_total);
  }

  // step 3
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();
  T warps_before = T(0);
  T tile_total = warp_sums[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    if (w == warp) warps_before = tile_total;
    tile_total = add(tile_total, warp_sums[w]);
  }

  if (threadIdx.x == 0) publish(tile_slots, row * tiles + tile, tile_total, gen);

  // step 4: warp 0 sums the tiles before this one in its group of 32, warp
  // 1 the groups of 32 before its group in its group of 1024, warp 2 the
  // groups of 1024 before its own
  const int64_t group = tile / GROUP;
  const int64_t big_group = group / GROUP;
  const int in_group = (int)(tile % GROUP);
  const int in_big_group = (int)(group % GROUP);
  if (warp == 0) {
    const T s0 = warp_sum_of_slots<T>(tile_slots, row * tiles + group * GROUP,
                                      in_group, gen);
    if (lane == 0) {
      level_sums[0] = s0;
      if (in_group == GROUP - 1 && tile + 1 < tiles) {
        publish(group_slots, row * groups + group, add(s0, tile_total), gen);
      }
    }
  } else if (warp == 1) {
    const T s1 = warp_sum_of_slots<T>(
        group_slots, row * groups + big_group * GROUP, in_big_group, gen);
    if (lane == 0) level_sums[1] = s1;
  } else if (warp == 2) {
    T s2 = T(0);
    for (int64_t g = 0; g < big_group; g += GROUP) {
      const int count = (int)(big_group - g < GROUP ? big_group - g : GROUP);
      const T s = warp_sum_of_slots<T>(big_slots, row * big_groups + g, count,
                                       gen);
      s2 = g == 0 ? s : add(s2, s);
    }
    if (lane == 0) level_sums[2] = s2;
  }
  __syncthreads();
  const T groups_before = add(level_sums[2], level_sums[1]);
  const T prefix = add(groups_before, level_sums[0]);
  if (threadIdx.x == 0 && in_group == GROUP - 1 &&
      in_big_group == GROUP - 1 && tile + 1 < tiles) {
    publish(big_slots, row * big_groups + big_group,
            add(add(level_sums[1], level_sums[0]), tile_total), gen);
  }

  // step 5
  const T offset = add(prefix, warps_before);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const T base = add(offset, before[k]);
#pragma unroll
    for (int m = 0; m < VEC; ++m) v[k][m] = add(base, v[k][m]);
  }
  if (whole && reinterpret_cast<uintptr_t>(outr + tile_base) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) store_vec(outr + first + k * 32 * VEC, v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        const int64_t e = first + k * 32 * VEC + m;
        if (e < n) outr[e] = v[k][m];
      }
    }
  }
}

// the scratch buffer: the ticket counter, then the slots of the tiles, of
// the groups of 32 and of the groups of 1024, row after row
struct Layout {
  int64_t tiles, groups, big_groups, tile_slots, group_slots, big_slots, bytes;
};

Layout layout(int64_t rows, int64_t n) {
  Layout l;
  l.tiles = (n + TILE - 1) / TILE;
  l.groups = (l.tiles + GROUP - 1) / GROUP;
  l.big_groups = (l.groups + GROUP - 1) / GROUP;
  const int64_t slot = 8 * SLOT_WORDS;
  l.tile_slots = 16;
  l.group_slots = l.tile_slots + slot * rows * l.tiles;
  l.big_slots = l.group_slots + slot * rows * l.groups;
  l.bytes = l.big_slots + slot * rows * l.big_groups;
  return l;
}

template <typename T>
int launch(const void* x, int64_t rows, int64_t n, void* scratch,
           unsigned gen, void* out, cudaStream_t s) {
  const Layout l = layout(rows, n);
  if (rows * l.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  char* base = (char*)scratch;
  scan_kernel<T><<<(unsigned)(rows * l.tiles), THREADS, 0, s>>>(
      (const T*)x, (T*)out, n, l.tiles, l.groups, l.big_groups,
      (unsigned*)base, (volatile unsigned long long*)(base + l.tile_slots),
      (volatile unsigned long long*)(base + l.group_slots),
      (volatile unsigned long long*)(base + l.big_slots), gen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of scratch for a (rows, n) call. The caller zeroes the buffer once,
// when it allocates it, keeps it for the later calls of this shape on this
// stream (another shape lays the buffer out differently, and a value left
// where a flag now lies could pass for one) and gives every call on it a
// generation number that none before it had (never 0).
long long pysdm_cumsum_scratch_bytes(long long rows, long long n) {
  return layout(rows, n).bytes;
}

// inclusive cumsum along the rows of the contiguous (rows, n) array x into
// out, same dtype (rows > 0, n > 0); dtype 0 = float32, 1 = int32, 2 =
// int64. One launch. Returns cudaGetLastError() after it (0 = success).
int pysdm_cumsum(const void* x, int dtype, long long rows, long long n,
                 void* scratch, unsigned gen, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, rows, n, scratch, gen, out, s);
    case 1:
      return launch<int>(x, rows, n, scratch, gen, out, s);
    case 2:
      return launch<long long>(x, rows, n, scratch, gen, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
