// Device helpers shared by the SDM pair-update kernels
// (collision_mirror.cu, collision_breakup.cu, collision_adjacent.cu): the TPU
// kernels' float32 conversions of multiplicities, the collision kernels the
// mirror kernels evaluate in their bodies, the separately rounded merge of
// an extensive row, the mirror croupier's map from a pair's index to its
// slots, and the one-launch fixed-order sum of per-pair rates.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdm {

constexpr float BIG = 2147483520.0f;  // 2^31 - 128, the TPU kernels' cap
constexpr float TWO32 = 4294967296.0f;

// the collision kernels K1 and K5 evaluate (ops/cuda/collision.py has the
// same ids)
enum KernelId {
  GOLOVIN = 0,
  CONSTANT_K = 1,
  LINEAR = 2,
  GEOMETRIC = 3,
  SIMPLE_GEOMETRIC = 4
};

// the collision kernel of a pair in float32, every operation rounded on its
// own in the order of pysdm_tpu/dynamics/collisions/collision_kernels.py:
// k0, k1 the kernel's parameters; v the volumes; r the radii; u the rows
// whose difference the geometric kernels take: the relative fall velocity
// for GEOMETRIC (k0 = pi E_c, multiplied in double on the host), the area
// for SIMPLE_GEOMETRIC (k0 = C)
__device__ __forceinline__ float kernel_value(int id, float k0, float k1,
                                              float va, float vb, float ra,
                                              float rb, float ua, float ub) {
  switch (id) {
    case GOLOVIN:
      return __fmul_rn(k0, __fadd_rn(va, vb));
    case CONSTANT_K:
      return __fadd_rn(k0, __fmul_rn(0.0f, va));
    case LINEAR:
      return __fadd_rn(k0, __fmul_rn(k1, __fadd_rn(va, vb)));
    default: {  // GEOMETRIC, SIMPLE_GEOMETRIC: k0 (r + r')^2 |u - u'|
      const float r_sum = __fadd_rn(ra, rb);
      return __fmul_rn(__fmul_rn(k0, __fmul_rn(r_sum, r_sum)),
                       fabsf(__fsub_rn(ua, ub)));
    }
  }
}

// f32(x >> 1) * 2 + f32(x & 1): the TPU kernels' u32 -> f32 conversion
__device__ __forceinline__ float u32_to_f32(uint32_t x) {
  return __fadd_rn(__fmul_rn((float)(int32_t)(x >> 1), 2.0f),
                   (float)(int32_t)(x & 1u));
}

// f32(hi) * 2^32 + f32(lo); rounds differently from a direct cast once
// x > 2^24
__device__ __forceinline__ float u64_to_f32(uint64_t x) {
  return __fadd_rn(__fmul_rn(u32_to_f32((uint32_t)(x >> 32)), TWO32),
                   u32_to_f32((uint32_t)x));
}

// gamma = min(xi_j / xi_k, cap) for 0 < xi_k <= xi_j and cap > 0, exactly:
// where cap copies of k fit into j (a 128-bit product, no division) it is
// cap, else the int64 division, whose quotient is then below cap
__device__ __forceinline__ int64_t capped_quotient(int64_t mj, int64_t mk,
                                                   int64_t cap) {
  const uint64_t k = (uint64_t)mk, c = (uint64_t)cap;
  if (__umul64hi(c, k) == 0 && c * k <= (uint64_t)mj) return cap;
  return mj / mk;
}

// e_k + gamma e_j, rounded once per operation
__device__ __forceinline__ float merge_rn(float ek, float g, float ej) {
  return __fadd_rn(ek, __fmul_rn(g, ej));
}

__device__ __forceinline__ double merge_rn(double ek, float g, double ej) {
  return __dadd_rn(ek, __dmul_rn((double)g, ej));
}

// The mirror croupier pairs slot o with (K - o) mod n (0 <= K < n). The
// pair's leader is its smaller slot. Leaders lie in two runs: o in
// [0, (K + 1) / 2), partner K - o, and o in [K + 1, K + 1 + (n - K - 1) / 2),
// partner n + K - o. Pair p takes the p-th leader. The slots that pair with
// themselves are K / 2 where K is even and (n + K) / 2 where n + K is even;
// every other slot is a leader or a partner of exactly one pair.
// ops/cuda/collision.py mirror_pairs is the same map in Python.
__device__ __forceinline__ int64_t mirror_pair_count(int64_t n, int64_t K) {
  return (K + 1) / 2 + (n - K - 1) / 2;
}

__device__ __forceinline__ void mirror_pair(int64_t n, int64_t K, int64_t p,
                                            int64_t* o, int64_t* po) {
  const int64_t first = (K + 1) / 2;
  if (p < first) {
    *o = p;
    *po = K - p;
  } else {
    *o = K + 1 + (p - first);
    *po = n + K - *o;
  }
}

// the slot that pairs with itself in run r (0 or 1), or -1
__device__ __forceinline__ int64_t mirror_self_slot(int64_t n, int64_t K,
                                                    int r) {
  const int64_t twice = r == 0 ? K : n + K;
  return twice % 2 == 0 ? twice / 2 : -1;
}

// one-launch sums of per-thread values s[0..N) over the grid, in an order
// that depends on the grid's shape only: a butterfly over each warp, the
// warps' totals in order, a partial per block in `partials` (N * gridDim.x
// floats); the block that finishes last (a ticket from `counter`, which
// atomicInc returns to 0 with the launch's last ticket, so no launch clears
// it) adds the partials, block after block per thread and then as above,
// into out[0..N). No float atomics. Every thread of the block calls it;
// returns true in the last block, after its thread 0 has written out.
template <int N, int THREADS>
__device__ __forceinline__ void block_total(float (&s)[N]) {
  __shared__ float warp_part[N][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      s[i] = __fadd_rn(s[i], __shfl_xor_sync(0xffffffffu, s[i], k));
    if (lane == 0) warp_part[i][warp] = s[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = warp_part[i][0];
      for (int w = 1; w < THREADS / 32; ++w) t = __fadd_rn(t, warp_part[i][w]);
      s[i] = t;
    }
  }
  __syncthreads();  // warp_part may be written again
}

template <int N, int THREADS>
__device__ bool grid_sums(float (&s)[N], unsigned* counter, float* partials,
                          float* out) {
  __shared__ bool last;
  block_total<N, THREADS>(s);
  if (threadIdx.x == 0) {
    for (int i = 0; i < N; ++i) partials[i * gridDim.x + blockIdx.x] = s[i];
    __threadfence();  // the partials are visible before the ticket
    last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = 0.0f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += THREADS) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      t[i] = __fadd_rn(t[i], __ldcg(partials + i * gridDim.x + b));
  }
  block_total<N, THREADS>(t);
  if (threadIdx.x == 0) {
    for (int i = 0; i < N; ++i) out[i] = t[i];
  }
  return true;
}

}  // namespace sdm
