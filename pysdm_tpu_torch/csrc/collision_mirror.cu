// Single-cell SDM coalescence substep under the mirror croupier, for Hopper
// (sm_90a). Plain C entry point, loaded with ctypes by
// pysdm_tpu_torch/ops/cuda/collision.py, which also holds the plain PyTorch
// twin of this function (coalesce_mirror_reference).
//
// Replaces the TPU kernel fused_coalesce_mirror_blocks
// (pysdm_tpu/ops/pallas/collision.py:582, body _mk_mirror_block_kernel :422)
// and takes its semantics at every N: slot o pairs with po = (K - o) mod N,
// u01 comes from the pair-keyed PRF _u01_hash(seed, min(o, po)), and the
// collision kernel is evaluated here from the volume row.
//
// Design:
// - one thread per slot, 256-thread blocks. Both members of a pair read only
//   the inputs and recompute the pair's arithmetic; each thread writes its
//   own slot into separate output buffers, so no thread can read a value its
//   partner has already updated;
// - multiplicities are native int64: gamma = min(cap, xi_j / xi_k) is an
//   exact integer division. The TPU kernel has no 64-bit vector path and
//   walks an f32 quotient estimate +-5 steps instead;
// - the f32 arithmetic mirrors the TPU kernel's rounding (sdm_pair.cuh):
//   xi converts to f32 through halves, and every product and sum is rounded
//   on its own (__fmul_rn/__fadd_rn; the library is also built with
//   -fmad=false), since a fused multiply-add would change ceil(prob - u)
//   and e_k + gamma * e_j;
// - the rate sums are deterministic: a fixed-order shared-memory tree per
//   block writes per-block partials, and a one-block second pass sums them
//   in fixed order. No float atomics.
//
// What bounds it on the card: per slot and substep it moves about 44 bytes
// of device memory (own and partner multiplicity 16, extensive row 8 per
// row, volume 8, writes of multiplicity 8 and extensive row 4) for some
// 60 flops and one 64-bit division, so it is memory-bound; at 2^20 slots
// that is ~46 MB, ~14 us at 3.35 TB/s, within reach of the launch overhead
// of the ops around it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdm_pair.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24

using sdm::BIG;
using sdm::merge_rn;
using sdm::u32_to_f32;
using sdm::u64_to_f32;

enum KernelId { GOLOVIN = 0, CONSTANT_K = 1, LINEAR = 2 };

// murmur3 fmix32 applied twice to the pair identity (bit-exact with
// pysdm_tpu/ops/pallas/collision.py:402-419)
__device__ __forceinline__ float u01_hash(uint32_t seed, uint32_t pair_id) {
  uint32_t h = seed ^ (pair_id * 0x9E3779B9u);
  for (int i = 0; i < 2; ++i) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
  }
  return __fmul_rn((float)(int32_t)(h >> 8), TWO_M24);
}

__device__ __forceinline__ float kernel_value(int id, float p0, float p1,
                                              float va, float vb) {
  const float vsum = __fadd_rn(va, vb);
  switch (id) {
    case GOLOVIN:
      return __fmul_rn(p0, vsum);
    case CONSTANT_K:
      return __fadd_rn(p0, __fmul_rn(0.0f, va));
    default:  // LINEAR
      return __fadd_rn(p0, __fmul_rn(p1, vsum));
  }
}

// fixed-order tree sum over the block; result valid in thread 0
__device__ __forceinline__ void block_sum2(float (*red)[THREADS], float x0,
                                           float x1) {
  const int t = threadIdx.x;
  red[0][t] = x0;
  red[1][t] = x1;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[0][t] = __fadd_rn(red[0][t], red[0][t + s]);
      red[1][t] = __fadd_rn(red[1][t], red[1][t + s]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) coalesce_mirror_kernel(
    const int64_t* __restrict__ mult, const T* __restrict__ ext, int n_ext,
    const float* __restrict__ volume, int kernel_id, float p0, float p1,
    const float* __restrict__ scale, int64_t n, int64_t K, uint32_t seed,
    int64_t* __restrict__ mult_out, T* __restrict__ ext_out,
    float* __restrict__ partials) {
  __shared__ float red[2][THREADS];
  const int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float rate = 0.0f, deficit = 0.0f;
  if (o < n) {
    int64_t po = K - o;
    if (po < 0) po += n;
    const int64_t a = mult[o];
    const int64_t b = mult[po];
    const bool in_pair = (a != 0) && (b != 0) && (po != o);
    const bool isf = in_pair && (po > o);  // the pair's leader
    // j = not-smaller multiplicity; ties go to the leader
    const bool a_is_j = isf ? (a >= b) : (a > b);
    const int64_t mj = a_is_j ? a : b;
    const int64_t mk = a_is_j ? b : a;

    const float kn = __fmul_rn(
        kernel_value(kernel_id, p0, p1, volume[o], volume[po]), scale[0]);
    const float u = u01_hash(seed, (uint32_t)(o < po ? o : po));
    float gamma_f = fmaxf(
        ceilf(__fsub_rn(__fmul_rn(u64_to_f32((uint64_t)mj), kn), u)), 0.0f);
    if (!in_pair) gamma_f = 0.0f;
    const int64_t cap = (int64_t)fminf(gamma_f, BIG);
    int64_t g = 0;
    if (in_pair) {
      const int64_t q = mj / mk;
      g = q < cap ? q : cap;
    }
    const float gf = u32_to_f32((uint32_t)g);

    // Shima update: xi_j -= gamma xi_k; k absorbs gamma copies of j; an
    // exhausted j takes half of k's multiplicity
    const int64_t nn = mj - g * mk;
    const bool split = in_pair && nn == 0 && g > 0;
    const int64_t half = mk >> 1;
    const int64_t mj_new = split ? half : nn;
    const int64_t mk_new = split ? mk - half : mk;
    const bool i_am_j = in_pair && a_is_j;
    mult_out[o] = in_pair ? (i_am_j ? mj_new : mk_new) : a;

    for (int r = 0; r < n_ext; ++r) {
      const T e_own = ext[(int64_t)r * n + o];
      const T e_other = ext[(int64_t)r * n + po];
      const T ej = i_am_j ? e_own : e_other;
      const T ek = i_am_j ? e_other : e_own;
      const T merged = merge_rn(ek, gf, ej);
      const T e_new = i_am_j ? (split ? merged : ej) : merged;
      ext_out[(int64_t)r * n + o] = in_pair ? e_new : e_own;
    }

    if (isf) {
      const float mk_f = u64_to_f32((uint64_t)mk);
      rate = __fmul_rn(gf, mk_f);
      deficit = __fmul_rn(__fsub_rn(gamma_f, gf), mk_f);
    }
  }
  block_sum2(red, rate, deficit);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = red[0][0];
    partials[gridDim.x + blockIdx.x] = red[1][0];
  }
}

// second pass: sums the per-block partials in fixed order; the coalescence
// rate equals the collision rate in a coalescence-only substep
__global__ void __launch_bounds__(THREADS)
    finish_rates_kernel(const float* __restrict__ partials, int n_blocks,
                        float* __restrict__ sums) {
  __shared__ float red[2][THREADS];
  float r = 0.0f, d = 0.0f;
  for (int i = threadIdx.x; i < n_blocks; i += THREADS) {
    r = __fadd_rn(r, partials[i]);
    d = __fadd_rn(d, partials[n_blocks + i]);
  }
  block_sum2(red, r, d);
  if (threadIdx.x == 0) {
    sums[0] = red[0][0];
    sums[1] = red[1][0];
    sums[2] = red[0][0];
  }
}

}  // namespace

extern "C" {

// number of float partials the caller allocates for n slots
long long pysdm_coalesce_mirror_partials(long long n) {
  return 2 * ((n + THREADS - 1) / THREADS);
}

// one substep; returns cudaGetLastError() after the launches (0 = success).
// mult, mult_out: int64 (n,); ext, ext_out: (n_ext, n) float or double
// (ext_is_f64); volume: float (n,); scale: float (1,) on the device;
// partials: float (pysdm_coalesce_mirror_partials(n),); sums: float (3,)
// receives the collision rate, rate deficit and coalescence rate.
int pysdm_coalesce_mirror(const void* mult, const void* ext, int ext_is_f64,
                          int n_ext, const void* volume, int kernel_id,
                          float p0, float p1, const void* scale, long long n,
                          long long K, unsigned int seed, void* mult_out,
                          void* ext_out, void* partials, void* sums,
                          void* stream) {
  const int n_blocks = (int)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    coalesce_mirror_kernel<double><<<n_blocks, THREADS, 0, s>>>(
        (const int64_t*)mult, (const double*)ext, n_ext,
        (const float*)volume, kernel_id, p0, p1, (const float*)scale, n, K,
        seed, (int64_t*)mult_out, (double*)ext_out, (float*)partials);
  } else {
    coalesce_mirror_kernel<float><<<n_blocks, THREADS, 0, s>>>(
        (const int64_t*)mult, (const float*)ext, n_ext, (const float*)volume,
        kernel_id, p0, p1, (const float*)scale, n, K, seed,
        (int64_t*)mult_out, (float*)ext_out, (float*)partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_rates_kernel<<<1, THREADS, 0, s>>>((const float*)partials, n_blocks,
                                            (float*)sums);
  return (int)cudaGetLastError();
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
