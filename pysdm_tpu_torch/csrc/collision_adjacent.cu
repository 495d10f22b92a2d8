// Multi-cell SDM coalescence substep over the cell-sorted state (the sort
// croupier), for Hopper (sm_90a). Plain C entry point, loaded with ctypes
// by pysdm_tpu_torch/ops/cuda/collision.py, which also holds the plain
// PyTorch twin of this function (coalesce_adjacent_reference).
//
// Replaces the TPU kernel fused_coalesce
// (pysdm_tpu/ops/pallas/collision.py:721, body _coalesce_kernel :103-217):
// slots p and p + 1 form a pair where is_first[p]; the pair's leader p
// supplies the kernel value times the cell's normalization (kernnorm) and
// the gamma draw (rand); gamma = min(max(ceil(xi_j kernnorm - u), 0) capped
// at 2^31 - 128, floor(xi_j / xi_k)), then the Shima update with the equal
// split of an exhausted j, and the per-slot collision rate and rate deficit
// at leader slots (the caller sums them per cell).
//
// Design:
// - one thread per slot, 256-thread blocks. A slot pairs with p + 1 when
//   is_first[p] and with p - 1 when is_first[p - 1]; both members read only
//   the inputs and recompute the pair's arithmetic, and each thread writes
//   its own slot into separate output buffers;
// - multiplicities are native int64 and floor(xi_j / xi_k) is an exact
//   integer division. The TPU kernel walks an f32 quotient estimate +-5
//   steps, which misses the exact floor when the quotient is above ~2^26
//   and below the cap;
// - the float32 arithmetic mirrors the TPU kernel's rounding (sdm_pair.cuh;
//   the library is built with -fmad=false);
// - the TPU kernel's pre-rolled neighbour copies (roll +-1 of every row)
//   become reads of the neighbour slot, which the L1/L2 caches serve.
//
// What bounds it on the card: bytes. Per slot it reads the multiplicity
// (8 B), three float32 extensive rows (12 B), kernnorm and rand (8 B) and
// is_first (1 B), and writes the multiplicity, the rows and two rate rows
// (28 B): ~57 B, 0.146 GB per substep at 2.56 M slots, ~44 us at 3.35 TB/s.
// It does some 40 operations per slot, far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdm_pair.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) coalesce_adjacent_kernel(
    const int64_t* __restrict__ mult, const T* __restrict__ ext, int n_ext,
    const float* __restrict__ kernnorm, const float* __restrict__ rand,
    const uint8_t* __restrict__ is_first, int64_t n,
    int64_t* __restrict__ mult_out, T* __restrict__ ext_out,
    float* __restrict__ rate_out, float* __restrict__ deficit_out) {
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  const bool isf = is_first[p] != 0;
  const bool in_pair = isf || (p > 0 && is_first[p - 1] != 0);
  const int64_t a = mult[p];
  if (!in_pair) {
    mult_out[p] = a;
    for (int r = 0; r < n_ext; ++r) {
      ext_out[(int64_t)r * n + p] = ext[(int64_t)r * n + p];
    }
    rate_out[p] = 0.0f;
    deficit_out[p] = 0.0f;
    return;
  }
  const int64_t q = isf ? p + 1 : p - 1;  // the partner
  const int64_t lead = isf ? p : p - 1;
  const int64_t b = mult[q];
  // j = not-smaller multiplicity; ties go to the pair's leader
  const bool a_is_j = isf ? (a >= b) : (a > b);
  const int64_t mj = a_is_j ? a : b;
  const int64_t mk = a_is_j ? b : a;

  const float gamma_f = fmaxf(
      ceilf(__fsub_rn(__fmul_rn(sdm::u64_to_f32((uint64_t)mj), kernnorm[lead]),
                      rand[lead])),
      0.0f);
  const int64_t cap = (int64_t)fminf(gamma_f, sdm::BIG);
  const int64_t quotient = mj / (mk == 0 ? 1 : mk);
  const int64_t g = quotient < cap ? quotient : cap;
  const float gf = sdm::u32_to_f32((uint32_t)g);

  // Shima update: xi_j -= gamma xi_k; k absorbs gamma copies of j; an
  // exhausted j takes half of k's multiplicity
  const int64_t nn = mj - g * mk;
  const bool split = nn == 0 && g > 0;
  const int64_t half = mk >> 1;
  const int64_t mj_new = split ? half : nn;
  const int64_t mk_new = split ? mk - half : mk;
  mult_out[p] = a_is_j ? mj_new : mk_new;

  for (int r = 0; r < n_ext; ++r) {
    const T e_own = ext[(int64_t)r * n + p];
    const T e_other = ext[(int64_t)r * n + q];
    const T ej = a_is_j ? e_own : e_other;
    const T merged = sdm::merge_rn(a_is_j ? e_other : e_own, gf, ej);
    ext_out[(int64_t)r * n + p] = a_is_j ? (split ? merged : ej) : merged;
  }

  float rate = 0.0f, deficit = 0.0f;
  if (isf) {
    const float mk_f = sdm::u64_to_f32((uint64_t)mk);
    rate = __fmul_rn(gf, mk_f);
    deficit = __fmul_rn(__fsub_rn(gamma_f, gf), mk_f);
  }
  rate_out[p] = rate;
  deficit_out[p] = deficit;
}

}  // namespace

extern "C" {

// one substep; returns cudaGetLastError() after the launch (0 = success).
// mult, mult_out: int64 (n,); ext, ext_out: (n_ext, n) float or double
// (ext_is_f64); kernnorm, rand: float (n,); is_first: bool (n,), false at
// the last slot; rate, deficit: float (n,) per-slot rows, zero where no
// pair leads.
int pysdm_coalesce_adjacent(const void* mult, const void* ext, int ext_is_f64,
                            int n_ext, const void* kernnorm, const void* rand,
                            const void* is_first, long long n, void* mult_out,
                            void* ext_out, void* rate, void* deficit,
                            void* stream) {
  const unsigned n_blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    coalesce_adjacent_kernel<double><<<n_blocks, THREADS, 0, s>>>(
        (const int64_t*)mult, (const double*)ext, n_ext,
        (const float*)kernnorm, (const float*)rand, (const uint8_t*)is_first,
        n, (int64_t*)mult_out, (double*)ext_out, (float*)rate,
        (float*)deficit);
  } else {
    coalesce_adjacent_kernel<float><<<n_blocks, THREADS, 0, s>>>(
        (const int64_t*)mult, (const float*)ext, n_ext,
        (const float*)kernnorm, (const float*)rand, (const uint8_t*)is_first,
        n, (int64_t*)mult_out, (float*)ext_out, (float*)rate,
        (float*)deficit);
  }
  return (int)cudaGetLastError();
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
