// Device helpers shared by the SDM pair-update kernels
// (collision_mirror.cu, collision_adjacent.cu): the TPU kernels' float32
// conversions of multiplicities and the separately rounded merge of an
// extensive row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdm {

constexpr float BIG = 2147483520.0f;  // 2^31 - 128, the TPU kernels' cap
constexpr float TWO32 = 4294967296.0f;

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

// e_k + gamma e_j, rounded once per operation
__device__ __forceinline__ float merge_rn(float ek, float g, float ej) {
  return __fadd_rn(ek, __fmul_rn(g, ej));
}

__device__ __forceinline__ double merge_rn(double ek, float g, double ej) {
  return __dadd_rn(ek, __dmul_rn((double)g, ej));
}

}  // namespace sdm
