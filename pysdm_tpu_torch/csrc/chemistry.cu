// The pH solve of aqueous chemistry for Hopper (sm_90a): per drop, the
// hydrogen-ion concentration H at which the electroneutrality residual
// changes sign, by a fixed-count bisection in log H. Plain C entry point,
// loaded with ctypes by pysdm_tpu_torch/ops/cuda/chemistry.py, which also
// holds the plain PyTorch twin (equilibrate_H_reference).
//
// Replaces no Pallas kernel. The JAX package's equilibrate_H
// (pysdm_tpu/ops/chemistry.py:74-85) unrolls its 48 iterations inside jit,
// and XLA compiles the solve into one fused elementwise pass over the
// drops. Run eagerly, the same solve is ~31 kernels an iteration, ~1,500
// launches a solve, two solves a chemistry substep: the host's launch rate
// then sets the step's time. This kernel is that fused pass, written out:
// one launch a solve.
//
// Per drop, the twin's arithmetic in the twin's order, each operation
// rounded on its own (built with -fmad=false: no a*b+c is contracted into
// an FMA, as no eager operation is), expf/exp and IEEE division (no fast
// math), so that H equals the eager twin's on the card to the bit wherever
// the two exp implementations round alike:
//   - the H-free factors once (the twin's acidity_terms): N_V K_HNO3,
//     S_IV K_SO2, C_IV K_CO2, 2 K_HSO3, 2 K_HCO3, K_SO2 K_HSO3,
//     K_CO2 K_HCO3, 2 K_HSO4;
//   - lo and hi start at log(H_min) and log(H_max), host doubles rounded
//     to the working type as torch.full_like rounds them;
//   - `iters` times: mid = 0.5 (lo + hi), H = exp(mid), the residual of
//     acidity_residual at H (K_H2O / H taken as (1 / H) K_H2O, as torch
//     evaluates a Python float over a tensor), and hi = mid where it is
//     above zero, else lo = mid (a NaN residual moves lo, as torch.where
//     on a false comparison does). No early exit;
//   - H = exp(0.5 (lo + hi)).
//
// What bounds it on the card: its arithmetic. A drop reads 12 values and
// writes one (52 B in float32); its 48 iterations take 36 floating-point
// operations each (the exp, six divisions and the comparison counted as
// one each), 1,739 with the prologue and the result. At the Kreidenweis
// parcel's 2^17 drops that is 2.3e8 operations, 3.4 us at 67 TFLOP/s,
// against 2.0 us for the bytes. The design keeps everything but the 13
// loads and stores in registers, one thread a drop, no shared memory and
// no synchronisation. An iteration is ~128 SASS instructions in float32
// (7 MUFU: the exp2 and six reciprocals; ~70 FP32; ~25 branches, most of
// them the divisions' slow-path checks). What the card waits on, measured
// on an H100 (PERF.md §6): the issue of those instructions, not the
// chain's latency. From 2^17 drops (~31 warps an SM) to 2^20 the time a
// drop falls by 14% only, and a bisection that gives a drop 2^L lanes of
// a warp, each evaluating one midpoint that a round of L levels can reach
// (a chain L times shorter on 2^L times the warps), took 2.0-2.6x this
// form's time, in proportion to the evaluations it issues. THREADS = 512:
// on 2^17 float32 drops, the width and type of the models' solves on the
// card, 0.0729 ms a solve against 0.0757 with 256 (16 alternating pairs,
// each pair in the same order); 256 is faster in float64 (by 1%) and at
// 2^20 drops (by 4%). A __launch_bounds__ minimum of blocks that fills an
// SM doubles the float64 time (its registers spill), so none is given.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
// the per-drop rows, in this order: concentrations S_VI, S_IV, C_IV, N_V,
// N_mIII; equilibrium constants K_NH3, K_HNO3, K_SO2, K_HSO3, K_CO2,
// K_HCO3, K_HSO4 (ops/cuda/chemistry.py ROWS)
constexpr int N_ROWS = 12;

template <typename T>
struct Rows {
  const T* p[N_ROWS];
};

__device__ __forceinline__ float exp_rn(float x) { return expf(x); }
__device__ __forceinline__ double exp_rn(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
equilibrate_H_kernel(Rows<T> rows, T K_H2O, T lo0, T hi0, int iters,
                     long long n, T* __restrict__ H_out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T S_VI = rows.p[0][i], S_IV = rows.p[1][i], C_IV = rows.p[2][i];
  const T N_V = rows.p[3][i], N_mIII = rows.p[4][i];
  const T K_NH3 = rows.p[5][i], K_HNO3 = rows.p[6][i];
  const T K_SO2 = rows.p[7][i], K_HSO3 = rows.p[8][i];
  const T K_CO2 = rows.p[9][i], K_HCO3 = rows.p[10][i];
  const T K_HSO4 = rows.p[11][i];

  // acidity_terms
  const T nitric = N_V * K_HNO3;
  const T diprotic_S = S_IV * K_SO2, diprotic_C = C_IV * K_CO2;
  const T twice_K2_S = (T)2 * K_HSO3, twice_K2_C = (T)2 * K_HCO3;
  const T K1_K2_S = K_SO2 * K_HSO3, K1_K2_C = K_CO2 * K_HCO3;
  const T twice_K_HSO4 = (T)2 * K_HSO4;

  T lo = lo0, hi = hi0;
  for (int it = 0; it < iters; ++it) {
    const T mid = (lo + hi) * (T)0.5;
    const T H = exp_rn(mid);
    // acidity_residual, operation by operation
    const T ammonia = ((N_mIII * H) * K_NH3) / ((K_NH3 * H) + K_H2O);
    const T nitric_H = nitric / (H + K_HNO3);
    const T HH = H * H;
    const T sulfous =
        (diprotic_S * (H + twice_K2_S)) / ((HH + H * K_SO2) + K1_K2_S);
    const T carbonic =
        (diprotic_C * (H + twice_K2_C)) / ((HH + H * K_CO2) + K1_K2_C);
    const T water = ((T)1 / H) * K_H2O;
    const T sulfuric = (S_VI * (H + twice_K_HSO4)) / (H + K_HSO4);
    const T residual =
        (H + ammonia) - ((((nitric_H + sulfous) + water) + sulfuric) + carbonic);
    if (residual > (T)0) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  H_out[i] = exp_rn((lo + hi) * (T)0.5);
}

template <typename T>
int launch(const void* const* ptrs, double K_H2O, double lo, double hi,
           int iters, long long n, void* out, cudaStream_t s) {
  Rows<T> rows;
  for (int r = 0; r < N_ROWS; ++r) rows.p[r] = static_cast<const T*>(ptrs[r]);
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  equilibrate_H_kernel<T><<<blocks, THREADS, 0, s>>>(
      rows, (T)K_H2O, (T)lo, (T)hi, iters, n, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// H of n drops into out from the 12 contiguous rows `rows` (the order of
// Rows above), all of one dtype: 0 = float32, 1 = float64. K_H2O and the
// bracket's ends log(H_min), log(H_max) come as doubles and are rounded to
// the dtype. n > 0, iters >= 0. One launch on `stream`. Returns
// cudaGetLastError() after it (0 = success).
int pysdm_equilibrate_H(const void* const* rows, int dtype, long long n,
                        double K_H2O, double log_H_min, double log_H_max,
                        int iters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(rows, K_H2O, log_H_min, log_H_max, iters, n, out, s);
    case 1:
      return launch<double>(rows, K_H2O, log_H_min, log_H_max, iters, n, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
