// Single-cell SDM collision substep with bounce, coalescence and breakup
// under the mirror croupier, for Hopper (sm_90a). Plain C entry point,
// loaded with ctypes by pysdm_tpu_torch/ops/cuda/breakup.py, which also holds
// the plain PyTorch twin of this function
// (coalesce_breakup_mirror_reference).
//
// Replaces the TPU kernel fused_breakup_mirror_blocks
// (pysdm_tpu/ops/pallas/breakup.py:340, body _mk_breakup_kernel :133,
// helpers _transfer_closed_form_f32 :69 and _fragmentation_limiters_f32
// :122) and takes its semantics at every N: slot o pairs with
// po = (K - o) mod N; three pair-keyed draws u01_hash(seed ^ mix,
// min(o, po)) pick gamma, the process and the fragment size; the collision
// kernel, Ec, Eb and the fragment mass are evaluated here by id.
//
// Design:
// - one thread per slot, 256-thread blocks. Both members of a pair read only
//   the inputs and recompute the pair's arithmetic from the role-resolved
//   (j, k) values, so both get bit-identical results; each thread writes
//   its own slot into separate output buffers, so no thread can read a
//   value its partner has already updated;
// - multiplicities are native int64: gamma = min(cap, xi_j / xi_k) is an
//   exact division and the coalescence branch exact integer arithmetic.
//   The TPU kernel walks an f32 quotient estimate +-5 steps over u32 limbs
//   instead, which misses the floor for quotients above ~2^26;
// - the breakup transfer runs in float32 as on the TPU, every product, sum
//   and quotient rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn; the
//   library is built with -fmad=false, without fast math), NaN-propagating
//   minima and maxima as XLA's, and inf or NaN in a candidate read as
//   invalid by the +-4 correction walks. Integer powers are repeated
//   products (XLA's integer_pow); expf, logf, log1pf and powf are CUDA's
//   accurate versions, a few ulps from the CPU's;
// - extensive rows are read and converted to float32 and the float32
//   result is written back in the state's type, at every slot, as the TPU
//   kernel does;
// - the five rate sums are deterministic: a fixed-order shared-memory tree
//   per block writes per-block partials, and a one-block second pass sums
//   them in fixed order. No float atomics.
//
// What bounds it on the card: each input read once and each output written
// once, a slot moves 32 B (multiplicity 8 in and 8 out, one float32
// extensive row 4 in and 4 out, two float32 attribute rows 8 in; the
// partner's reads hit the caches), 4.2 MB at config #2's 2^17 slots, ~1.3
// us at 3.35 TB/s. Its float32 work is ~60 operations a slot (the Berry
// efficiency's four powf at every slot) and ~150 more where the pair
// breaks up (the transfer's nine expf), ~0.1 us at the card's float32
// rate. So it is bound by bytes, and at these sizes by its two launches and
// a short grid; within a warp the transfer of one breaking slot holds the
// others (divergence), which only the launch of separate passes would
// avoid.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sdm_pair.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int N_SUMS = 5;
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24
constexpr uint32_t SEED_PROCESS = 0xA5A5A5A5u;
constexpr uint32_t SEED_FRAGMENT = 0x3C3C3C3Cu;

using sdm::BIG;
using sdm::u32_to_f32;
using sdm::u64_to_f32;

enum KernelId { GOLOVIN = 0, CONSTANT_K = 1, LINEAR = 2, GEOMETRIC = 3 };
enum EcId { EC_CONST = 0, EC_BERRY1967 = 1 };
enum FragId { FRAG_ALWAYS_N = 0, FRAG_CONSTANT_MASS = 1, FRAG_EXPONENTIAL = 2 };

}  // namespace

// the four functions of a substep, as ops/cuda/breakup.py packs them:
// kernel (k0, k1); Ec's and Eb's constant; fragment mass: AlwaysN f0 = n,
// ConstantMass f0 = c, Exponential f0 = -scale, f1 = vmin, f2 = nfmax (<= 0:
// none), f3 = rho_w
struct PairFunctions {
  int kernel_id;
  float k0, k1;
  int ec_id;
  float ec0;
  int eb_id;
  float eb0;
  int frag_id;
  float f0, f1, f2, f3;
};

namespace {

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

// XLA's minimum and maximum: NaN if either operand is NaN
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float pow4(float x) {
  const float x2 = mul(x, x);
  return mul(x2, x2);
}
__device__ __forceinline__ float pow8(float x) { return pow4(mul(x, x)); }

__device__ __forceinline__ float kernel_value(const PairFunctions& f, float va,
                                              float vb, float ra, float rb,
                                              float ua, float ub) {
  switch (f.kernel_id) {
    case GOLOVIN:
      return mul(f.k0, add(va, vb));
    case CONSTANT_K:
      return add(f.k0, mul(0.0f, va));
    case LINEAR:
      return add(f.k0, mul(f.k1, add(va, vb)));
    default: {  // GEOMETRIC: pi E_c (r + r')^2 |u - u'|
      const float r_sum = add(ra, rb);
      return mul(mul(f.k0, mul(r_sum, r_sum)), fabsf(sub(ua, ub)));
    }
  }
}

// Berry 1967 (pysdm_tpu/dynamics/collisions/collision_kernels.py:121-138,
// coalescence_efficiencies.py:30-37), clipped to [0, 1]
__device__ float berry_1967_ec(float ra, float rb) {
  const float unit = 1e-6f;
  const float r = dvd(jmax(ra, rb), unit);
  const float r_s = dvd(jmin(ra, rb), unit);
  const float p = dvd(r_s, r > 0.0f ? r : 1.0f);
  const float G = add(add(pow8(dvd(16.7f, r)), 1.0f), mul(0.004f, r));
  const float one_minus_p = jmin(jmax(sub(1.0f, p), 0.0f), 1.0f);
  const float Gp = powf(one_minus_p, G);
  const float D = dvd(-27.0f, powf(r, 1.65f));
  const float E = dvd(-58.0f, powf(r, 1.9f));
  const float F = add(pow4(dvd(15.0f, r)), 1.13f);
  const bool inside = (p > 0.0f) && (p < 1.0f);
  const float safe_p = inside ? p : 0.5f;
  const float safe_Gp = Gp != 0.0f ? Gp : 1.0f;
  float Y = add(add(add(1.0f, mul(1.0f, p)), dvd(D, powf(safe_p, F))),
                dvd(E, safe_Gp));
  Y = (inside && Gp != 0.0f) ? Y : 0.0f;
  Y = jmax(Y, 0.0f);
  return jmin(jmax(Y, 0.0f), 1.0f);
}

__device__ float fragment_mass(const PairFunctions& f, float mass_a,
                               float mass_b, float u) {
  const float mass_sum = add(mass_a, mass_b);
  switch (f.frag_id) {
    case FRAG_ALWAYS_N:
      return dvd(mass_sum, f.f0);
    case FRAG_CONSTANT_MASS:
      return f.f0;
    default: {  // FRAG_EXPONENTIAL
      float v = mul(f.f0, logf(jmax(sub(1.0f, u), 1e-30f)));
      v = jmax(v, f.f1);
      float m = mul(v, f.f3);
      if (f.f2 > 0.0f) {
        const float n_fragment = jmin(dvd(mass_sum, jmax(m, 0.0f)), f.f2);
        m = dvd(mass_sum, n_fragment);
      }
      return m;
    }
  }
}

struct Transfer {
  float take, nmk, g;
};

// the de Jong/Mackay transfer in closed form, float32
// (pysdm_tpu/ops/pallas/breakup.py:69-119)
struct TransferForm {
  float gamma_f, mult_j, mk, max_mult, alpha, beta_safe, log1pb;
  bool beta_pos;

  __device__ void pair_values(float g, float* nmk, float* tfj) const {
    const float p = expf(mul(sub(g, 1.0f), log1pb));
    *nmk = mul(mul(mk, alpha), p);
    *tfj = beta_pos ? mul(mk, add(1.0f, dvd(mul(alpha, sub(p, 1.0f)), beta_safe)))
                    : mul(mk, add(1.0f, mul(sub(g, 1.0f), alpha)));
  }

  __device__ bool valid(float g) const {
    float nmk, tfj;
    pair_values(g, &nmk, &tfj);
    return (g >= 1.0f) && (g <= gamma_f) && (nmk <= max_mult) &&
           (tfj <= mult_j);
  }
};

__device__ Transfer transfer_closed_form(float gamma_f, float mult_j,
                                         float mult_k, float mass_j,
                                         float mass_k, float fm,
                                         float max_mult) {
  const float tiny = 1e-30f;
  fm = jmax(fm, tiny);
  TransferForm t;
  t.gamma_f = gamma_f;
  t.mult_j = mult_j;
  t.mk = mult_k;
  t.max_mult = max_mult;
  t.alpha = dvd(add(mass_j, mass_k), fm);
  const float beta = dvd(mass_j, fm);
  t.beta_pos = beta > 0.0f;
  t.beta_safe = t.beta_pos ? beta : 1.0f;
  t.log1pb = log1pf(t.beta_safe);
  const float alpha_safe = jmax(t.alpha, tiny);

  const float g1 =
      add(floorf(dvd(logf(dvd(max_mult, mul(t.mk, alpha_safe))), t.log1pb)),
          1.0f);
  const float ratio = sub(dvd(mult_j, t.mk), 1.0f);
  float g2;
  if (t.beta_pos) {
    const float rhs2 = add(1.0f, dvd(mul(t.beta_safe, ratio), alpha_safe));
    g2 = add(floorf(dvd(logf(jmax(rhs2, 1.0f)), t.log1pb)), 1.0f);
  } else {
    g2 = add(floorf(dvd(ratio, alpha_safe)), 1.0f);
  }
  float g = jmin(jmin(g1, g2), gamma_f);
  g = jmin(jmax(g, 0.0f), gamma_f);
  if (isnan(g)) g = 0.0f;
  for (int i = 0; i < 4; ++i) {
    if (t.valid(add(g, 1.0f))) g = add(g, 1.0f);
  }
  for (int i = 0; i < 4; ++i) {
    if (!(t.valid(g) || g <= 0.0f)) g = sub(g, 1.0f);
  }
  g = jmax(g, 0.0f);
  float nmk, tfj;
  t.pair_values(jmax(g, 1.0f), &nmk, &tfj);
  Transfer out;
  out.take = g >= 1.0f ? tfj : 0.0f;
  out.nmk = g >= 1.0f ? nmk : t.mk;
  out.g = g;
  return out;
}

// fixed-order tree sums over the block; results valid in thread 0
__device__ __forceinline__ void block_sums(float (*red)[THREADS],
                                           const float* x) {
  const int t = threadIdx.x;
  for (int s = 0; s < N_SUMS; ++s) red[s][t] = x[s];
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      for (int s = 0; s < N_SUMS; ++s)
        red[s][t] = __fadd_rn(red[s][t], red[s][t + h]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) coalesce_breakup_mirror_kernel(
    const int64_t* __restrict__ mult, const T* __restrict__ ext, int n_ext,
    int wm_index, const float* __restrict__ volume,
    const float* __restrict__ radius, const float* __restrict__ vfall,
    PairFunctions f, const float* __restrict__ scale, int64_t n, int64_t K,
    uint32_t seed, float max_mult, int64_t* __restrict__ mult_out,
    T* __restrict__ ext_out, float* __restrict__ partials) {
  __shared__ float red[N_SUMS][THREADS];
  const int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float sums[N_SUMS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
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
    const bool i_am_j = in_pair && a_is_j;

    const float va = volume ? volume[o] : 0.0f, vb = volume ? volume[po] : 0.0f;
    const float ra = radius ? radius[o] : 0.0f, rb = radius ? radius[po] : 0.0f;
    const float ua = vfall ? vfall[o] : 0.0f, ub = vfall ? vfall[po] : 0.0f;
    const float kn = mul(kernel_value(f, va, vb, ra, rb, ua, ub), scale[0]);
    const float Ec = f.ec_id == EC_BERRY1967 ? berry_1967_ec(ra, rb) : f.ec0;
    const float Eb = f.eb0;

    const uint32_t pair_id = (uint32_t)(o < po ? o : po);
    const float u_gamma = u01_hash(seed, pair_id);
    const float u_proc = u01_hash(seed ^ SEED_PROCESS, pair_id);

    const float mj_f = u64_to_f32((uint64_t)mj);
    float gamma_f = jmax(ceilf(sub(mul(mj_f, kn), u_gamma)), 0.0f);
    if (!in_pair) gamma_f = 0.0f;
    const int64_t cap = (int64_t)fminf(gamma_f, BIG);
    int64_t g = 0;
    if (in_pair) {
      const int64_t q = mj / mk;
      g = q < cap ? q : cap;
    }
    const float gf = u32_to_f32((uint32_t)g);
    const float mk_f = u64_to_f32((uint64_t)mk);

    // process: bounce if u > Ec + (1 - Ec) Eb, coalesce if u < Ec, else
    // break up
    const bool active = in_pair && g > 0;
    const bool bouncing = sub(u_proc, add(Ec, mul(sub(1.0f, Ec), Eb))) > 0.0f;
    const bool do_coal = active && !bouncing && sub(u_proc, Ec) < 0.0f;
    const bool do_break = active && !bouncing && !do_coal;

    int64_t m_new = a;
    bool split = false;
    if (do_coal) {
      // Shima update: xi_j -= gamma xi_k; an exhausted j takes half of k
      const int64_t nn = mj - g * mk;
      split = nn == 0;
      const int64_t half = mk >> 1;
      m_new = i_am_j ? (split ? half : nn) : (split ? mk - half : mk);
    }
    float gjk = 0.0f;
    if (do_break) {
      const float wj = (float)ext[(int64_t)wm_index * n + (i_am_j ? o : po)];
      const float wk = (float)ext[(int64_t)wm_index * n + (i_am_j ? po : o)];
      const float mass_j = fabsf(wj), mass_k = fabsf(wk);
      const float mass_sum = add(mass_j, mass_k);
      // the fragment mass sees the pair in slot order, as the TPU kernel's
      const float w_own = (float)ext[(int64_t)wm_index * n + o];
      const float w_oth = (float)ext[(int64_t)wm_index * n + po];
      const float u_frag = u01_hash(seed ^ SEED_FRAGMENT, pair_id);
      float fm = fragment_mass(f, fabsf(w_own), fabsf(w_oth), u_frag);
      fm = (isnan(fm) || fm <= 0.0f) ? mass_sum : fm;
      fm = jmin(fm, mass_sum);
      fm = mass_sum <= 0.0f ? 1.0f : fm;
      const Transfer t = transfer_closed_form(
          gf, mj_f, jmax(mk_f, 1.0f), mass_j, mass_k, fm, max_mult);
      gjk = t.g;
      const bool deplete = t.take >= mj_f;
      const float nj = deplete ? mul(t.nmk, 0.5f) : sub(mj_f, t.take);
      const float nk = deplete ? mul(t.nmk, 0.5f) : t.nmk;
      const float bj = jmax(rintf(nj), 1.0f);
      const float bk = jmax(rintf(nk), 1.0f);
      m_new = (int64_t)(i_am_j ? bj : bk);
      const float nmk_safe = jmax(t.nmk, 1e-30f);
      for (int r = 0; r < n_ext; ++r) {
        const float ej = (float)ext[(int64_t)r * n + (i_am_j ? o : po)];
        const float ek = (float)ext[(int64_t)r * n + (i_am_j ? po : o)];
        const float ek_mix = dvd(add(mul(ek, mk_f), mul(t.take, ej)), nmk_safe);
        const float e_new = i_am_j ? mul(deplete ? ek_mix : ej, dvd(nj, bj))
                                   : mul(ek_mix, dvd(nk, bk));
        ext_out[(int64_t)r * n + o] = (T)e_new;
      }
    } else {
      for (int r = 0; r < n_ext; ++r) {
        const float e_own = (float)ext[(int64_t)r * n + o];
        float e_new = e_own;
        if (do_coal) {
          const float e_oth = (float)ext[(int64_t)r * n + po];
          const float ej = i_am_j ? e_own : e_oth;
          const float ek = i_am_j ? e_oth : e_own;
          const float merged = add(ek, mul(gf, ej));
          e_new = i_am_j ? (split ? merged : ej) : merged;
        }
        ext_out[(int64_t)r * n + o] = (T)e_new;
      }
    }
    mult_out[o] = m_new;

    if (isf) {
      sums[0] = mul(gf, mk_f);
      sums[1] = mul(sub(gamma_f, gf), mk_f);
      if (do_coal) sums[2] = mul(gf, mk_f);
      if (do_break) {
        sums[3] = mul(gjk, mk_f);
        sums[4] = mul(sub(gf, gjk), mk_f);
      }
    }
  }
  block_sums(red, sums);
  if (threadIdx.x == 0) {
    for (int s = 0; s < N_SUMS; ++s)
      partials[(int64_t)s * gridDim.x + blockIdx.x] = red[s][0];
  }
}

// second pass: sums the per-block partials in fixed order
__global__ void __launch_bounds__(THREADS)
    finish_sums_kernel(const float* __restrict__ partials, int n_blocks,
                       float* __restrict__ out) {
  __shared__ float red[N_SUMS][THREADS];
  float x[N_SUMS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_blocks; i += THREADS) {
    for (int s = 0; s < N_SUMS; ++s)
      x[s] = __fadd_rn(x[s], partials[(int64_t)s * n_blocks + i]);
  }
  block_sums(red, x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < N_SUMS; ++s) out[s] = red[s][0];
  }
}

}  // namespace

extern "C" {

// number of float partials the caller allocates for n slots
long long pysdm_coalesce_breakup_mirror_partials(long long n) {
  return N_SUMS * ((n + THREADS - 1) / THREADS);
}

// one substep; returns cudaGetLastError() after the launches (0 = success).
// mult, mult_out: int64 (n,); ext, ext_out: (n_ext, n) float or double
// (ext_is_f64), row wm_index the signed water mass; volume, radius, vfall:
// float (n,) rows, NULL where the functions do not read them; f: the
// functions (host memory); scale: float (1,) on the device; partials: float
// (pysdm_coalesce_breakup_mirror_partials(n),); sums: float (5,) receives
// the collision rate, its deficit, the coalescence rate, the breakup rate
// and the breakup deficit.
int pysdm_coalesce_breakup_mirror(
    const void* mult, const void* ext, int ext_is_f64, int n_ext,
    int wm_index, const void* volume, const void* radius, const void* vfall,
    const PairFunctions* f, const void* scale, long long n, long long K,
    unsigned int seed, float max_mult, void* mult_out, void* ext_out,
    void* partials, void* sums, void* stream) {
  const int n_blocks = (int)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    coalesce_breakup_mirror_kernel<double><<<n_blocks, THREADS, 0, s>>>(
        (const int64_t*)mult, (const double*)ext, n_ext, wm_index,
        (const float*)volume, (const float*)radius, (const float*)vfall, *f,
        (const float*)scale, n, K, seed, max_mult, (int64_t*)mult_out,
        (double*)ext_out, (float*)partials);
  } else {
    coalesce_breakup_mirror_kernel<float><<<n_blocks, THREADS, 0, s>>>(
        (const int64_t*)mult, (const float*)ext, n_ext, wm_index,
        (const float*)volume, (const float*)radius, (const float*)vfall, *f,
        (const float*)scale, n, K, seed, max_mult, (int64_t*)mult_out,
        (float*)ext_out, (float*)partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_sums_kernel<<<1, THREADS, 0, s>>>((const float*)partials, n_blocks,
                                           (float*)sums);
  return (int)cudaGetLastError();
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
