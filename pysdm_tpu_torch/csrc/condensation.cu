// Per-drop implicit condensation solve (K3) for Hopper (sm_90a). Plain C
// entry point, loaded with ctypes by pysdm_tpu_torch/ops/cuda/condensation.py,
// which also holds the plain PyTorch twin of this function
// (masses_new_reference).
//
// Replaces the TPU kernel fused_masses_new, built by make_fused_masses_new
// (pysdm_tpu/ops/pallas/condensation.py:37/:255, pallas_call :299, body
// _kernel :72-252). Per drop, in float32: the thermodynamic state of its
// cell (T, p, pv, lv, pvs, D, K, RH), the Koehler RH_eq, the Fuchs-Sutugin
// corrected D and K, Fk, Fd and the explicit estimate dx_old; the
// within-tolerance equilibrium test; a bracket expanded in the direction of
// minfun's own sign (8-ulp step floor, fa == 0 short-circuit, up to
// max_iters doublings); bisection to hi - lo <= rtol_x |x_old| + 1e-30 or
// an exact zero of minfun, at most min(bisect_iters, 40) halvings; then
// (mass_new, success), where
// inactive drops keep their mass and a non-finite root keeps the old mass
// and fails.
//
// Design:
// - one thread per drop, 256-thread blocks, the ragged edge masked;
// - the per-cell rows (thd, qv, rhod, dt_sub, active, rho_air, mu_air) are
//   read through the drop's cell id. The TPU kernel takes them expanded to
//   drops (seven more rows) and the one-hot matmul that expanded them
//   exists only because TPU gathers are slow;
// - the drop is active when its cell is, its multiplicity is above zero
//   and its water mass is positive;
// - stopping rule: each thread stops bisecting when its own bracket is
//   within tolerance, or when minfun is exactly 0 at a midpoint, which is
//   then the root. The TPU kernel stops when its whole 32768-drop block has
//   converged, the JAX XLA path when every drop has (a global any). All
//   three land within rtol_x |x_old| of the same root but are not
//   bit-equal. Both JAX rules take an exact zero for "root above" and walk
//   the lower end up to the upper one, a bracket's width from the root; in
//   float32, where minfun near the root moves in steps of an ulp of x_old,
//   that happens to about one drop in 10^4 (ROADMAP queue 3);
// - the formula variants of the parcel slice are switches (diffusion
//   coordinate, hygroscopicity, drop growth, diffusion kinetics); the
//   wrapper refuses any other variant set. Constants come by value in
//   K3Params, rounded to float32 where the JAX kernel rounds them:
//   Python-float products such as 2 sigma / Rv are folded in double first;
//   D and K are float32;
// - every operation is rounded on its own (the library is built with
//   -fmad=false), in the JAX kernel's order; expf, logf and powf differ
//   from XLA's by an ulp or two, so results agree to a tolerance, not bit
//   for bit.
//
// What bounds it on the card: about 29 bytes of device memory per drop
// (water mass, dry volume, kappa, multiplicity, cell id in; mass and
// success out), 3.8 MB at 2^17 drops, against up to ~58 minfun evaluations
// per drop, each an expf (the log coordinate), a powf (the cube root) and
// ~10 IEEE divisions. Measured on an H100 SXM at 700 W: 0.023 ms at 2^17
// drops and 0.12 ms at 2^20, 13-20 times what its bytes take at 3.35 TB/s,
// so the arithmetic bounds it: special functions and divisions, with the
// threads of a warp running as many iterations as the slowest of them. A
// faster kernel needs fewer evaluations per drop, not fewer bytes.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct K3Params {
  // state-variable triplet (libcloudph++)
  float T0, p1000, Rd, Rv, eps, T_exponent;  // Rd/cpd / (1 - Rd/cpd)
  // latent heat (Kirchhoff)
  float l_tri, c_pv_minus_c_pw, T_tri;
  // saturation vapour pressure (Flatau, Walko and Cotton), C0..C8
  float fwc[9];
  // diffusion thermics (Neglect)
  float D0, K0;
  // particle shape and trivia
  float rho_w, pi_4_3, one_third;
  // Koehler: 2 sigma_w / Rv
  float koehler_A;
  // Fuchs-Sutugin: (4/5) K0, 2 Rd, 2 Rv, 4/3/MAC + 0.377, 4/3/MAC, and the
  // same for HAC
  float lambdaK_coef, two_Rd, two_Rv, mac_a, mac_b, hac_a, hac_b;
  // drop growth: rho_w Rv, 4 pi rho_w
  float rho_w_Rv, four_pi_rho_w;
  float x_max, RH_rtol, rtol_x;
  int max_iters, bisect_cap;
  int coordinate;  // 0 WaterMass, 1 WaterMassLogarithm
  int hygroscopicity;  // 0 KappaKoehler, 1 KappaKoehlerLeadingTerms
  int drop_growth;  // 0 Fick, 1 Howell1949, 2 Mason1971
  int kinetics;  // 0 FuchsSutugin, 1 Neglect
};

}  // extern "C"

namespace {

constexpr int THREADS = 256;

// maximum and minimum that propagate NaN, as jnp.maximum/torch.maximum do
// (fmaxf and fminf return the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

struct Drop {
  float x_old, dt_sub, kappa, rd3, T, RH, Fk, Fd;
};

__device__ __forceinline__ float coord_mass(const K3Params& c, float x) {
  return c.coordinate == 1 ? expf(x) : x;
}

__device__ __forceinline__ float coord_x(const K3Params& c, float mass) {
  return c.coordinate == 1 ? logf(mass) : mass;
}

__device__ __forceinline__ float coord_dx_dt(const K3Params& c, float m,
                                             float dm_dt) {
  return c.coordinate == 1 ? dm_dt / m : dm_dt;
}

__device__ __forceinline__ float radius_of_volume(const K3Params& c,
                                                  float volume) {
  return powf(volume / c.pi_4_3, c.one_third);
}

__device__ __forceinline__ float RH_eq(const K3Params& c, float r, float T,
                                       float kp, float rd3) {
  const float a = c.koehler_A / T / c.rho_w / r;
  const float r3 = r * r * r;
  if (c.hygroscopicity == 0) {  // KappaKoehler
    return expf(a) * (r3 - rd3) / (r3 - rd3 * (1.0f - kp));
  }
  return 1.0f + a - kp * rd3 / r3;  // KappaKoehlerLeadingTerms
}

__device__ __forceinline__ float r_dr_dt(const K3Params& c, float RH_eq,
                                         float RH, float Fk, float Fd) {
  return c.drop_growth == 0 ? (RH - RH_eq) / Fd : (RH - RH_eq) / (Fk + Fd);
}

__device__ __forceinline__ float dm_dt(const K3Params& c, float r,
                                       float rdrdt) {
  return c.four_pi_rho_w * r * rdrdt;
}

__device__ float minfun(const K3Params& c, float x_new, const Drop& d) {
  if (x_new > c.x_max) return d.x_old - x_new;
  const float mass_new = coord_mass(c, x_new);
  const float volume_new = mass_new / c.rho_w;
  const float r_new = radius_of_volume(c, volume_new);
  const float eq = RH_eq(c, r_new, d.T, d.kappa, d.rd3);
  const float dmdt = dm_dt(c, r_new, r_dr_dt(c, eq, d.RH, d.Fk, d.Fd));
  return d.x_old - x_new + d.dt_sub * coord_dx_dt(c, mass_new, dmdt);
}

// Fuchs-Sutugin transition-regime correction of D (or K)
__device__ __forceinline__ float fuchs_sutugin(float D, float r, float lmbd,
                                               float a, float b) {
  const float den = 1.0f + a * lmbd / r + b * lmbd / r * lmbd / r;
  return D * (1.0f + lmbd / r) / den;
}

__global__ void masses_new_kernel(
    const float* __restrict__ water_mass, const float* __restrict__ vdry,
    const float* __restrict__ kappa, const int64_t* __restrict__ multiplicity,
    const int32_t* __restrict__ cell_id, const float* __restrict__ cell_thd,
    const float* __restrict__ cell_qv, const float* __restrict__ cell_rhod,
    const float* __restrict__ cell_dt_sub,
    const uint8_t* __restrict__ cell_active,
    // air density and viscosity enter only through the Schmidt number of
    // the ventilation coefficient, which is 1 under ventilation Neglect
    const float* __restrict__ cell_rho_air,
    const float* __restrict__ cell_mu_air, int n, int n_cell,
    const K3Params c, float* __restrict__ mass_out,
    uint8_t* __restrict__ success_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wm = water_mass[i];
  int cell = cell_id[i];
  cell = cell < 0 ? 0 : (cell >= n_cell ? n_cell - 1 : cell);

  // the cell's thermodynamic state (JAX compute_cell_thermo)
  const float thd = cell_thd[cell];
  const float qv = cell_qv[cell];
  const float rhod = cell_rhod[cell];
  const float T = thd * powf(rhod * thd / c.p1000 * c.Rd, c.T_exponent);
  const float q1 = 1.0f + qv;
  const float p = rhod * q1 * (c.Rv / (1.0f / qv + 1.0f) + c.Rd / q1) * T;
  const float pv = p * qv / (qv + c.eps);
  const float lv = c.l_tri + c.c_pv_minus_c_pw * (T - c.T_tri);
  const float dT = T - c.T0;
  float pvs = c.fwc[8];
  for (int k = 7; k >= 0; --k) pvs = c.fwc[k] + dT * pvs;
  const float RH = pv / pvs;

  const bool active = cell_active[cell] != 0 && multiplicity[i] > 0 &&
                      wm > 0.0f;
  const float safe_mass = active ? wm : 1e-18f;
  const float v_drop = safe_mass / c.rho_w;
  const float x_old = coord_x(c, safe_mass);
  const float r_old = radius_of_volume(c, v_drop);
  const float vd = vdry[i];
  const float x_insane = coord_x(c, c.rho_w * (vd / 100.0f));
  const float rd3 = vd / c.pi_4_3;
  const float kp = kappa[i];
  const float eq_old = RH_eq(c, r_old, T, kp, rd3);

  float Dr = c.D0, Kr = c.K0;
  if (c.kinetics == 0) {
    const float lambdaK = c.lambdaK_coef * T / p / sqrtf(c.two_Rd * T);
    const float lambdaD = c.D0 / sqrtf(c.two_Rv * T);
    Dr = fuchs_sutugin(c.D0, r_old, lambdaD, c.mac_a, c.mac_b);
    Kr = fuchs_sutugin(c.K0, r_old, lambdaK, c.hac_a, c.hac_b);
  }
  // ventilation Neglect: the coefficient is 1
  float Fk = 0.0f;
  if (c.drop_growth != 0) {
    const float heat = lv / T / c.Rv;
    Fk = c.rho_w * lv / T / Kr * (c.drop_growth == 2 ? heat - 1.0f : heat);
  }
  const float Fd = c.rho_w_Rv * T / Dr / pvs;

  const bool at_equilibrium = fabsf(RH - eq_old) < c.RH_rtol * fabsf(RH);
  const float dmdt_old = dm_dt(c, r_old, r_dr_dt(c, eq_old, RH, Fk, Fd));
  float dx_old = cell_dt_sub[cell] * coord_dx_dt(c, safe_mass, dmdt_old);
  if (at_equilibrium) dx_old = 0.0f;
  const bool need_solve = active && dx_old != 0.0f;

  const Drop d = {x_old, cell_dt_sub[cell], kp, rd3, T, RH, Fk, Fd};
  const float a = x_old;
  const float fa = minfun(c, a, d);

  // bracket in the direction of minfun's own sign, the step floored at 8
  // float32 ulps of x_old (JAX ops/condensation.py:167-192)
  const float dx_mag = nan_max(fabsf(dx_old), 9.5367431640625e-07f * fabsf(x_old));
  const float dx_step = fa > 0.0f ? dx_mag : -dx_mag;
  const bool converged_at_a = need_solve && fa == 0.0f;
  float b = nan_max(x_insane, a + dx_step);
  float fb = minfun(c, b, d);
  float scale = 2.0f;
  for (int k = 0; k < c.max_iters && need_solve && fa * fb >= 0.0f; ++k) {
    b = nan_max(x_insane, a + dx_step * scale);
    fb = minfun(c, b, d);
    scale *= 2.0f;
  }
  const bool bracketed = fa * fb < 0.0f || converged_at_a;
  const bool success = !need_solve || bracketed;
  const bool solving = need_solve && bracketed && !converged_at_a;

  float x_new = x_old;
  if (solving) {
    float lo = nan_min(a, b), hi = nan_max(a, b);
    float flo = a <= b ? fa : fb;
    const float tol = c.rtol_x * fabsf(x_old) + 1e-30f;
    for (int k = 0; k < c.bisect_cap && hi - lo - tol > 0.0f; ++k) {
      const float mid = 0.5f * (lo + hi);
      const float fmid = minfun(c, mid, d);
      if (fmid == 0.0f) {  // mid is the root (see the stopping rule above)
        lo = hi = mid;
        break;
      }
      if (flo * fmid < 0.0f) {
        hi = mid;
      } else {
        lo = mid;
        flo = fmid;
      }
    }
    x_new = 0.5f * (lo + hi);
  }
  float mass_new = active ? coord_mass(c, x_new) : wm;
  const bool finite = isfinite(mass_new);
  mass_out[i] = finite ? mass_new : wm;
  success_out[i] = (success && finite) || !active;
}

}  // namespace

extern "C" {

int pysdm_condensation_masses_new(
    const float* water_mass, const float* vdry, const float* kappa,
    const int64_t* multiplicity, const int32_t* cell_id,
    const float* cell_thd, const float* cell_qv, const float* cell_rhod,
    const float* cell_dt_sub, const uint8_t* cell_active,
    const float* cell_rho_air, const float* cell_mu_air, int n, int n_cell,
    const K3Params* params, float* mass_out, uint8_t* success_out,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  masses_new_kernel<<<blocks, THREADS, 0, stream>>>(
      water_mass, vdry, kappa, multiplicity, cell_id, cell_thd, cell_qv,
      cell_rhod, cell_dt_sub, cell_active, cell_rho_air, cell_mu_air, n,
      n_cell, *params, mass_out, success_out);
  return (int)cudaGetLastError();
}

const char* pysdm_condensation_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
