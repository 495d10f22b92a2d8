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
// max_iters doublings); a bracketing root search to
// |xb - xa| <= rtol_x |x_old| + 1e-30 or an exact zero of minfun, at most
// min(bisect_iters, 40) rounds; then (mass_new, success), where inactive
// drops keep their mass and a non-finite root keeps the old mass and fails.
//
// What bounds it on the card: arithmetic on a serial chain. A drop moves 29
// bytes (water mass, dry volume, kappa, multiplicity, cell id in; mass and
// success out), which take the card a small fraction of the kernel's time;
// its thread evaluates minfun once after the other, each evaluation waiting
// for the sign of the one before. So the design cuts what an evaluation
// costs, how many a drop needs, and who pays at all:
// - one thread per drop, 256-thread blocks, the ragged edge masked. An
//   inactive drop (its cell inactive, multiplicity 0 or no water) returns
//   after five loads; a drop at equilibrium (dx_old == 0) evaluates minfun
//   no time;
// - a cell's state (a powf, a polynomial, two sqrtf, a dozen divisions) is
//   computed once per block, not once per drop: where a block's drops lie
//   within eight cells of its first drop's (drops sorted by cell, or one
//   cell), eight threads compute those cells' states into shared memory;
//   else every active thread computes its own cell's with the same
//   function. A block without an active drop computes none;
// - what is left per drop before the solve: two logf, a cbrtf for the old
//   radius and ten quotients, taken as a reciprocal and a product
//   (__fdividef, 2 ulps) where they enter as a factor of the growth rate
//   (Fuchs-Sutugin, Fk, Fd) or of the old Koehler terms. RH and minfun's
//   own quotients are divided exactly: an ulp of RH is 1e-4 of a
//   supersaturation of 0.1%;
// - minfun is x_old - x + dt dx/dt(x). What does not depend on x is folded
//   into the Drop once (A = 2 sigma / Rv / T / rho_w, kappa rd^3, dt times
//   3 or 4 pi rho_w over Fk + Fd, RH - 1). The radius enters only as 1 / r
//   = rcbrtf(mass / (rho_w 4 pi / 3)); in the log coordinate dx/dt is
//   3 r dr/dt / r^2, the mass cancels, and with the leading-terms Koehler
//   curve an evaluation is one expf, one rcbrtf and ten multiplications and
//   additions, without a division (the earlier form: an expf, a powf and
//   about ten IEEE divisions). rcbrtf, not exp((x - log(rho_w 4 pi / 3)) /
//   -3): the latter's argument is rounded to an ulp of ~16, 1e-6 of the
//   radius, where rcbrtf keeps 2e-7. The supersaturation difference is
//   (RH - 1) - A / r + B / r^3, without rounding RH_eq to an ulp of 1;
// - the root search is Chandrupatla's: the next evaluation lies where an
//   inverse quadratic through the last three points crosses zero, if his
//   criterion calls that safe, else in the middle. The criterion fails on a
//   degenerate triple (the first round; a round that did not move; equal
//   values on the float32 plateau near the root, where minfun moves in
//   ulps of x_old), so those rounds bisect. The point keeps 3/4 of the
//   tolerance from both ends, so an interpolation that points next to an
//   end lands just across the root and closes the bracket at once. The
//   growing drops of chip_smoke.py's phase 5 need 4 rounds where halving
//   needed 16; the result is the middle of the last bracket, within
//   rtol_x |x_old| of the root as before;
// - a bracket that reaches past x_max (a 1 kg drop), where minfun continues
//   on another branch, is cut at x_max with one evaluation: above zero
//   there, the root lies beyond x_max and the drop fails and keeps its
//   mass, as a non-finite root does. Halving such a bracket stays astride
//   x_max for all 40 rounds: where its far end is so far out that the last
//   middle still overflows in expf (dt_sub = 1e30 s) the outcome is the
//   same, three evaluations for 42; where it is nearer (a step of 1e12 s)
//   the TPU kernel reports success with the mass of that middle, up to
//   tonnes, and this kernel reports the failure (ROADMAP, "a root beyond
//   x_max");
// - the per-cell rows (thd, qv, rhod, dt_sub, active, rho_air, mu_air) are
//   read through the drop's cell id. The TPU kernel takes them expanded to
//   drops (seven more rows) and the one-hot matmul that expanded them
//   exists only because TPU gathers are slow;
// - stopping rule: each thread stops when its own bracket is within
//   tolerance, or when minfun is exactly 0 at a point, which is then the
//   root. The TPU kernel stops when its whole 32768-drop block has
//   converged, the JAX XLA path when every drop has (a global any). All
//   three land within rtol_x |x_old| of the same root but are not
//   bit-equal. Both JAX rules take an exact zero for "root above" and walk
//   the lower end up to the upper one, a bracket's width from the root; in
//   float32 that happens to about one drop in 10^4 (ROADMAP, "exact zero
//   of minfun");
// - the formula variants of the parcel slice are switches (diffusion
//   coordinate, hygroscopicity, drop growth, diffusion kinetics); the
//   wrapper refuses any other variant set. Constants come by value in
//   K3Params, rounded to float32; Python-float products such as
//   2 sigma / Rv are folded in double first; D and K are float32;
// - the twin repeats the arithmetic to rounding, not bit for bit: this
//   source is built with FMA contraction (the port's other kernels with
//   -fmad=false), the fast quotients above are 2 ulps off, and expf, logf,
//   powf, cbrtf and rcbrtf differ from torch's by an ulp or two. The
//   quotients that place the next evaluation inside the bracket are fast
//   ones too: any point inside keeps the bracket. Kernel and twin agree
//   on success drop for drop and on the mass to the bound that
//   chip_smoke.compare_k3 states.
//
// Measured times, evaluation counts and the earlier design's stand in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>
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
  float per_mass;  // 1 / (rho_w 4 pi / 3): r^3 = mass * per_mass
  int max_iters, bisect_cap;
  int coordinate;  // 0 WaterMass, 1 WaterMassLogarithm
  int hygroscopicity;  // 0 KappaKoehler, 1 KappaKoehlerLeadingTerms
  int drop_growth;  // 0 Fick, 1 Howell1949, 2 Mason1971
  int kinetics;  // 0 FuchsSutugin, 1 Neglect
};

}  // extern "C"

namespace {

constexpr int THREADS = 256;

// a maximum that propagates NaN, as jnp.maximum/torch.maximum do (fmaxf
// returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// what minfun needs of a drop, folded once
struct Drop {
  float x_old;
  float A;           // 2 sigma / Rv / T / rho_w: the Kelvin term is A / r
  float B;           // kappa rd^3 (leading terms)
  float rd3;         // (KappaKoehler)
  float rd3_solute;  // rd^3 (1 - kappa) (KappaKoehler)
  float rate;        // dt_sub * (3 | 4 pi rho_w) / (Fd | Fk + Fd)
  float RH, RH_minus_1;
};

__device__ __forceinline__ float coord_mass(const K3Params& c, float x) {
  return c.coordinate == 1 ? expf(x) : x;
}

__device__ __forceinline__ float coord_x(const K3Params& c, float mass) {
  return c.coordinate == 1 ? logf(mass) : mass;
}

// a / b to 2 ulps (a reciprocal and a product) where the quotient enters
// the result as a factor of the growth rate or only steers the search; the
// supersaturation and minfun's own quotients are divided exactly
__device__ __forceinline__ float fast_div(float a, float b) {
  return __fdividef(a, b);
}

// what the solve needs of a cell's thermodynamic state
struct CellThermo {
  float RH;
  float A;  // 2 sigma / Rv / T / rho_w
  float lambdaK, lambdaD;
  float Fk_K;  // Fk = Fk_K / K(r)
  float Fd_D;  // Fd = Fd_D / D(r)
};

// the cell's state from (thd, qv, rhod) (JAX compute_cell_thermo), with
// exact divisions: an ulp of RH is 1e-4 of a supersaturation of 0.1%
__device__ CellThermo cell_thermo(const K3Params& c, float thd, float qv,
                                  float rhod) {
  const float T = thd * powf(rhod * thd / c.p1000 * c.Rd, c.T_exponent);
  const float q1 = 1.0f + qv;
  const float p = rhod * q1 * (c.Rv / (1.0f / qv + 1.0f) + c.Rd / q1) * T;
  const float pv = p * qv / (qv + c.eps);
  const float lv = c.l_tri + c.c_pv_minus_c_pw * (T - c.T_tri);
  const float dT = T - c.T0;
  float pvs = c.fwc[8];
  for (int k = 7; k >= 0; --k) pvs = c.fwc[k] + dT * pvs;
  CellThermo t;
  t.RH = pv / pvs;
  t.A = c.koehler_A / T / c.rho_w;
  t.lambdaK = c.lambdaK_coef * T / p / sqrtf(c.two_Rd * T);
  t.lambdaD = c.D0 / sqrtf(c.two_Rv * T);
  const float heat = lv / T / c.Rv;
  // ventilation Neglect: the coefficient is 1
  t.Fk_K = c.drop_growth == 0
               ? 0.0f
               : c.rho_w * lv / T * (c.drop_growth == 2 ? heat - 1.0f : heat);
  t.Fd_D = c.rho_w_Rv * T / pvs;
  return t;
}

// RH_eq at the drop's old radius r (r3 = r^3)
__device__ __forceinline__ float RH_eq(const K3Params& c, float r, float r3,
                                       float A, float kp, float rd3) {
  const float a = fast_div(A, r);
  if (c.hygroscopicity == 0) {  // KappaKoehler
    return expf(a) * fast_div(r3 - rd3, r3 - rd3 * (1.0f - kp));
  }
  return 1.0f + a - fast_div(kp * rd3, r3);  // KappaKoehlerLeadingTerms
}

// x_old - x + dt dx/dt(x); past x_max, x_old - x
__device__ __forceinline__ float minfun(const K3Params& c, float x_new,
                                        const Drop& d) {
  const float gap = d.x_old - x_new;
  if (x_new > c.x_max) return gap;
  const float r3 = (c.coordinate == 1 ? expf(x_new) : x_new) * c.per_mass;
  const float inv_r = rcbrtf(r3);
  const float inv_r2 = inv_r * inv_r;
  float excess;  // RH - RH_eq(r)
  if (c.hygroscopicity == 1) {
    excess = d.RH_minus_1 - d.A * inv_r + d.B * (inv_r2 * inv_r);
  } else {
    excess = d.RH - expf(d.A * inv_r) * (r3 - d.rd3) / (r3 - d.rd3_solute);
  }
  const float growth = c.coordinate == 1 ? d.rate * excess * inv_r2
                                         : d.rate * excess / inv_r;
  return gap + growth;
}

#ifdef K3_MINFUN_PROBE
// one evaluation of minfun per thread under the default variant set (log
// coordinate, leading-terms Koehler curve; set here, so the compiler drops
// the other variants' branches), between two loads and a store: its SASS is
// what an evaluation costs (tools/kernel_resources.py counts it)
__global__ void minfun_probe_kernel(K3Params c, const Drop* __restrict__ d,
                                    const float* __restrict__ x,
                                    float* __restrict__ out) {
  c.coordinate = 1;
  c.hygroscopicity = 1;
  out[threadIdx.x] = minfun(c, x[threadIdx.x], d[threadIdx.x]);
}
#endif

// Fuchs-Sutugin transition-regime correction of D (or K)
__device__ __forceinline__ float fuchs_sutugin(float D, float r, float lmbd,
                                               float a, float b) {
  const float q = fast_div(lmbd, r);
  return D * fast_div(1.0f + q, 1.0f + a * q + b * q * q);
}

// cells whose state a block keeps in shared memory
constexpr int CELL_SPAN = 8;

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
  __shared__ int first_cell;
  __shared__ CellThermo cells[CELL_SPAN];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  float wm = 0.0f;
  int cell = 0;
  bool active = false;
  if (valid) {
    wm = water_mass[i];
    cell = cell_id[i];
    cell = cell < 0 ? 0 : (cell >= n_cell ? n_cell - 1 : cell);
    active = cell_active[cell] != 0 && multiplicity[i] > 0 && wm > 0.0f;
  }
  // the cells of a block's drops: where the drops come sorted by cell, or
  // from one cell, they lie within CELL_SPAN of the first drop's, and eight
  // threads compute their states once for the block; else every active
  // thread computes its own cell's (the same function, the same result)
  if (threadIdx.x == 0) first_cell = cell;
  __syncthreads();
  const int slot = cell - first_cell;
  const bool in_span =
      __syncthreads_and(!valid || (slot >= 0 && slot < CELL_SPAN));
  const bool any_active = __syncthreads_or(active);
  if (in_span && any_active) {
    const int k = first_cell + threadIdx.x;
    if (threadIdx.x < CELL_SPAN && k < n_cell) {
      cells[threadIdx.x] = cell_thermo(c, cell_thd[k], cell_qv[k], cell_rhod[k]);
    }
    __syncthreads();
  }
  if (!valid) return;
  if (!active) {
    // inactive: the drop keeps its mass and counts as solved
    mass_out[i] = wm;
    success_out[i] = 1;
    return;
  }
  const CellThermo t =
      in_span ? cells[slot]
              : cell_thermo(c, cell_thd[cell], cell_qv[cell], cell_rhod[cell]);
  const float RH = t.RH;
  const float A = t.A;
  const float dt_sub = cell_dt_sub[cell];

  const float r3_old = wm * c.per_mass;
  const float r_old = cbrtf(r3_old);
  const float x_old = coord_x(c, wm);
  const float vd = vdry[i];
  const float x_insane = coord_x(c, c.rho_w * (vd * 0.01f));
  const float rd3 = fast_div(vd, c.pi_4_3);
  const float kp = kappa[i];
  const float eq_old = RH_eq(c, r_old, r3_old, A, kp, rd3);

  float Dr = c.D0, Kr = c.K0;
  if (c.kinetics == 0) {
    Dr = fuchs_sutugin(c.D0, r_old, t.lambdaD, c.mac_a, c.mac_b);
    Kr = fuchs_sutugin(c.K0, r_old, t.lambdaK, c.hac_a, c.hac_b);
  }
  const float Fk = fast_div(t.Fk_K, Kr);
  const float Fd = fast_div(t.Fd_D, Dr);
  const float inv_F = fast_div(1.0f, c.drop_growth == 0 ? Fd : Fk + Fd);

  const bool at_equilibrium = fabsf(RH - eq_old) < c.RH_rtol * fabsf(RH);
  const float dmdt_old = c.four_pi_rho_w * r_old * ((RH - eq_old) * inv_F);
  float dx_old =
      dt_sub * (c.coordinate == 1 ? fast_div(dmdt_old, wm) : dmdt_old);
  if (at_equilibrium) dx_old = 0.0f;
  const bool need_solve = dx_old != 0.0f;

  bool success = true;
  float x_new = x_old;
  if (need_solve) {
    const Drop d = {
        x_old,
        A,
        kp * rd3,
        rd3,
        rd3 * (1.0f - kp),
        c.coordinate == 1 ? dt_sub * 3.0f * inv_F
                          : dt_sub * c.four_pi_rho_w * inv_F,
        RH,
        RH - 1.0f,
    };
    const float a = x_old;
    const float fa = minfun(c, a, d);

    // bracket in the direction of minfun's own sign, the step floored at 8
    // float32 ulps of x_old (JAX ops/condensation.py:167-192)
    const float dx_mag =
        nan_max(fabsf(dx_old), 9.5367431640625e-07f * fabsf(x_old));
    const float dx_step = fa > 0.0f ? dx_mag : -dx_mag;
    const bool converged_at_a = fa == 0.0f;
    float b = nan_max(x_insane, a + dx_step);
    float fb = minfun(c, b, d);
    float scale = 2.0f;
    for (int k = 0; k < c.max_iters && fa * fb >= 0.0f; ++k) {
      b = nan_max(x_insane, a + dx_step * scale);
      fb = minfun(c, b, d);
      scale *= 2.0f;
    }
    const bool bracketed = fa * fb < 0.0f || converged_at_a;
    success = bracketed;

    if (bracketed && !converged_at_a) {
      // xa is the newest point (first the bracket's far end), xb the other
      // end, xc the point that xa replaced
      float xa = b, fxa = fb, xb = a, fxb = fa;
      bool beyond = false;
      if (xa > c.x_max && xb < c.x_max) {
        const float f_top = minfun(c, c.x_max, d);
        beyond = f_top > 0.0f;
        xa = c.x_max;
        fxa = f_top;
        if (f_top == 0.0f) xb = c.x_max;
      }
      float xc = xa, fxc = fxa;
      const float tol = c.rtol_x * fabsf(x_old) + 1e-30f;
      for (int k = 0; k < c.bisect_cap && !beyond; ++k) {
        const float width = fabsf(xb - xa);
        if (!(width - tol > 0.0f)) break;
        // where in [xa, xb] to evaluate: any point inside keeps the bracket,
        // so fast quotients do
        const float xi = fast_div(xa - xb, xc - xb);
        const float phi = fast_div(fxa - fxb, fxc - fxb);
        float frac =
            fast_div(fxa, fxb - fxa) * fast_div(fxc, fxb - fxc) +
            fast_div(xc - xa, xb - xa) * fast_div(fxa, fxc - fxa) *
                fast_div(fxb, fxc - fxb);
        const bool safe = phi * phi < xi &&
                          (1.0f - phi) * (1.0f - phi) < 1.0f - xi &&
                          nan_max(xa, xb) <= c.x_max && isfinite(frac);
        if (!safe) frac = 0.5f;
        const float margin = fminf(fast_div(0.75f * tol, width), 0.5f);
        frac = fminf(fmaxf(frac, margin), 1.0f - margin);
        const float xt = xa + frac * (xb - xa);
        const float ft = minfun(c, xt, d);
        if (ft == 0.0f) {  // xt is the root (see the stopping rule above)
          xa = xb = xt;
          break;
        }
        if ((ft > 0.0f) == (fxa > 0.0f)) {
          xc = xa;
          fxc = fxa;
        } else {
          xc = xb;
          fxc = fxb;
          xb = xa;
          fxb = fxa;
        }
        xa = xt;
        fxa = ft;
      }
      x_new = beyond ? INFINITY : 0.5f * (xa + xb);
    }
  }
  const float mass_new = coord_mass(c, x_new);
  const bool finite = isfinite(mass_new);
  mass_out[i] = finite ? mass_new : wm;
  success_out[i] = success && finite;
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
