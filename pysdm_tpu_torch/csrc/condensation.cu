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
// success out), 4 more for each of Re and f_org where the variant set reads
// them, which take the card a small fraction of the kernel's time;
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
// - every variant set that the JAX package's condensation takes: the
//   saturation vapour pressure (6 variants), the latent heat (4) and the
//   diffusion thermics (5) enter the cell's state, once per cell per block;
//   the diffusion kinetics (5) and the ventilation coefficient (3, from
//   sqrt(Re) cbrt(Sc), Re a per-drop row read only when ventilation is not
//   Neglect) enter the drop's prologue, once per drop. These are switches
//   on ints of K3Params, uniform over the launch. The variants beyond the
//   parcel slice's set (and what only they read: the air's density and
//   viscosity, the thermics' D and K, T, the Schmidt number) are compiled
//   into the FULL instantiations alone: the parcel slice's set keeps the
//   code, the six-float cell state and the loads of the build before the
//   variant sets (with the variants' code its kernel had 2984 SASS
//   instructions against that build's 2232 and took 1.3% longer at 2^20
//   drops; without, 2240 and 0.3%: PERF.md). The surface tension is the one variant inside the chain
//   of evaluations, so minfun is
//   instantiated once per form (a template parameter, not a run-time
//   switch: K1's run-time switch in its per-pair body cost it 11%). Under
//   Constant, sigma is folded into A as before; the film forms evaluate
//   sigma(T, v_new, v_dry, f_org) at each x (f_org a per-drop row read
//   only for them): CompressedFilmOvadnevaite a cbrt and its film volume
//   (formed without the reference's difference, which loses r / (3 delta)
//   ulps: ROADMAP, "Ovadnevaite's film volume"),
//   SzyszkowskiLangmuir a sqrt and a log1p, CompressedFilmRuehl the
//   reference's 64 bisection rounds of the surface fraction on [1e-16, 1]
//   with an expf each. Ruehl's c = m_sigma N_A / (2 R T) is folded in
//   double: m_sigma N_A alone (1.8e40 for the reference's 0.3e17 J/m^2)
//   is above FLT_MAX, and the TPU kernel, which forms it in float32, takes
//   c = inf (ROADMAP, "Ruehl's c"); the exponent c (A0^2 - (A_iso/f)^2)
//   is float32 and overflows or underflows as it does there. Only
//   PorousSpheroid, which has no mass_to_volume, is refused (by the
//   wrapper). Constants come by value in K3Params, rounded to float32;
//   Python-float products such as 2 sigma / Rv are folded in double first;
//   D and K are float32, as the TPU kernel pins them;
// - the twin repeats the arithmetic to rounding, not bit for bit: this
//   source is built with FMA contraction (the port's other kernels with
//   -fmad=false), the fast quotients above are 2 ulps off, and expf, logf,
//   powf, cbrtf and rcbrtf differ from torch's by an ulp or two. The
//   quotients that place the next evaluation inside the bracket are fast
//   ones too: any point inside keeps the bracket. Kernel and twin agree
//   on success drop for drop and on the mass to the bound that
//   chip_smoke.compare_k3 states;
// - counts: given a non-null counts pointer (the wrapper passes one to a
//   sample of the launches while a profiler records), the launch takes the
//   instantiation that counts: the active drops, those that needed a solve
//   and their minfun evaluations, summed over the threads of a warp that
//   reach the end together and added with one atomic add per count, the
//   warps spread over COUNT_SLOTS slots; and the drops swept, one atomic
//   add a block. The instantiation without them is this kernel's code
//   before the counts; masses and success flags are the same bits in both.
//   The counting one takes ~5% longer, which is why only a sample counts.
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
  // latent heat: Kirchhoff, Constant, SeinfeldPandis (Lowe2019)
  float l_tri, c_pv_minus_c_pw, T_tri, l_l19_a, l_l19_b;
  // saturation vapour pressure: the variant's coefficients (svp_water)
  float svp[13];
  // diffusion thermics: Neglect, TracyWelchPorter, SeinfeldAndPandis2010,
  // LoweEtAl2019, GrabowskiEtAl2011
  float D0, K0, D_exp, p_STP, d_l19_a, d_l19_b, k_l19_a, k_l19_b, k_l19_c;
  float D_G11[3], K_G11[4];
  // particle shape and trivia
  float rho_w, pi_4_3, one_third;
  // Koehler: 2 sigma_w / Rv, and 2 / Rv for the film forms
  float koehler_A, two_over_Rv;
  // Fuchs-Sutugin: (4/5) K0, 2 Rd, 2 Rv, 4/3/MAC + 0.377, 4/3/MAC, and the
  // same for HAC
  float lambdaK_coef, two_Rd, two_Rv, mac_a, mac_b, hac_a, hac_b;
  // Pruppacher and Klett: dv_pk05, 2 sqrt(pi), MAC
  float pk_dv, pk_two_sqrt_pi, MAC;
  // ventilation: Froessling A, B; Pruppacher and Rasmussen threshold,
  // constant, coefficient and power below it, constant and coefficient
  // above
  float vent[8];
  // drop growth: rho_w Rv, 4 pi rho_w; 4 pi
  float rho_w_Rv, four_pi_rho_w, four_pi;
  float x_max, RH_rtol, rtol_x;
  float per_mass;  // 1 / (rho_w 4 pi / 3): r^3 = mass * per_mass
  // surface tension: sgm_w, 1 / rho_w; Ovadnevaite: sgm_org, delta_min;
  // Ruehl and Szyszkowski-Langmuir: water molar volume, nu_org, N_A, A0,
  // A0^2, C0, m_sigma, sgm_min, R_str / (A0 N_A)
  float sgm_w, inv_rho_w, sgm_org, delta_min, water_molar_volume, nu_org,
      N_A, A0, A0_squared, C0, m_sigma, sgm_min, sl_coef;
  double ruehl_c;  // m_sigma N_A / (2 R_str): c = ruehl_c / T
  int max_iters, bisect_cap;
  int coordinate;  // 0 WaterMass, 1 WaterMassLogarithm
  int hygroscopicity;  // 0 KappaKoehler, 1 KappaKoehlerLeadingTerms
  int drop_growth;  // 0 Fick, 1 Howell1949, 2 Mason1971
  // 0 FuchsSutugin, 1 Neglect, 2 PruppacherKlett (and GrabowskiEtAl2011,
  // LoweEtAl2019, which take its D and leave K)
  int kinetics;
  // 0 FlatauWalkoCotton, 1 AugustRocheMagnus, 2 Bolton1980, 3 Lowe1977,
  // 4 MurphyKoop2005, 5 Wexler1976
  int svp_variant;
  int lv_variant;  // 0 Kirchhoff, 1 Constant, 2 SeinfeldPandis
  // 0 Neglect, 1 TracyWelchPorter, 2 SeinfeldAndPandis2010, 3 LoweEtAl2019,
  // 4 GrabowskiEtAl2011
  int thermics;
  int ventilation;  // 0 Neglect, 1 Froessling1938, 2 PruppacherAndRasmussen1979
  // 0 Constant, 1 CompressedFilmOvadnevaite, 2 SzyszkowskiLangmuir,
  // 3 CompressedFilmRuehl
  int surface_tension;
};

}  // extern "C"

namespace {

constexpr int THREADS = 256;

// a maximum that propagates NaN, as jnp.maximum/torch.maximum do (fmaxf
// returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// a minimum that propagates NaN, as torch.clamp and jnp.minimum do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
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

// what a film form of the surface tension needs of a drop, folded once
struct Film {
  float A_per_sgm;  // 2 / Rv / T / rho_w: A = sigma * A_per_sgm
  float f_org;
  float v_beta;     // f_org v_dry (Ovadnevaite)
  float cb_num;     // f_org v_dry / nu_org (Ruehl, Szyszkowski-Langmuir)
  float a_den;      // f_org v_dry N_A / nu_org
  float c;          // m_sigma N_A / (2 R T) (Ruehl)
  float sl_T;       // R T / (A0 N_A) (Szyszkowski-Langmuir)
};

enum SurfaceTension { CONSTANT = 0, OVADNEVAITE = 1, SZYSZKOWSKI = 2, RUEHL = 3 };

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

// the film forms' sigma(T, v_wet, v_dry, f_org) of a drop of wet volume
// v_wet and radius r_wet (pysdm_tpu/physics/surface_tension.py; T and the
// organic enter through the Film)
template <int ST>
__device__ float film_sigma(const K3Params& c, const Film& f, float v_wet,
                            float r_wet) {
  if (ST == OVADNEVAITE) {
    // v_wet - 4/3 pi (r - delta)^3 as 4/3 pi delta (3 r (r - delta) +
    // delta^2): the difference loses about r / (3 delta) ulps, 1e4 at 4 um,
    // and is 0 above ~2 mm, where f_org = 0 then gives 0 / 0
    const float d = c.delta_min;
    const float v_delta = c.pi_4_3 * d * (3.0f * r_wet * (r_wet - d) + d * d);
    // v_delta > 0, so the test of v_beta changes no result; the build
    // without it takes ~9% longer on Lowe's film set
    // (tools/profile_k3_builds.py; why is not measured)
    const float c_beta =
        f.v_beta == 0.0f ? 0.0f : nan_min(f.v_beta / v_delta, 1.0f);
    return (1.0f - c_beta) * c.sgm_w + c_beta * c.sgm_org;
  }
  if (f.f_org == 0.0f) return c.sgm_w;
  if (ST == RUEHL && f.f_org == 1.0f) return c.sgm_min;
  const float cb = f.cb_num / (v_wet / c.water_molar_volume);
  const float a_iso = (c.four_pi * (r_wet * r_wet)) / f.a_den;
  float sgm;
  if (ST == SZYSZKOWSKI) {
    const float q = c.A0 / a_iso;
    const float a = -q;
    const float b = q + q * (c.C0 / cb) + 1.0f;
    const float f_surf = (-b + sqrtf(b * b + 4.0f * a)) / (2.0f * a);
    sgm = c.sgm_w - f.sl_T * log1pf(cb * (1.0f - f_surf) / c.C0);
  } else {
    // the isotherm's root by the reference's 64 halvings of [1e-16, 1]
    float lo = 1e-16f, hi = 1.0f;
    float y = a_iso / lo;
    float flo = cb * (1.0f - lo) / c.C0 - expf(f.c * (c.A0_squared - y * y));
    for (int k = 0; k < 64; ++k) {
      const float mid = 0.5f * (lo + hi);
      y = a_iso / mid;
      const float fmid =
          cb * (1.0f - mid) / c.C0 - expf(f.c * (c.A0_squared - y * y));
      const bool go_lo = flo * fmid < 0.0f;
      hi = go_lo ? mid : hi;
      lo = go_lo ? lo : mid;
      flo = go_lo ? flo : fmid;
    }
    const float f_surf = 0.5f * (lo + hi);
    sgm = c.sgm_w - (c.A0 - a_iso / f_surf) * c.m_sigma;
  }
  return nan_min(nan_max(sgm, c.sgm_min), c.sgm_w);
}

// what the solve needs of a cell's thermodynamic state
struct CellThermo {
  float RH;
  float A;  // 2 sigma / Rv / T / rho_w
  float lambdaK, lambdaD;
  float Fk_K;  // Fk = Fk_K / K(r)
  float Fd_D;  // Fd = Fd_D / D(r)
};

// what only the wider variant sets read of a cell's state (the kernel's
// FULL instantiations): the diffusion thermics' D(T, p) and K(T, p), D0 and
// K0 under Neglect; T, for the film forms; the cube root of the air's
// Schmidt number, for the ventilation
struct CellExtra {
  float D, K, T, cbrt_Sc;
};

// saturation vapour pressure over water (physics/saturation_vapour_pressure);
// FlatauWalkoCotton alone where the variant set is the parcel slice's
template <bool FULL>
__device__ __forceinline__ float svp_water(const K3Params& c, float T) {
  const float dT = T - c.T0;
  switch (FULL ? c.svp_variant : 0) {
    case 1:    // AugustRocheMagnus
    case 2: {  // Bolton1980
      return c.svp[0] * expf((c.svp[1] * dT) / (dT + c.svp[2]));
    }
    case 3: {  // Lowe1977
      float pvs = c.svp[6];
      for (int k = 5; k >= 0; --k) pvs = c.svp[k] + dT * pvs;
      return pvs;
    }
    case 4: {  // MurphyKoop2005 (C5 and C12 are one kelvin)
      const float lnT = logf(T);
      return c.svp[0] *
             expf(c.svp[1] - c.svp[2] / T - c.svp[3] * lnT + c.svp[5] * T +
                  tanhf(c.svp[6] * (T - c.svp[7])) *
                      (c.svp[8] - c.svp[9] / T - c.svp[10] * lnT +
                       c.svp[12] * T));
    }
    case 5: {  // Wexler1976 (G0..G8)
      const float T2 = T * T;
      return expf(c.svp[0] / T2 + c.svp[1] / T + c.svp[2] + c.svp[3] * T +
                  c.svp[4] * T2 + c.svp[5] * (T * T2) +
                  c.svp[6] * (T2 * T2) + c.svp[7] * logf(T)) *
             c.svp[8];
    }
    default: {  // FlatauWalkoCotton
      float pvs = c.svp[8];
      for (int k = 7; k >= 0; --k) pvs = c.svp[k] + dT * pvs;
      return pvs;
    }
  }
}

// the cell's state from (thd, qv, rhod) (JAX compute_cell_thermo), with
// exact divisions: an ulp of RH is 1e-4 of a supersaturation of 0.1%. Only
// the FULL instantiations switch on the saturation vapour pressure and the
// latent heat, read the air's density and viscosity, evaluate the diffusion
// thermics and write the CellExtra.
template <bool FULL>
__device__ CellThermo cell_thermo(const K3Params& c, float thd, float qv,
                                  float rhod, float rho_air, float mu_air,
                                  CellExtra* extra) {
  const float T = thd * powf(rhod * thd / c.p1000 * c.Rd, c.T_exponent);
  const float q1 = 1.0f + qv;
  const float p = rhod * q1 * (c.Rv / (1.0f / qv + 1.0f) + c.Rd / q1) * T;
  const float pv = p * qv / (qv + c.eps);
  float lv;
  switch (FULL ? c.lv_variant : 0) {
    case 1: lv = c.l_tri; break;
    case 2: lv = c.l_tri * powf(c.T_tri / T, c.l_l19_a + c.l_l19_b * T); break;
    default: lv = c.l_tri + c.c_pv_minus_c_pw * (T - c.T_tri);
  }
  const float pvs = svp_water<FULL>(c, T);
  float D = c.D0, K = c.K0;
  if (FULL) {
    switch (c.thermics) {
      case 1: D = c.D0 * powf(T / c.T0, c.D_exp) * (c.p1000 / p); break;
      case 2:
      case 3:
        D = c.d_l19_a * (c.p_STP / p) * powf(T / c.T0, c.d_l19_b);
        if (c.thermics == 3) K = c.k_l19_a * (c.k_l19_b + c.k_l19_c * T);
        break;
      case 4:
        D = c.D_G11[0] * (c.D_G11[1] * T + c.D_G11[2]);
        K = c.K_G11[0] * (T * (T * T)) + c.K_G11[1] * (T * T) +
            c.K_G11[2] * T + c.K_G11[3];
        break;
      default: break;
    }
    extra->D = D;
    extra->K = K;
    extra->T = T;
    extra->cbrt_Sc = c.ventilation == 0 ? 1.0f : cbrtf(mu_air / D / rho_air);
  }
  CellThermo t;
  t.RH = pv / pvs;
  t.A = c.koehler_A / T / c.rho_w;
  t.lambdaK = c.lambdaK_coef * T / p / sqrtf(c.two_Rd * T);
  t.lambdaD = D / sqrtf(c.two_Rv * T);
  const float heat = lv / T / c.Rv;
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

// x_old - x + dt dx/dt(x); past x_max, x_old - x. Under Constant the Kelvin
// coefficient A is the drop's; a film form takes it from sigma at x.
template <int ST>
__device__ __forceinline__ float minfun(const K3Params& c, float x_new,
                                        const Drop& d, const Film& f) {
  const float gap = d.x_old - x_new;
  if (x_new > c.x_max) return gap;
  float A = d.A;
  float r3;
  if (ST == CONSTANT) {
    r3 = (c.coordinate == 1 ? expf(x_new) : x_new) * c.per_mass;
  } else {
    const float mass = c.coordinate == 1 ? expf(x_new) : x_new;
    r3 = mass * c.per_mass;
    A = film_sigma<ST>(c, f, mass * c.inv_rho_w, cbrtf(r3)) * f.A_per_sgm;
  }
  const float inv_r = rcbrtf(r3);
  const float inv_r2 = inv_r * inv_r;
  float excess;  // RH - RH_eq(r)
  if (c.hygroscopicity == 1) {
    excess = d.RH_minus_1 - A * inv_r + d.B * (inv_r2 * inv_r);
  } else {
    excess = d.RH - expf(A * inv_r) * (r3 - d.rd3) / (r3 - d.rd3_solute);
  }
  const float growth = c.coordinate == 1 ? d.rate * excess * inv_r2
                                         : d.rate * excess / inv_r;
  return gap + growth;
}

#ifdef K3_MINFUN_PROBE
// one evaluation of minfun per thread under the default variant set (log
// coordinate, leading-terms Koehler curve; set here, so the compiler drops
// the other variants' branches), between two loads and a store, once per
// surface-tension form: its SASS is what an evaluation costs
// (tools/kernel_resources.py counts it)
template <int ST>
__global__ void minfun_probe_kernel(K3Params c, const Drop* __restrict__ d,
                                    const Film* __restrict__ f,
                                    const float* __restrict__ x,
                                    float* __restrict__ out) {
  c.coordinate = 1;
  c.hygroscopicity = 1;
  out[threadIdx.x] = minfun<ST>(c, x[threadIdx.x], d[threadIdx.x],
                                f[threadIdx.x]);
}
template __global__ void minfun_probe_kernel<CONSTANT>(
    K3Params, const Drop*, const Film*, const float*, float*);
template __global__ void minfun_probe_kernel<OVADNEVAITE>(
    K3Params, const Drop*, const Film*, const float*, float*);
template __global__ void minfun_probe_kernel<SZYSZKOWSKI>(
    K3Params, const Drop*, const Film*, const float*, float*);
template __global__ void minfun_probe_kernel<RUEHL>(
    K3Params, const Drop*, const Film*, const float*, float*);
#endif

// Fuchs-Sutugin transition-regime correction of D (or K)
__device__ __forceinline__ float fuchs_sutugin(float D, float r, float lmbd,
                                               float a, float b) {
  const float q = fast_div(lmbd, r);
  return D * fast_div(1.0f + q, 1.0f + a * q + b * q * q);
}

// cells whose state a block keeps in shared memory
constexpr int CELL_SPAN = 8;

// the counts: COUNT_SLOTS slots of COUNT_WIDTH entries (32 bytes, one L2
// sector each), so that a launch's atomic adds do not queue on three
// addresses (ops/cuda/condensation.py sums the slots)
constexpr int COUNT_SLOTS = 256;
constexpr int COUNT_WIDTH = 4;

// the slot of the calling thread's warp
__device__ __forceinline__ unsigned long long* count_slot(
    unsigned long long* counts) {
  const int warp = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  return counts + (warp % COUNT_SLOTS) * COUNT_WIDTH;
}

// adds what the active drops of a warp that reach it together count to
// entries 0..2 of the warp's slot: the drops, those that needed a solve,
// their minfun evaluations (an inactive drop returns before and adds
// nothing). One thread of the group adds each sum. (Entry 3: the drops
// swept, added by each block's first thread.)
__device__ __forceinline__ void add_warp_counts(unsigned long long* counts,
                                                bool need_solve,
                                                int evaluations) {
  const unsigned group = __activemask();
  const int solves = __popc(__ballot_sync(group, need_solve));
  const int total = __reduce_add_sync(group, evaluations);
  if (threadIdx.x % 32 == __ffs(group) - 1) {
    unsigned long long* slot = count_slot(counts);
    atomicAdd(slot, (unsigned long long)__popc(group));
    if (solves != 0) atomicAdd(slot + 1, (unsigned long long)solves);
    if (total != 0) atomicAdd(slot + 2, (unsigned long long)total);
  }
}

template <int ST, bool FULL, bool COUNT>
__global__ void masses_new_kernel(
    const float* __restrict__ water_mass, const float* __restrict__ vdry,
    const float* __restrict__ kappa, const int64_t* __restrict__ multiplicity,
    const int32_t* __restrict__ cell_id, const float* __restrict__ cell_thd,
    const float* __restrict__ cell_qv, const float* __restrict__ cell_rhod,
    const float* __restrict__ cell_dt_sub,
    const uint8_t* __restrict__ cell_active,
    // air density and viscosity enter only through the Schmidt number of
    // the ventilation coefficient, which is 1 under ventilation Neglect;
    // read only by the FULL instantiations
    const float* __restrict__ cell_rho_air,
    const float* __restrict__ cell_mu_air,
    // read only where the variant set needs them: the Reynolds number
    // (ventilation other than Neglect) and the organic fraction (the film
    // forms of the surface tension)
    const float* __restrict__ reynolds, const float* __restrict__ f_org,
    int n, int n_cell, const K3Params c, float* __restrict__ mass_out,
    uint8_t* __restrict__ success_out,
    // COUNT: where add_warp_counts adds the launch's counts
    unsigned long long* __restrict__ counts) {
  __shared__ int first_cell;
  __shared__ CellThermo cells[CELL_SPAN];
  __shared__ CellExtra extras[FULL ? CELL_SPAN : 1];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  if (COUNT && threadIdx.x == 0)
    atomicAdd(count_slot(counts) + 3,
              (unsigned long long)min(THREADS, n - i));
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
      cells[threadIdx.x] = cell_thermo<FULL>(
          c, cell_thd[k], cell_qv[k], cell_rhod[k],
          FULL ? cell_rho_air[k] : 0.0f, FULL ? cell_mu_air[k] : 0.0f,
          &extras[FULL ? threadIdx.x : 0]);
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
  CellExtra x{};
  const CellThermo t =
      in_span ? cells[slot]
              : cell_thermo<FULL>(c, cell_thd[cell], cell_qv[cell],
                                  cell_rhod[cell],
                                  FULL ? cell_rho_air[cell] : 0.0f,
                                  FULL ? cell_mu_air[cell] : 0.0f, &x);
  if (FULL && in_span) x = extras[slot];
  const float RH = t.RH;
  float A = t.A;
  const float dt_sub = cell_dt_sub[cell];

  const float r3_old = wm * c.per_mass;
  const float r_old = cbrtf(r3_old);
  const float x_old = coord_x(c, wm);
  const float vd = vdry[i];
  const float x_insane = coord_x(c, c.rho_w * (vd * 0.01f));
  const float rd3 = fast_div(vd, c.pi_4_3);
  const float kp = kappa[i];
  Film film;
  if (ST != CONSTANT) {
    const float fo = f_org[i];
    const float fo_safe = fo == 0.0f ? 1.0f : fo;
    film.A_per_sgm = c.two_over_Rv / x.T / c.rho_w;
    film.f_org = fo;
    film.v_beta = fo * vd;
    film.cb_num = fo_safe * vd / c.nu_org;
    film.a_den = fo_safe * vd * c.N_A / c.nu_org;
    film.c = (float)(c.ruehl_c / (double)x.T);
    film.sl_T = c.sl_coef * x.T;
    A = film_sigma<ST>(c, film, wm * c.inv_rho_w, r_old) * film.A_per_sgm;
  }
  const float eq_old = RH_eq(c, r_old, r3_old, A, kp, rd3);

  const float D = FULL ? x.D : c.D0, K = FULL ? x.K : c.K0;
  float Dr = D, Kr = K;
  if (c.kinetics == 0) {
    Dr = fuchs_sutugin(D, r_old, t.lambdaD, c.mac_a, c.mac_b);
    Kr = fuchs_sutugin(K, r_old, t.lambdaK, c.hac_a, c.hac_b);
  } else if (FULL && c.kinetics == 2) {
    Dr = fast_div(D, fast_div(r_old, r_old + c.pk_dv) +
                         c.pk_two_sqrt_pi * t.lambdaD / r_old / c.MAC);
  }
  if (FULL && c.ventilation != 0) {
    const float s = sqrtf(reynolds[i]) * x.cbrt_Sc;
    const float vent =
        c.ventilation == 1
            ? c.vent[0] + c.vent[1] * s
            : (s < c.vent[2] ? c.vent[3] + c.vent[4] * powf(s, c.vent[5])
                             : c.vent[6] + c.vent[7] * s);
    Dr *= vent;
    Kr *= vent;
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

  int evaluations = 0;  // of minfun, read by COUNT alone
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
    const float fa = minfun<ST>(c, a, d, film);

    // bracket in the direction of minfun's own sign, the step floored at 8
    // float32 ulps of x_old (JAX ops/condensation.py:167-192)
    const float dx_mag =
        nan_max(fabsf(dx_old), 9.5367431640625e-07f * fabsf(x_old));
    const float dx_step = fa > 0.0f ? dx_mag : -dx_mag;
    const bool converged_at_a = fa == 0.0f;
    float b = nan_max(x_insane, a + dx_step);
    float fb = minfun<ST>(c, b, d, film);
    evaluations = 2;
    float scale = 2.0f;
    for (int k = 0; k < c.max_iters && fa * fb >= 0.0f; ++k) {
      b = nan_max(x_insane, a + dx_step * scale);
      fb = minfun<ST>(c, b, d, film);
      ++evaluations;
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
        const float f_top = minfun<ST>(c, c.x_max, d, film);
        ++evaluations;
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
        const float ft = minfun<ST>(c, xt, d, film);
        ++evaluations;
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
  if (COUNT) add_warp_counts(counts, need_solve, evaluations);
}

}  // namespace

extern "C" {

int pysdm_condensation_masses_new(
    const float* water_mass, const float* vdry, const float* kappa,
    const int64_t* multiplicity, const int32_t* cell_id,
    const float* cell_thd, const float* cell_qv, const float* cell_rhod,
    const float* cell_dt_sub, const uint8_t* cell_active,
    const float* cell_rho_air, const float* cell_mu_air,
    const float* reynolds, const float* f_org, int n, int n_cell,
    const K3Params* params, float* mass_out, uint8_t* success_out,
    unsigned long long* counts, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  // the parcel slice's set (FlatauWalkoCotton, Kirchhoff, Constant sigma,
  // thermics and ventilation Neglect, kinetics FuchsSutugin or Neglect)
  // takes the instantiation that keeps the six-float cell state of the
  // build before the variant sets and compiles none of the wider variants
  const bool full = params->surface_tension != CONSTANT ||
                    params->svp_variant != 0 || params->lv_variant != 0 ||
                    params->thermics != 0 || params->ventilation != 0 ||
                    params->kinetics == 2;
#define PYSDM_K3_KERNEL(ST, FULL, COUNT)                                     \
  masses_new_kernel<ST, FULL, COUNT><<<blocks, THREADS, 0, stream>>>(        \
      water_mass, vdry, kappa, multiplicity, cell_id, cell_thd, cell_qv,     \
      cell_rhod, cell_dt_sub, cell_active, cell_rho_air, cell_mu_air,        \
      reynolds, f_org, n, n_cell, *params, mass_out, success_out, counts)
#define PYSDM_K3_LAUNCH(ST, FULL)                                            \
  if (counts != nullptr) {                                                   \
    PYSDM_K3_KERNEL(ST, FULL, true);                                         \
  } else {                                                                   \
    PYSDM_K3_KERNEL(ST, FULL, false);                                        \
  }
  switch (params->surface_tension) {
    case OVADNEVAITE: PYSDM_K3_LAUNCH(OVADNEVAITE, true); break;
    case SZYSZKOWSKI: PYSDM_K3_LAUNCH(SZYSZKOWSKI, true); break;
    case RUEHL: PYSDM_K3_LAUNCH(RUEHL, true); break;
    default:
      if (full) {
        PYSDM_K3_LAUNCH(CONSTANT, true);
      } else {
        PYSDM_K3_LAUNCH(CONSTANT, false);
      }
  }
#undef PYSDM_K3_LAUNCH
#undef PYSDM_K3_KERNEL
  return (int)cudaGetLastError();
}

const char* pysdm_condensation_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
