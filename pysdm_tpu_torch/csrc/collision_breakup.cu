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
// - one thread per pair, not per slot. Pair p's thread takes the pair's
//   leader o (the smaller slot; sdm_pair.cuh mirror_pair, in closed form)
//   and its partner po, loads both slots once, computes the pair once and
//   writes BOTH output slots. A warp's 32 pairs read and write 32
//   consecutive leaders and, within each of the map's two runs, 32
//   consecutive partners in descending order, so loads and stores stay
//   coalesced. Outputs are separate buffers, so the slots that pair with
//   themselves (thread 0 copies them) and the dead pairs get their
//   unchanged copy;
// - every load is issued before any branch on loaded data, so a pair waits
//   for memory once; then the costly physics only where it is read: the
//   int64 division only where gamma falls below its cap (a 128-bit product
//   of the cap and xi_k decides; sdm_pair.cuh capped_quotient), Berry's Ec
//   (four powf), Eb and the process draw only where gamma > 0, the fragment
//   mass and the transfer only where the pair breaks up;
// - one launch: the five rate sums go per pair, warp and block in a fixed
//   order into per-block partials, and the last block to finish (a ticket
//   from a counter that atomicInc returns to 0 with the launch's last
//   ticket) adds them in a fixed block order (sdm_pair.cuh grid_sums). The
//   wrapper keeps the counter and the partials per device, stream and
//   shape, zeroed once. No float atomics: two runs give the same bits;
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
//   kernel does.
// Multiplicities and rows equal, bit for bit, the update computed at each
// slot from that slot's view of the pair (the twin's form): the collision
// kernels, Ec and the fragment mass are symmetric in the pair, and the
// walks stop at their first failing step. The rate sums are added in
// another order than the twin's.
//
// What bounds it on the card: each input read once and each output written
// once, a slot moves 32 B (multiplicity 8 in and 8 out, one float32
// extensive row 4 in and 4 out, two float32 attribute rows 8 in), 4.2 MB at
// config #2's 2^17 slots, ~1.3 us at 3.35 TB/s; its float32 work, ~60
// operations a slot and ~150 more where a pair breaks up, takes ~0.1 us at
// the card's float32 rate. At these sizes what is left is the launch, one
// wave of threads each waiting for memory once, the chain of arithmetic of
// the slowest pair in a warp (Berry's powf, the transfer's expf) and the
// last block's sums. Measured times stand in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sdm_pair.cuh"

namespace {

constexpr int THREADS = 256;  // pairs a block
// extensive rows of both slots loaded with the multiplicities
constexpr int ROWS_AHEAD = 2;
constexpr int N_SUMS = 5;
constexpr int SCRATCH_HEAD = 16;  // bytes before the partials: the counter
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24
constexpr uint32_t SEED_PROCESS = 0xA5A5A5A5u;
constexpr uint32_t SEED_FRAGMENT = 0x3C3C3C3Cu;

using sdm::BIG;
using sdm::u32_to_f32;
using sdm::u64_to_f32;

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

  // whether g events fit; the pair values at g in nmk and tfj
  __device__ bool valid(float g, float* nmk, float* tfj) const {
    pair_values(g, nmk, tfj);
    return (g >= 1.0f) && (g <= gamma_f) && (*nmk <= max_mult) &&
           (*tfj <= mult_j);
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
  // the +-4 correction walks with their eight candidates evaluated at once:
  // each walk stops at its first failing step, the downward one runs only
  // where the upward one did not move, so g is the sequential walks'. The
  // pair values at g come from its candidate's evaluation where it had one
  float up[5], down[5];
  up[0] = g;
  down[0] = g;
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    up[i] = add(up[i - 1], 1.0f);
    down[i] = sub(down[i - 1], 1.0f);
  }
  bool ok_up[4], ok_down[4];
  float nmk_up[4], tfj_up[4], nmk_down[4], tfj_down[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ok_up[i] = t.valid(up[i + 1], &nmk_up[i], &tfj_up[i]);
    ok_down[i] = t.valid(down[i], &nmk_down[i], &tfj_down[i]) ||
                 down[i] <= 0.0f;
  }
  float g_up = g, g_down = g;
  float nmk_u = 0.0f, tfj_u = 0.0f, nmk_d = nmk_down[0], tfj_d = tfj_down[0];
  bool going_up = true, going_down = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    going_up = going_up && ok_up[i];
    g_up = going_up ? up[i + 1] : g_up;
    nmk_u = going_up ? nmk_up[i] : nmk_u;
    tfj_u = going_up ? tfj_up[i] : tfj_u;
    going_down = going_down && !ok_down[i];
    g_down = going_down ? down[i + 1] : g_down;
    if (i < 3) {
      nmk_d = going_down ? nmk_down[i + 1] : nmk_d;
      tfj_d = going_down ? tfj_down[i + 1] : tfj_d;
    }
  }
  const bool moved_up = ok_up[0];
  g = jmax(moved_up ? g_up : g_down, 0.0f);
  float nmk = moved_up ? nmk_u : nmk_d, tfj = moved_up ? tfj_u : tfj_d;
  // below 1 the values are not read; at down[4] no candidate has them
  if (g >= 1.0f && !moved_up && going_down) t.pair_values(g, &nmk, &tfj);
  Transfer out;
  out.take = g >= 1.0f ? tfj : 0.0f;
  out.nmk = g >= 1.0f ? nmk : t.mk;
  out.g = g;
  return out;
}

// the kernel's arguments but the pair map and the sums' scratch
template <typename T>
struct Args {
  const int64_t* __restrict__ mult;
  const T* __restrict__ ext;
  int n_ext, wm_index;
  const float* __restrict__ volume;
  const float* __restrict__ radius;
  // the row whose pair difference the geometric kernels take: the
  // relative fall velocity (GEOMETRIC) or the area (SIMPLE_GEOMETRIC)
  const float* __restrict__ diff_row;
  PairFunctions f;
  const float* __restrict__ scale;
  int64_t n;
  uint32_t seed;
  float max_mult;
  int64_t* __restrict__ mult_out;
  T* __restrict__ ext_out;

  __device__ float row(int r, int64_t slot) const {
    return (float)ext[(int64_t)r * n + slot];
  }
  __device__ void put(int r, int64_t slot, float value) const {
    ext_out[(int64_t)r * n + slot] = (T)value;
  }
  // a slot that keeps its values (its rows still pass through float32)
  __device__ void keep(int64_t slot) const {
    mult_out[slot] = mult[slot];
    for (int r = 0; r < n_ext; ++r) put(r, slot, row(r, slot));
  }
};

// what a pair does to each of its extensive rows, in float32
struct RowUpdate {
  enum { KEEP, COALESCE, BREAK_UP } process = KEEP;
  bool o_is_j = false, split = false, deplete = false;
  float gf = 0.0f, mk_f = 0.0f, take = 0.0f, nmk_safe = 0.0f;
  float rescale_j = 0.0f, rescale_k = 0.0f;

  // the row's new values in slots o and po from its values there
  __device__ void apply(float e_o, float e_p, float* out_o,
                        float* out_p) const {
    if (process == KEEP) {
      *out_o = e_o;
      *out_p = e_p;
      return;
    }
    const float ej = o_is_j ? e_o : e_p, ek = o_is_j ? e_p : e_o;
    float new_j, new_k;
    if (process == COALESCE) {
      const float merged = add(ek, mul(gf, ej));
      new_j = split ? merged : ej;
      new_k = merged;
    } else {
      const float ek_mix = dvd(add(mul(ek, mk_f), mul(take, ej)), nmk_safe);
      new_j = mul(deplete ? ek_mix : ej, rescale_j);
      new_k = mul(ek_mix, rescale_k);
    }
    *out_o = o_is_j ? new_j : new_k;
    *out_p = o_is_j ? new_k : new_j;
  }
};

// v[i] of a small array held in registers (no dynamic index into it)
__device__ __forceinline__ float pick(const float (&v)[ROWS_AHEAD], int i) {
  float out = 0.0f;
#pragma unroll
  for (int r = 0; r < ROWS_AHEAD; ++r) out = r == i ? v[r] : out;
  return out;
}

// the pair (o, po), o < po the leader: computed once, both slots written;
// adds the pair's five rates to s
template <typename T>
__device__ void pair_update(const Args<T>& x, int64_t o, int64_t po,
                            float (&s)[N_SUMS]) {
  // every load first and none behind a branch on loaded data, so that the
  // pair waits for memory once
  const int64_t a = x.mult[o], b = x.mult[po];
  const float va = x.volume ? x.volume[o] : 0.0f;
  const float vb = x.volume ? x.volume[po] : 0.0f;
  const float ra = x.radius ? x.radius[o] : 0.0f;
  const float rb = x.radius ? x.radius[po] : 0.0f;
  const float ua = x.diff_row ? x.diff_row[o] : 0.0f;
  const float ub = x.diff_row ? x.diff_row[po] : 0.0f;
  float eo[ROWS_AHEAD], ep[ROWS_AHEAD];
#pragma unroll
  for (int r = 0; r < ROWS_AHEAD; ++r) {
    eo[r] = r < x.n_ext ? x.row(r, o) : 0.0f;
    ep[r] = r < x.n_ext ? x.row(r, po) : 0.0f;
  }
  const bool wm_ahead = x.wm_index < ROWS_AHEAD;
  const float wo = wm_ahead ? pick(eo, x.wm_index) : x.row(x.wm_index, o);
  const float wp = wm_ahead ? pick(ep, x.wm_index) : x.row(x.wm_index, po);

  RowUpdate u;
  int64_t m_o = a, m_p = b;
  if (a != 0 && b != 0) {
    // j = the not-smaller multiplicity; a tie goes to the leader
    u.o_is_j = a >= b;
    const int64_t mj = u.o_is_j ? a : b, mk = u.o_is_j ? b : a;
    const PairFunctions& f = x.f;
    const float kn = mul(
        sdm::kernel_value(f.kernel_id, f.k0, f.k1, va, vb, ra, rb, ua, ub),
        x.scale[0]);
    const float u_gamma = u01_hash(x.seed, (uint32_t)o);
    const float mj_f = u64_to_f32((uint64_t)mj);
    const float mk_f = u64_to_f32((uint64_t)mk);
    const float gamma_f = jmax(ceilf(sub(mul(mj_f, kn), u_gamma)), 0.0f);
    const int64_t cap = (int64_t)fminf(gamma_f, BIG);
    // at cap = 0, g = min(xi_j / xi_k, 0) = 0 without the division
    const int64_t g = cap > 0 ? sdm::capped_quotient(mj, mk, cap) : 0;
    const float gf = u32_to_f32((uint32_t)g);
    s[0] = mul(gf, mk_f);
    s[1] = mul(sub(gamma_f, gf), mk_f);
    if (g > 0) {
      // process: bounce if u > Ec + (1 - Ec) Eb, coalesce if u < Ec, else
      // break up; Ec (Berry's four powf) only here, where gamma > 0
      const float Ec = f.ec_id == EC_BERRY1967 ? berry_1967_ec(ra, rb) : f.ec0;
      const float Eb = f.eb0;
      const float u_proc = u01_hash(x.seed ^ SEED_PROCESS, (uint32_t)o);
      int64_t m_j = mj, m_k = mk;
      u.gf = gf;
      u.mk_f = mk_f;
      if (sub(u_proc, add(Ec, mul(sub(1.0f, Ec), Eb))) > 0.0f) {
        // bounce
      } else if (sub(u_proc, Ec) < 0.0f) {
        // Shima update: xi_j -= gamma xi_k; an exhausted j takes half of k
        const int64_t nn = mj - g * mk;
        u.process = RowUpdate::COALESCE;
        u.split = nn == 0;
        const int64_t half = mk >> 1;
        m_j = u.split ? half : nn;
        m_k = u.split ? mk - half : mk;
        s[2] = mul(gf, mk_f);
      } else {
        const float mass_j = fabsf(u.o_is_j ? wo : wp);
        const float mass_k = fabsf(u.o_is_j ? wp : wo);
        const float mass_sum = add(mass_j, mass_k);
        // the fragment mass sees the pair in slot order, as the TPU
        // kernel's
        const float u_frag = u01_hash(x.seed ^ SEED_FRAGMENT, (uint32_t)o);
        float fm = fragment_mass(f, fabsf(wo), fabsf(wp), u_frag);
        fm = (isnan(fm) || fm <= 0.0f) ? mass_sum : fm;
        fm = jmin(fm, mass_sum);
        fm = mass_sum <= 0.0f ? 1.0f : fm;
        const Transfer t = transfer_closed_form(
            gf, mj_f, jmax(mk_f, 1.0f), mass_j, mass_k, fm, x.max_mult);
        u.process = RowUpdate::BREAK_UP;
        u.deplete = t.take >= mj_f;
        const float nj = u.deplete ? mul(t.nmk, 0.5f) : sub(mj_f, t.take);
        const float nk = u.deplete ? mul(t.nmk, 0.5f) : t.nmk;
        const float bj = jmax(rintf(nj), 1.0f);
        const float bk = jmax(rintf(nk), 1.0f);
        m_j = (int64_t)bj;
        m_k = (int64_t)bk;
        u.take = t.take;
        u.nmk_safe = jmax(t.nmk, 1e-30f);
        u.rescale_j = dvd(nj, bj);
        u.rescale_k = dvd(nk, bk);
        s[3] = mul(t.g, mk_f);
        s[4] = mul(sub(gf, t.g), mk_f);
      }
      m_o = u.o_is_j ? m_j : m_k;
      m_p = u.o_is_j ? m_k : m_j;
    }
  }

  x.mult_out[o] = m_o;
  x.mult_out[po] = m_p;
  float out_o, out_p;
#pragma unroll
  for (int r = 0; r < ROWS_AHEAD; ++r) {
    if (r < x.n_ext) {
      u.apply(eo[r], ep[r], &out_o, &out_p);
      x.put(r, o, out_o);
      x.put(r, po, out_p);
    }
  }
  for (int r = ROWS_AHEAD; r < x.n_ext; ++r) {
    u.apply(x.row(r, o), x.row(r, po), &out_o, &out_p);
    x.put(r, o, out_o);
    x.put(r, po, out_p);
  }
}

// one thread per pair; thread 0 also copies the slots that pair with
// themselves
template <typename T>
__global__ void __launch_bounds__(THREADS)
    coalesce_breakup_mirror_kernel(Args<T> x, int64_t K, unsigned* counter,
                                   float* partials, float* sums) {
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float s[N_SUMS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (p < sdm::mirror_pair_count(x.n, K)) {
    int64_t o, po;
    sdm::mirror_pair(x.n, K, p, &o, &po);
    pair_update(x, o, po, s);
  }
  if (p == 0) {
    for (int r = 0; r < 2; ++r) {
      const int64_t slot = sdm::mirror_self_slot(x.n, K, r);
      if (slot >= 0) x.keep(slot);
    }
  }
  sdm::grid_sums<N_SUMS, THREADS>(s, counter, partials, sums);
}

// the blocks of a launch over n slots: one thread per pair, at most n / 2
// pairs
int64_t blocks_for(int64_t n) {
  const int64_t pairs = n / 2;
  return pairs > 0 ? (pairs + THREADS - 1) / THREADS : 1;
}

template <typename T>
int launch(Args<T> x, int64_t K, void* scratch, void* sums, cudaStream_t s) {
  const int64_t blocks = blocks_for(x.n);
  char* base = (char*)scratch;
  coalesce_breakup_mirror_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      x, K, (unsigned*)base, (float*)(base + SCRATCH_HEAD), (float*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of scratch for n slots: the ticket counter, then the per-block
// partial sums. The caller zeroes it once, when it allocates it, and keeps
// it for the later calls on this stream (calls on one stream never
// overlap; the counter is back at 0 after every launch).
long long pysdm_coalesce_breakup_mirror_scratch_bytes(long long n) {
  return SCRATCH_HEAD + 4 * N_SUMS * blocks_for(n);
}

// one substep in one launch; returns cudaGetLastError() after it (0 =
// success). mult, mult_out: int64 (n,); ext, ext_out: (n_ext, n) float or
// double (ext_is_f64), row wm_index the signed water mass; volume, radius,
// diff_row: float (n,) rows, NULL where the functions do not read them
// (diff_row: the relative fall velocity or the area, see Args); f: the
// functions (host memory); scale: float (1,) on the device; scratch:
// pysdm_coalesce_breakup_mirror_scratch_bytes(n) bytes; sums: float (5,)
// receives the collision rate, its deficit, the coalescence rate, the
// breakup rate and the breakup deficit.
int pysdm_coalesce_breakup_mirror(
    const void* mult, const void* ext, int ext_is_f64, int n_ext,
    int wm_index, const void* volume, const void* radius, const void* diff_row,
    const PairFunctions* f, const void* scale, long long n, long long K,
    unsigned int seed, float max_mult, void* mult_out, void* ext_out,
    void* scratch, void* sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    return launch(Args<double>{(const int64_t*)mult, (const double*)ext,
                               n_ext, wm_index, (const float*)volume,
                               (const float*)radius, (const float*)diff_row, *f,
                               (const float*)scale, n, seed, max_mult,
                               (int64_t*)mult_out, (double*)ext_out},
                  K, scratch, sums, s);
  }
  return launch(Args<float>{(const int64_t*)mult, (const float*)ext, n_ext,
                            wm_index, (const float*)volume,
                            (const float*)radius, (const float*)diff_row, *f,
                            (const float*)scale, n, seed, max_mult,
                            (int64_t*)mult_out, (float*)ext_out},
                K, scratch, sums, s);
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
