// Single-cell SDM coalescence substep under the mirror croupier, for Hopper
// (sm_90a). Three plain C entry points, loaded with ctypes by
// pysdm_tpu_torch/ops/cuda/collision.py, which also holds the plain PyTorch
// twins of each (coalesce_mirror_reference, coalesce_mirror_rows_reference,
// coalesce_mirror_parameterized_reference): K1 (pysdm_coalesce_mirror),
// which evaluates the collision kernel and draws u01 in its body; K1a
// (pysdm_coalesce_mirror_rows), which reads both per slot from rows its
// caller computed; and K1a's Parameterized form
// (pysdm_coalesce_mirror_parameterized), which reads u01 from a row and
// evaluates the Berry 1967 kernels in its body. The pair update is one body
// for all (pair_update, instantiated with KID = ROWS_GIVEN for K1a and
// KID = PARAMETERIZED_F32 or _F64 for its Parameterized form).
//
// K1a's Parameterized form: the gravitational kernel with Berry's 1967
// efficiency, pi (Y r_max)^2 |v_t - v_t'| with Y of the instance's 13
// parameters (Parameterized, Hydrodynamic, Electric), from the "radius" and
// "relative fall velocity" rows at both slots of the pair, in the rows'
// float type and in the order of ops/cuda/collision.py parameterized_kernel
// and berry_1967_linear_collection_efficiency (integer exponents by repeated
// squaring, the others by pow, every operation rounded on its own), then
// times the scale and rounded to float32, as the rows route's
// (values * scale[0]).to(float32) does. Without it the non-adaptive Berry
// substep made that row eagerly, ~40 launches (the partner gathers, the
// efficiency chain, the product and the casts) before K1a's one.
//
// K1a replaces the TPU kernel fused_coalesce_mirror
// (pysdm_tpu/ops/pallas/collision.py:317, body _coalesce_kernel_mirror
// :220): the mirror substep of the collision kernels K1 has no body for
// (the JAX package's Parameterized, Hydrodynamic and Electric), from a
// float32 kernel x normalization x probability-scale row and a float32 u01
// row, both read at the pair's leader (the smaller slot). The TPU kernel's
// XLA-side flip and roll of the partner rows, its (BLOCK_R, LANES) padding
// and its u32 limbs are TPU-only: here the partner's index is computed in
// the thread and the multiplicities are native int64. Bound on the card:
// bytes; per slot the multiplicity (8 B) and the R extensive rows read and
// written, and at each pair's leader (half the slots) the kn and u01 rows
// (4 B each) read: 20 + 8 R B a slot with float32 rows, 36 B with two.
// The Parameterized form reads the radius and fall-velocity rows at both
// slots and u01 at the leader: 26 + 8 R B a slot with float32 rows, 34 B
// with Berry 1967's one.
//
// K1 replaces the TPU kernel fused_coalesce_mirror_blocks
// (pysdm_tpu/ops/pallas/collision.py:582, body _mk_mirror_block_kernel :422)
// and takes its semantics at every N: slot o pairs with po = (K - o) mod N,
// u01 comes from the pair-keyed PRF _u01_hash(seed, min(o, po)), and the
// collision kernel is evaluated here (sdm_pair.cuh kernel_value, the body K5
// evaluates too) from the attribute rows it reads, in the order of their
// names, as the TPU kernel takes them: "volume" for Golovin, ConstantK and
// Linear; "radius", "relative fall velocity" for Geometric; "area",
// "radius" for SimpleGeometric.
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
//   for memory once; the int64 division only where gamma falls below its
//   cap (a 128-bit product of the cap and xi_k decides; sdm_pair.cuh
//   capped_quotient). At gamma = 0 k's rows still take e_k + 0 e_j, as the
//   TPU kernel's do;
// - one instantiation per collision kernel (a template parameter), so a
//   launch evaluates its kernel with no branch on the id and loads only
//   the attribute rows that kernel reads (on an H100, a run-time id and a
//   run-time second row made Golovin's launch 11% slower at 2^20);
// - multiplicities are native int64: gamma = min(cap, xi_j / xi_k) is an
//   exact integer division. The TPU kernel has no 64-bit vector path and
//   walks an f32 quotient estimate +-5 steps instead;
// - the f32 arithmetic mirrors the TPU kernel's rounding (sdm_pair.cuh):
//   xi converts to f32 through halves, and every product and sum is rounded
//   on its own (__fmul_rn/__fadd_rn; the library is also built with
//   -fmad=false), since a fused multiply-add would change ceil(prob - u)
//   and e_k + gamma * e_j;
// - one launch: the rate and its deficit go per pair, warp and block in a
//   fixed order into per-block partials, and the last block to finish adds
//   them in a fixed block order (sdm_pair.cuh grid_sums); the coalescence
//   rate is the collision rate. The wrapper keeps the ticket counter and
//   the partials per device, stream and shape, zeroed once. No float
//   atomics: two runs give the same bits. At Berry 1967's 2^13 slots (8
//   blocks) a launch takes ~5 us, its bytes 0.08 us; one block whose
//   threads walk the pairs and sum inside the block, with no ticket, fence
//   or second phase, took longer on an H100 at every width from 2^12 to
//   2^17 slots: at 2^13 K1a 1.35x and its Parameterized form 2.4x (a
//   thread's pairs one after another, each a chain of loads and, in the
//   Parameterized form, of Berry's pows; PERF.md §6), so every width
//   takes the grid.
// Multiplicities and rows equal, bit for bit, the update computed at each
// slot from that slot's view of the pair (the twin's form); the rate sums
// are added in another order than the twin's.
//
// What bounds it on the card: bytes. Each input read once and each output
// written once, a slot moves 32 + 4 n_attr B with two float32 extensive rows
// (multiplicity 8, rows 8 and n_attr attribute rows 4 each in; multiplicity
// 8 and rows 8 out): 36 B with Golovin's one row (37.7 MB at 2^20 slots,
// 11.3 us at 3.35 TB/s), 40 B with the geometric kernels' two (41.9 MB,
// 12.5 us), for some 60 flops and at most one 64-bit division a pair.
// Measured times stand in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdm_pair.cuh"

namespace {

constexpr int THREADS = 512;  // pairs a block
// extensive rows of both slots loaded with the multiplicities
constexpr int ROWS_AHEAD = 2;
constexpr int SCRATCH_HEAD = 16;  // bytes before the partials: the counter
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24
// the KID of K1a: kernel x norm and u01 given as rows
constexpr int ROWS_GIVEN = -1;
// the KIDs of K1a's Parameterized form: u01 given as a row, the Berry 1967
// kernel evaluated from float32 or float64 radius and fall-velocity rows
constexpr int PARAMETERIZED_F32 = -2;
constexpr int PARAMETERIZED_F64 = -3;
template <int KID>
constexpr bool parameterized = KID == PARAMETERIZED_F32 || KID == PARAMETERIZED_F64;

// the rows' float type of K1a's Parameterized form
template <int KID>
struct AttrType {
  using type = float;
};
template <>
struct AttrType<PARAMETERIZED_F64> {
  using type = double;
};

// Parameterized's 13 parameters, A B D1 D2 E1 E2 F1 F2 G1 G2 G3 Mf Mg, as
// host doubles, and the exponents D2, E2, Mf and Mg that are Python ints:
// the int (> 0), or 0 where the exponent is a float
struct Berry {
  double c[13];
  int int_exponent[4];
};
enum { A_, B_, D1_, D2_, E1_, E2_, F1_, F2_, G1_, G2_, G3_, MF_, MG_ };

__device__ __forceinline__ float pow_rn(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_rn(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float max_rn(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double max_rn(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float min_rn(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double min_rn(double x, double y) { return fmin(x, y); }
__device__ __forceinline__ float abs_rn(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_rn(double x) { return fabs(x); }

// torch.maximum and torch.minimum: a NaN in either gives NaN
template <typename A>
__device__ __forceinline__ A nan_maximum(A a, A b) {
  return a != a ? a : b != b ? b : max_rn(a, b);
}
template <typename A>
__device__ __forceinline__ A nan_minimum(A a, A b) {
  return a != a ? a : b != b ? b : min_rn(a, b);
}

// x ** e as ops/cuda/breakup.py _power takes it: a Python int e > 0 by
// repeated squaring (jax.lax.integer_pow's order), a float by pow
template <typename A>
__device__ __forceinline__ A power(A x, const Berry& b, int which, int slot) {
  int e = b.int_exponent[slot];
  if (e <= 0) return pow_rn(x, (A)b.c[which]);
  A acc = x;
  bool have = false;
  while (e > 0) {
    if (e & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    e >>= 1;
    if (e > 0) x = x * x;
  }
  return acc;
}

// Parameterized.pairwise at one pair: pi (Y r_big)^2 |va - vb|, Y Berry's
// linear collection efficiency at (r_big, r_small) in micrometres, every
// operation of the twin in the twin's order
template <typename A>
__device__ A parameterized_value(const Berry& b, A ra, A rb, A va, A vb) {
  const A r_big = nan_maximum(ra, rb), r_small = nan_minimum(ra, rb);
  const A unit = (A)1e-6;
  const A r = r_big / unit;
  const A r_s = r_small / unit;
  const A p = r_s / (r > (A)0 ? r : (A)1);
  const A G = (power((A)b.c[G1_] / r, b, MG_, 3) + (A)b.c[G2_]) +
              (A)b.c[G3_] * r;
  A one_minus_p = (A)1 - p;  // torch.clamp(., 0, 1): NaN stays NaN
  if (one_minus_p == one_minus_p)
    one_minus_p = min_rn(max_rn(one_minus_p, (A)0), (A)1);
  const A Gp = pow_rn(one_minus_p, G);
  const A D = (A)b.c[D1_] / power(r, b, D2_, 0);
  const A E = (A)b.c[E1_] / power(r, b, E2_, 1);
  const A F = power((A)b.c[F1_] / r, b, MF_, 2) + (A)b.c[F2_];
  const bool inside = p > (A)0 && p < (A)1;
  const A safe_p = inside ? p : (A)0.5;
  const A safe_Gp = Gp != (A)0 ? Gp : (A)1;
  A Y = (((A)b.c[A_] + (A)b.c[B_] * p) + D / pow_rn(safe_p, F)) + E / safe_Gp;
  Y = inside && Gp != (A)0 ? Y : (A)0;
  Y = nan_maximum(Y, (A)0);
  const A Yr = Y * r_big;
  return ((A)3.141592653589793 * (Yr * Yr)) * abs_rn(va - vb);
}

using sdm::BIG;
using sdm::merge_rn;
using sdm::u32_to_f32;
using sdm::u64_to_f32;

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

// the attribute rows collision kernel KID reads: "volume" for the first
// three, "radius" and "relative fall velocity" for GEOMETRIC, "area" and
// "radius" for SIMPLE_GEOMETRIC; K1a reads none (its Parameterized form
// reads its two rows through BerryArgs::radius and BerryArgs::fall)
template <int KID>
__host__ __device__ constexpr int attr_rows() {
  return KID < 0 ? 0
         : KID == sdm::GEOMETRIC || KID == sdm::SIMPLE_GEOMETRIC ? 2
                                                                  : 1;
}

// the kernel value from the attribute rows of both slots (x0, x1: the rows
// in name order)
template <int KID>
__device__ __forceinline__ float pair_kernel(float p0, float p1, float x0o,
                                             float x0p, float x1o, float x1p) {
  switch (KID) {
    case sdm::GEOMETRIC:  // radius, relative fall velocity
      return sdm::kernel_value(KID, p0, p1, 0.0f, 0.0f, x0o, x0p, x1o, x1p);
    case sdm::SIMPLE_GEOMETRIC:  // area, radius
      return sdm::kernel_value(KID, p0, p1, 0.0f, 0.0f, x1o, x1p, x0o, x0p);
    default:  // volume
      return sdm::kernel_value(KID, p0, p1, x0o, x0p, 0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <typename T>
struct Args {
  const int64_t* __restrict__ mult;
  const T* __restrict__ ext;
  int n_ext;
  const float* __restrict__ attr;  // (attr_rows<KID>(), n)
  float p0, p1;
  const float* __restrict__ scale;
  int64_t n;
  uint32_t seed;
  int64_t* __restrict__ mult_out;
  T* __restrict__ ext_out;
  // K1a's rows: kernel x norm x scale and u01, read at the leader
  const float* __restrict__ kn;
  const float* __restrict__ u01;

  // a slot that keeps its values
  __device__ void keep(int64_t slot) const {
    mult_out[slot] = mult[slot];
    for (int r = 0; r < n_ext; ++r)
      ext_out[(int64_t)r * n + slot] = ext[(int64_t)r * n + slot];
  }
};

// K1a's Parameterized form's arguments: K1a's (u01 read at the leader),
// the radius and the relative fall velocity (n,) and the scale (1,), in
// AttrType<KID>, and the kernel's parameters. Apart from Args, so that the
// other forms' launches pass what they passed before it (with these in
// Args, K1 at 2^20 took 3-5% longer on an H100)
template <typename T>
struct BerryArgs : Args<T> {
  const void* __restrict__ radius;
  const void* __restrict__ fall;
  const void* __restrict__ pscale;
  Berry berry;
};

// the pair (o, po), o < po the leader: computed once, both slots written;
// returns the pair's rate and deficit in s. X: Args<T>, or BerryArgs<T>
// for K1a's Parameterized form
template <typename T, int KID, typename X>
__device__ void pair_update(const X& x, int64_t o, int64_t po,
                            float (&s)[2]) {
  // every load first and none behind a branch on loaded data, so that the
  // pair waits for memory once
  const int64_t a = x.mult[o], b = x.mult[po];
  constexpr bool given = KID == ROWS_GIVEN;
  constexpr bool berry = parameterized<KID>;
  constexpr bool two_rows = attr_rows<KID>() == 2;
  using A = typename AttrType<KID>::type;
  // K1a: x0o is kn and x0p is u01, both the leader's; its Parameterized
  // form: x0p is u01
  const float x0o = given ? x.kn[o] : berry ? 0.0f : x.attr[o];
  const float x0p = given || berry ? x.u01[o] : x.attr[po];
  const float x1o = two_rows ? x.attr[x.n + o] : 0.0f;
  const float x1p = two_rows ? x.attr[x.n + po] : 0.0f;
  A ro = 0, rp = 0, vo = 0, vp = 0, pscale = 0;
  if constexpr (berry) {
    const A* radius = static_cast<const A*>(x.radius);
    const A* fall = static_cast<const A*>(x.fall);
    ro = radius[o];
    rp = radius[po];
    vo = fall[o];
    vp = fall[po];
    pscale = *static_cast<const A*>(x.pscale);
  }
  T eo[ROWS_AHEAD], ep[ROWS_AHEAD];
#pragma unroll
  for (int r = 0; r < ROWS_AHEAD; ++r) {
    eo[r] = r < x.n_ext ? x.ext[(int64_t)r * x.n + o] : T(0);
    ep[r] = r < x.n_ext ? x.ext[(int64_t)r * x.n + po] : T(0);
  }

  const bool in_pair = a != 0 && b != 0;
  // j = the not-smaller multiplicity; a tie goes to the leader
  const bool o_is_j = a >= b;
  const int64_t mj = o_is_j ? a : b, mk = o_is_j ? b : a;
  float kn, u;
  if constexpr (given) {
    kn = x0o;
    u = x0p;
  } else if constexpr (berry) {
    // (values * scale[0]).to(float32), values at the leader's view of the
    // pair
    kn = (float)(parameterized_value(x.berry, ro, rp, vo, vp) * pscale);
    u = x0p;
  } else {
    kn = __fmul_rn(pair_kernel<KID>(x.p0, x.p1, x0o, x0p, x1o, x1p),
                   x.scale[0]);
    u = u01_hash(x.seed, (uint32_t)o);
  }
  const float gamma_f = fmaxf(
      ceilf(__fsub_rn(__fmul_rn(u64_to_f32((uint64_t)mj), kn), u)), 0.0f);
  const int64_t cap = (int64_t)fminf(gamma_f, BIG);
  // outside a pair or at cap = 0, g = 0 without the division
  const int64_t g = in_pair && cap > 0 ? sdm::capped_quotient(mj, mk, cap) : 0;
  const float gf = u32_to_f32((uint32_t)g);

  // Shima update: xi_j -= gamma xi_k; k absorbs gamma copies of j; an
  // exhausted j takes half of k's multiplicity. At gamma = 0 k's rows still
  // take e_k + 0 e_j, as the TPU kernel's do
  const int64_t nn = mj - g * mk;
  const bool split = nn == 0 && g > 0;
  const int64_t half = mk >> 1;
  const int64_t m_j = split ? half : nn, m_k = split ? mk - half : mk;
  x.mult_out[o] = in_pair ? (o_is_j ? m_j : m_k) : a;
  x.mult_out[po] = in_pair ? (o_is_j ? m_k : m_j) : b;
  auto put = [&](int r, T e_o, T e_p) {
    const T ej = o_is_j ? e_o : e_p, ek = o_is_j ? e_p : e_o;
    const T merged = merge_rn(ek, gf, ej);
    const T new_j = split ? merged : ej;
    x.ext_out[(int64_t)r * x.n + o] = in_pair ? (o_is_j ? new_j : merged) : e_o;
    x.ext_out[(int64_t)r * x.n + po] = in_pair ? (o_is_j ? merged : new_j) : e_p;
  };
#pragma unroll
  for (int r = 0; r < ROWS_AHEAD; ++r) {
    if (r < x.n_ext) put(r, eo[r], ep[r]);
  }
  for (int r = ROWS_AHEAD; r < x.n_ext; ++r)
    put(r, x.ext[(int64_t)r * x.n + o], x.ext[(int64_t)r * x.n + po]);
  if (in_pair) {
    const float mk_f = u64_to_f32((uint64_t)mk);
    s[0] = __fmul_rn(gf, mk_f);
    s[1] = __fmul_rn(__fsub_rn(gamma_f, gf), mk_f);
  }
}

// one thread per pair; thread 0 also copies the slots that pair with
// themselves. sums: the collision rate and its deficit, then the
// coalescence rate, which in a coalescence-only substep is the first
template <typename T, int KID, typename X>
__global__ void __launch_bounds__(THREADS)
    coalesce_mirror_kernel(X x, int64_t K, unsigned* counter,
                           float* partials, float* sums) {
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float s[2] = {0.0f, 0.0f};
  if (p < sdm::mirror_pair_count(x.n, K)) {
    int64_t o, po;
    sdm::mirror_pair(x.n, K, p, &o, &po);
    pair_update<T, KID>(x, o, po, s);
  }
  if (p == 0) {
    for (int r = 0; r < 2; ++r) {
      const int64_t slot = sdm::mirror_self_slot(x.n, K, r);
      if (slot >= 0) x.keep(slot);
    }
  }
  if (sdm::grid_sums<2, THREADS>(s, counter, partials, sums) &&
      threadIdx.x == 0) {
    sums[2] = sums[0];
  }
}

// the blocks of a launch over n slots: one thread per pair, at most n / 2
// pairs
int64_t blocks_for(int64_t n) {
  const int64_t pairs = n / 2;
  return pairs > 0 ? (pairs + THREADS - 1) / THREADS : 1;
}

template <typename T, int KID, typename X = Args<T>>
int launch(X x, int64_t K, void* scratch, void* sums, cudaStream_t s) {
  char* base = (char*)scratch;
  coalesce_mirror_kernel<T, KID, X>
      <<<(unsigned)blocks_for(x.n), THREADS, 0, s>>>(
          x, K, (unsigned*)base, (float*)(base + SCRATCH_HEAD), (float*)sums);
  return (int)cudaGetLastError();
}

// the instantiation of collision kernel kernel_id, after checking that
// n_attr rows are the rows it reads
template <typename T>
int launch(Args<T> x, int kernel_id, int n_attr, int64_t K, void* scratch,
           void* sums, cudaStream_t s) {
  switch (kernel_id) {
    case sdm::GOLOVIN:
      if (n_attr != attr_rows<sdm::GOLOVIN>()) break;
      return launch<T, sdm::GOLOVIN>(x, K, scratch, sums, s);
    case sdm::CONSTANT_K:
      if (n_attr != attr_rows<sdm::CONSTANT_K>()) break;
      return launch<T, sdm::CONSTANT_K>(x, K, scratch, sums, s);
    case sdm::LINEAR:
      if (n_attr != attr_rows<sdm::LINEAR>()) break;
      return launch<T, sdm::LINEAR>(x, K, scratch, sums, s);
    case sdm::GEOMETRIC:
      if (n_attr != attr_rows<sdm::GEOMETRIC>()) break;
      return launch<T, sdm::GEOMETRIC>(x, K, scratch, sums, s);
    case sdm::SIMPLE_GEOMETRIC:
      if (n_attr != attr_rows<sdm::SIMPLE_GEOMETRIC>()) break;
      return launch<T, sdm::SIMPLE_GEOMETRIC>(x, K, scratch, sums, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the state's pointers and sizes, the rest of Args zero
template <typename T>
Args<T> state_args(const void* mult, const void* ext, int n_ext, long long n,
                   void* mult_out, void* ext_out) {
  Args<T> x = {};
  x.mult = (const int64_t*)mult;
  x.ext = (const T*)ext;
  x.n_ext = n_ext;
  x.n = n;
  x.mult_out = (int64_t*)mult_out;
  x.ext_out = (T*)ext_out;
  return x;
}

// K1a's Parameterized form's arguments from the state's and the rest
template <typename T>
BerryArgs<T> berry_args(const void* mult, const void* ext, int n_ext,
                        long long n, void* mult_out, void* ext_out,
                        const void* u01, const void* radius, const void* fall,
                        const void* scale, const double* params,
                        const int* int_exponents) {
  BerryArgs<T> x = {};
  static_cast<Args<T>&>(x) =
      state_args<T>(mult, ext, n_ext, n, mult_out, ext_out);
  x.u01 = (const float*)u01;
  x.radius = radius;
  x.fall = fall;
  x.pscale = scale;
  for (int i = 0; i < 13; ++i) x.berry.c[i] = params[i];
  for (int i = 0; i < 4; ++i) x.berry.int_exponent[i] = int_exponents[i];
  return x;
}

template <typename T>
int launch_parameterized(BerryArgs<T> x, int attr_is_f64, int64_t K,
                         void* scratch, void* sums, cudaStream_t s) {
  return attr_is_f64
             ? launch<T, PARAMETERIZED_F64>(x, K, scratch, sums, s)
             : launch<T, PARAMETERIZED_F32>(x, K, scratch, sums, s);
}

}  // namespace

extern "C" {

// bytes of scratch for n slots: the ticket counter, then the per-block
// partial sums. The caller zeroes it once, when it allocates it, and keeps
// it for the later calls on this stream (calls on one stream never
// overlap; the counter is back at 0 after every launch).
long long pysdm_coalesce_mirror_scratch_bytes(long long n) {
  return SCRATCH_HEAD + 4 * 2 * blocks_for(n);
}

// one substep in one launch; returns cudaGetLastError() after it (0 =
// success). mult, mult_out: int64 (n,); ext, ext_out: (n_ext, n) float or
// double (ext_is_f64); attr: float (n_attr, n), the rows the kernel
// kernel_id reads in the order of their names (attr_rows, pair_kernel;
// another kernel_id or row count returns cudaErrorInvalidValue); scale: float
// (1,) on the device;
// scratch: pysdm_coalesce_mirror_scratch_bytes(n) bytes; sums: float (3,)
// receives the collision rate, rate deficit and coalescence rate.
int pysdm_coalesce_mirror(const void* mult, const void* ext, int ext_is_f64,
                          int n_ext, const void* attr, int n_attr,
                          int kernel_id,
                          float p0, float p1, const void* scale, long long n,
                          long long K, unsigned int seed, void* mult_out,
                          void* ext_out, void* scratch, void* sums,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    Args<double> x = state_args<double>(mult, ext, n_ext, n, mult_out, ext_out);
    x.attr = (const float*)attr;
    x.p0 = p0;
    x.p1 = p1;
    x.scale = (const float*)scale;
    x.seed = seed;
    return launch(x, kernel_id, n_attr, K, scratch, sums, s);
  }
  Args<float> x = state_args<float>(mult, ext, n_ext, n, mult_out, ext_out);
  x.attr = (const float*)attr;
  x.p0 = p0;
  x.p1 = p1;
  x.scale = (const float*)scale;
  x.seed = seed;
  return launch(x, kernel_id, n_attr, K, scratch, sums, s);
}

// K1a: one substep in one launch, with the kernel x normalization x
// probability-scale row kn and the u01 row (float (n,) each, read at each
// pair's leader) given; otherwise as pysdm_coalesce_mirror, whose scratch
// size it takes.
int pysdm_coalesce_mirror_rows(const void* mult, const void* ext,
                               int ext_is_f64, int n_ext, const void* kn,
                               const void* u01, long long n, long long K,
                               void* mult_out, void* ext_out, void* scratch,
                               void* sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    Args<double> x = state_args<double>(mult, ext, n_ext, n, mult_out, ext_out);
    x.kn = (const float*)kn;
    x.u01 = (const float*)u01;
    return launch<double, ROWS_GIVEN>(x, K, scratch, sums, s);
  }
  Args<float> x = state_args<float>(mult, ext, n_ext, n, mult_out, ext_out);
  x.kn = (const float*)kn;
  x.u01 = (const float*)u01;
  return launch<float, ROWS_GIVEN>(x, K, scratch, sums, s);
}

// K1a's Parameterized form: one substep in one launch with the u01 row
// (float (n,), read at each pair's leader) given and the kernel evaluated
// in the body from the rows radius and fall (n,), the relative fall
// velocity, and scale (1,), the normalization times the substep's
// probability scale, all float or double (attr_is_f64); params:
// Parameterized's 13 parameters; int_exponents: D2, E2, Mf and Mg where
// each is an int (> 0), else 0. Otherwise as pysdm_coalesce_mirror_rows.
int pysdm_coalesce_mirror_parameterized(
    const void* mult, const void* ext, int ext_is_f64, int n_ext,
    const void* radius, const void* fall, int attr_is_f64,
    const double* params,
    const int* int_exponents, const void* scale, const void* u01, long long n,
    long long K, void* mult_out, void* ext_out, void* scratch, void* sums,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ext_is_f64) {
    return launch_parameterized(
        berry_args<double>(mult, ext, n_ext, n, mult_out, ext_out, u01,
                           radius, fall, scale, params, int_exponents),
        attr_is_f64, K, scratch, sums, s);
  }
  return launch_parameterized(
      berry_args<float>(mult, ext, n_ext, n, mult_out, ext_out, u01, radius,
                        fall, scale, params, int_exponents),
      attr_is_f64, K, scratch, sums, s);
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
