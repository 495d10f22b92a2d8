// Single-cell SDM coalescence substep under the mirror croupier, for Hopper
// (sm_90a). Two plain C entry points, loaded with ctypes by
// pysdm_tpu_torch/ops/cuda/collision.py, which also holds the plain PyTorch
// twins of both (coalesce_mirror_reference, coalesce_mirror_rows_reference):
// K1 (pysdm_coalesce_mirror), which evaluates the collision kernel and draws
// u01 in its body, and K1a (pysdm_coalesce_mirror_rows), which reads both
// per slot from rows its caller computed. The pair update is one body for
// both (pair_update, instantiated with KID = ROWS_GIVEN for K1a).
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
// written, the kn and u01 rows (4 B each) read: 24 + 8 R B with float32
// rows, 40 B with two.
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
//   atomics: two runs give the same bits.
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
// "radius" for SIMPLE_GEOMETRIC; K1a reads none
template <int KID>
__host__ __device__ constexpr int attr_rows() {
  return KID == ROWS_GIVEN ? 0
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

// the pair (o, po), o < po the leader: computed once, both slots written;
// returns the pair's rate and deficit in s
template <typename T, int KID>
__device__ void pair_update(const Args<T>& x, int64_t o, int64_t po,
                            float (&s)[2]) {
  // every load first and none behind a branch on loaded data, so that the
  // pair waits for memory once
  const int64_t a = x.mult[o], b = x.mult[po];
  constexpr bool given = KID == ROWS_GIVEN;
  constexpr bool two_rows = attr_rows<KID>() == 2;
  // K1a: x0o is kn and x0p is u01, both the leader's
  const float x0o = given ? x.kn[o] : x.attr[o];
  const float x0p = given ? x.u01[o] : x.attr[po];
  const float x1o = two_rows ? x.attr[x.n + o] : 0.0f;
  const float x1p = two_rows ? x.attr[x.n + po] : 0.0f;
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
template <typename T, int KID>
__global__ void __launch_bounds__(THREADS)
    coalesce_mirror_kernel(Args<T> x, int64_t K, unsigned* counter,
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

template <typename T, int KID>
int launch(Args<T> x, int64_t K, void* scratch, void* sums, cudaStream_t s) {
  char* base = (char*)scratch;
  coalesce_mirror_kernel<T, KID><<<(unsigned)blocks_for(x.n), THREADS, 0, s>>>(
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
    return launch(Args<double>{(const int64_t*)mult, (const double*)ext,
                               n_ext, (const float*)attr, p0, p1,
                               (const float*)scale, n, seed,
                               (int64_t*)mult_out, (double*)ext_out,
                               nullptr, nullptr},
                  kernel_id, n_attr, K, scratch, sums, s);
  }
  return launch(Args<float>{(const int64_t*)mult, (const float*)ext, n_ext,
                            (const float*)attr, p0, p1, (const float*)scale,
                            n, seed, (int64_t*)mult_out, (float*)ext_out,
                            nullptr, nullptr},
                kernel_id, n_attr, K, scratch, sums, s);
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
    return launch<double, ROWS_GIVEN>(
        Args<double>{(const int64_t*)mult, (const double*)ext, n_ext,
                     nullptr, 0.0f, 0.0f, nullptr, n, 0u, (int64_t*)mult_out,
                     (double*)ext_out, (const float*)kn, (const float*)u01},
        K, scratch, sums, s);
  }
  return launch<float, ROWS_GIVEN>(
      Args<float>{(const int64_t*)mult, (const float*)ext, n_ext, nullptr,
                  0.0f, 0.0f, nullptr, n, 0u, (int64_t*)mult_out,
                  (float*)ext_out, (const float*)kn, (const float*)u01},
      K, scratch, sums, s);
}

const char* pysdm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
