// Kernels K11, K12 and K13: secp256k1 ECDSA verification, with extern "C"
// launchers for ctypes (ops/_build.py).  They replace the JAX package's
// plain-jnp programs under lax.scan, which XLA compiles into one program
// each (in eager torch each would be tens of thousands of launches):
//   K11 secp_q_tables  <- cometbft_tpu/ops/secp256k1.py::q_msm_tables_kernel (:327)
//   K12 secp_msm_verify <- cometbft_tpu/ops/secp256k1.py::msm_verify_kernel (:360)
//   K13 secp_ladder    <- cometbft_tpu/ops/secp256k1.py::verify_kernel (:186)
//
// Layouts are the JAX package's, limbs first and the lane minor: a field
// element (22, B) int32, a Jacobian point (3, 22, B), the key tables
// (52, 16, 3, 22, K), bool tensors as one byte.  Arithmetic is
// fe_secp.cuh's, in the plain versions' order (ops/secp256k1.py), so every
// table limb and verdict equals the plain version's.
//
// Design: one thread per lane (K13, K12: a signature; K11: a key, then a
// (window, key) pair), blocks of SECP_THREADS = 32 so that a batch of a
// few thousand signatures spreads over the 132 SMs.  K11 is two launches:
// one thread per key walks the 52 window bases 2^(5j)*Q (5 doublings a
// window, serial) and the correction 2^260*Q; then one thread per
// (window, key) builds the window's 16 odd rows (a doubling and 15
// adds).  K12 gathers the static affine G table (32 x 128 x 2 x 22 int32,
// 720 KB, copied to the card once per device) and the key's table rows;
// K13 builds its 16-row Q table in local memory (4.2 KB a thread).
//
// What bounds them on the H100: the field products (K12 about 1,250 a
// signature, K13 about 4,600 with the inversion; chip_smoke.py counts
// them), which one thread per lane issues in long dependent chains with
// at most a few warps an SM: a latency-bound first design.
//
// Every launcher returns cudaGetLastError() of its launches; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe_secp.cuh"

#define SECP_THREADS 32

using namespace fesecp;

namespace {

constexpr int NG = 32, GROWS = 128;     // u1: 8-bit odd windows
constexpr int NQ = 52, QROWS = 16;      // u2: 5-bit odd windows, 5 doublings
constexpr int WQ = 5;
constexpr int NIB = 64;                 // ladder: 4-bit windows

__device__ __forceinline__ fe load_fe(const int32_t* p, int64_t stride,
                                      int64_t i) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = p[l * stride + i];
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* p, int64_t stride,
                                         int64_t i, const fe& a) {
#pragma unroll
  for (int l = 0; l < NL; ++l) p[l * stride + i] = a.v[l];
}

__device__ __forceinline__ jpt load_pt(const int32_t* p, int64_t stride,
                                       int64_t i) {
  jpt r;
  r.x = load_fe(p, stride, i);
  r.y = load_fe(p + NL * stride, stride, i);
  r.z = load_fe(p + 2 * NL * stride, stride, i);
  return r;
}

__device__ __forceinline__ void store_pt(int32_t* p, int64_t stride,
                                         int64_t i, const jpt& a) {
  store_fe(p, stride, i, a.x);
  store_fe(p + NL * stride, stride, i, a.y);
  store_fe(p + 2 * NL * stride, stride, i, a.z);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ------------------------------------------------------------------ K11

// one thread per key: bases[j] = 2^(5j) Q for j < 52, corr = 2^260 Q
__global__ void __launch_bounds__(SECP_THREADS)
q_bases_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
               int64_t nk, int32_t* __restrict__ bases,
               int32_t* __restrict__ corr) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nk) return;
  jpt b;
  b.x = load_fe(qx, nk, k);
  b.y = load_fe(qy, nk, k);
  b.z = fe_one();
  for (int j = 0; j < NQ; ++j) {
    store_pt(bases + (int64_t)j * 3 * NL * nk, nk, k, b);
    for (int d = 0; d < WQ; ++d) b = jdbl(b);
  }
  store_pt(corr, nk, k, b);
}

// one thread per (window j, key k): rows b, b + 2b, ..., b + 15 * 2b
__global__ void __launch_bounds__(SECP_THREADS)
q_rows_kernel(const int32_t* __restrict__ bases, int64_t nk,
              int32_t* __restrict__ qtab) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= NQ * nk) return;
  const int64_t j = t / nk, k = t % nk;
  const jpt b = load_pt(bases + j * 3 * NL * nk, nk, k);
  const jpt d2 = jdbl(b);
  int32_t* win = qtab + j * QROWS * 3 * NL * nk;
  jpt prev = b;
  store_pt(win, nk, k, prev);
  for (int m = 1; m < QROWS; ++m) {
    prev = jadd_fast(prev, d2);
    store_pt(win + (int64_t)m * 3 * NL * nk, nk, k, prev);
  }
}

// ------------------------------------------------------------------ K12

__global__ void __launch_bounds__(SECP_THREADS)
msm_verify_kernel(const int32_t* __restrict__ qtab,
                  const int32_t* __restrict__ q_corr,
                  const int32_t* __restrict__ gid,
                  const int32_t* __restrict__ g_rows,
                  const uint8_t* __restrict__ g_neg,
                  const int32_t* __restrict__ q_rows,
                  const uint8_t* __restrict__ q_neg,
                  const int32_t* __restrict__ r_limbs,
                  const int32_t* __restrict__ rn_limbs,
                  const uint8_t* __restrict__ rn_valid,
                  const int32_t* __restrict__ s_pt,
                  const int32_t* __restrict__ gtab,
                  const int32_t* __restrict__ gcorr, int64_t nb, int64_t nk,
                  uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  const int64_t slot = clampi(gid[i], 0, (int)(nk - 1));
  const jpt s = load_pt(s_pt, 1, 0);
  jpt acc = s;
  for (int j = 0; j < NG; ++j) {
    const int row = clampi(g_rows[j * nb + i], 0, GROWS - 1);
    const int32_t* ent = gtab + ((int64_t)j * GROWS + row) * 2 * NL;
    const fe ax = load_fe(ent, 1, 0);
    fe ay = load_fe(ent + NL, 1, 0);
    if (g_neg[j * nb + i]) ay = raw_neg(ay);
    acc = jadd_mixed(acc, ax, ay);
  }
  for (int j = 0; j < NQ; ++j) {
    const int row = clampi(q_rows[j * nb + i], 0, QROWS - 1);
    jpt ent = load_pt(qtab + ((int64_t)j * QROWS + row) * 3 * NL * nk, nk,
                      slot);
    if (q_neg[j * nb + i]) ent.y = raw_neg(ent.y);
    acc = jadd_fast(acc, ent);
  }
  acc = jadd_mixed(acc, load_fe(gcorr, 1, 0), load_fe(gcorr + NL, 1, 0));
  acc = jadd_fast(acc, load_pt(q_corr, nk, slot));
  jpt neg_s = s;
  neg_s.y = raw_neg(s.y);
  acc = jadd_fast(acc, neg_s);
  // inversion-free epilogue: Z != 0 and X == r Z^2 or (r + n) Z^2
  const fe z2 = sqr(acc.z);
  const bool not_inf = !is_zero(acc.z);
  const bool ok_r = eq(acc.x, mul(load_fe(r_limbs, nb, i), z2));
  const bool ok_rn =
      eq(acc.x, mul(load_fe(rn_limbs, nb, i), z2)) && rn_valid[i];
  out[i] = not_inf && (ok_r || ok_rn);
}

// ------------------------------------------------------------------ K13

__global__ void __launch_bounds__(SECP_THREADS)
ladder_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
              const int32_t* __restrict__ u1_nibs,
              const int32_t* __restrict__ u2_nibs,
              const int32_t* __restrict__ r_limbs,
              const int32_t* __restrict__ rn_limbs,
              const uint8_t* __restrict__ rn_valid,
              const int32_t* __restrict__ gtab, int64_t nb,
              uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  // rows k Q, k = 0..15: a (1, 1, 1) filler, Q, 2Q, then 13 adds of Q
  jpt qt[16];
  qt[0].x = fe_one();
  qt[0].y = fe_one();
  qt[0].z = fe_one();
  qt[1].x = load_fe(qx, nb, i);
  qt[1].y = load_fe(qy, nb, i);
  qt[1].z = fe_one();
  qt[2] = jdbl(qt[1]);
  for (int k = 3; k < 16; ++k) qt[k] = jadd_fast(qt[k - 1], qt[1]);

  jpt acc;
  acc.x = fe_one();
  acc.y = fe_one();
  acc.z = fe_zero();
  bool inf = true;
  for (int w = 0; w < NIB; ++w) {
    const int n1 = u1_nibs[w * nb + i];
    const int n2 = u2_nibs[w * nb + i];
    for (int d = 0; d < 4; ++d) acc = jdbl(acc);
    // a nibble outside 1..15 takes row 0, as the JAX select cascade does
    const int g_row = (n1 >= 1 && n1 <= 15) ? n1 : 0;
    const jpt g = load_pt(gtab + g_row * 3 * NL, 1, 0);
    jadd_complete(acc, inf, g, n1 == 0);
    const int q_row = (n2 >= 1 && n2 <= 15) ? n2 : 0;
    jadd_complete(acc, inf, qt[q_row], n2 == 0);
  }
  const fe z2 = sqr(acc.z);
  const fe x_aff = mul(acc.x, inv(z2));
  const bool eq_r = eq(x_aff, load_fe(r_limbs, nb, i));
  const bool eq_rn = eq(x_aff, load_fe(rn_limbs, nb, i)) && rn_valid[i];
  out[i] = !inf && (eq_r || eq_rn);
}

int blocks_for(int64_t n) {
  return (int)((n + SECP_THREADS - 1) / SECP_THREADS);
}

}  // namespace

extern "C" {

int secp_threads() { return SECP_THREADS; }

// K11: qx, qy (22, K) -> qtab (52, 16, 3, 22, K), corr (3, 22, K), through
// the (52, 3, 22, K) scratch `bases`
int secp_q_tables(const void* qx, const void* qy, int64_t nk, void* bases,
                  void* qtab, void* corr, void* stream) {
  if (nk == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  q_bases_kernel<<<blocks_for(nk), SECP_THREADS, 0, s>>>(
      (const int32_t*)qx, (const int32_t*)qy, nk, (int32_t*)bases,
      (int32_t*)corr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  q_rows_kernel<<<blocks_for(NQ * nk), SECP_THREADS, 0, s>>>(
      (const int32_t*)bases, nk, (int32_t*)qtab);
  return (int)cudaGetLastError();
}

// K12: one verdict byte per signature
int secp_msm_verify(const void* qtab, const void* q_corr, const void* gid,
                    const void* g_rows, const void* g_neg, const void* q_rows,
                    const void* q_neg, const void* r_limbs,
                    const void* rn_limbs, const void* rn_valid,
                    const void* s_pt, const void* gtab, const void* gcorr,
                    int64_t nb, int64_t nk, void* out, void* stream) {
  if (nb == 0) return 0;
  msm_verify_kernel<<<blocks_for(nb), SECP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qtab, (const int32_t*)q_corr, (const int32_t*)gid,
      (const int32_t*)g_rows, (const uint8_t*)g_neg, (const int32_t*)q_rows,
      (const uint8_t*)q_neg, (const int32_t*)r_limbs,
      (const int32_t*)rn_limbs, (const uint8_t*)rn_valid,
      (const int32_t*)s_pt, (const int32_t*)gtab, (const int32_t*)gcorr, nb,
      nk, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// K13: one verdict byte per signature
int secp_ladder(const void* qx, const void* qy, const void* u1_nibs,
                const void* u2_nibs, const void* r_limbs,
                const void* rn_limbs, const void* rn_valid, const void* gtab,
                int64_t nb, void* out, void* stream) {
  if (nb == 0) return 0;
  ladder_kernel<<<blocks_for(nb), SECP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)u1_nibs,
      (const int32_t*)u2_nibs, (const int32_t*)r_limbs,
      (const int32_t*)rn_limbs, (const uint8_t*)rn_valid,
      (const int32_t*)gtab, nb, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
