// Straus MSM pieces on thread quads (fe25519_quad.cuh) shared by the
// window-major kernels: K3 (ed25519_kernels.cu) and K5
// (ed25519_engines.cu).  Both split the TPU kernel's single accumulator
// the same way: window sums S[j][c] of lane groups c computed across the
// card with no doubling in them, then msm_horner_kernel, one quad per
// group c, acc <- 32 acc + S[j][c] in MSB order.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"
#include "fe25519_quad.cuh"

// threads of a Horner block (one warp: 8 chains); ops/cuda_msm.py
// CHAIN_THREADS mirrors it
#define CHAIN_THREADS 32

namespace fe25519 {

// One coordinate of a lane's selected, signed table row (the plain
// version's _select_signed): row |d| of the lane, X and T negated (plain
// arithmetic negation) when the sign is set; a magnitude outside 0..16
// selects row 0, the identity; a lane at or past W is the identity.
// mags / negs point at one window's (W,) row.
__device__ __forceinline__ fe load_signed(const int32_t* __restrict__ tab,
                                          const int32_t* __restrict__ mags,
                                          const uint8_t* __restrict__ negs, int64_t w,
                                          int64_t lane, int coord) {
  if (lane >= w) return fe_small(coord == 1 || coord == 2 ? 1 : 0);
  int m = mags[lane];
  if (m < 0 || m > 16) m = 0;
  fe r = load_fe(tab + (int64_t)m * 4 * NL * w, w, lane, coord);
  if (negs[lane] && (coord == 0 || coord == 3)) {
#pragma unroll
    for (int l = 0; l < NL; ++l) r.v[l] = -r.v[l];
  }
  return r;
}

}  // namespace fe25519

// Horner chains, one quad per lane group c: acc = S[0][c], then
// acc <- straus_step(acc, S[j][c]) for j = 1 .. nwin-1.  The next
// window's sum is loaded one step ahead; thread 3 computes its 2d T in the
// free product slot of the first doubling (no T), so a Straus step is 12
// product rounds in series.  Thread q loads coordinates X, Y (q < 3) or
// Z, T (q = 3) of each sum: the ones its round-1 operand of the add needs.
// The chain, (nwin - 1) Straus steps in series, is the latency floor of
// the method.
// sums: (nwin, 4, 20, k); out: (4, 20, k).
__global__ void __launch_bounds__(CHAIN_THREADS)
msm_horner_kernel(const int32_t* __restrict__ sums, int nwin, int64_t k,
                  int32_t* __restrict__ out) {
  using namespace fe25519;
  const int q = quad_q();
  const int64_t chain = (int64_t)blockIdx.x * (CHAIN_THREADS / 4) + (threadIdx.x >> 2);
  const int64_t c = chain < k ? chain : k - 1;   // spare quads repeat the last chain
  const int64_t win = 4 * NL * k;
  const int ca = q == 3 ? 2 : 0;
  const fe d2 = fe_const(D2_LIMBS);
  fe acc = load_fe(sums, k, c, q);
  fe na = acc, nb = acc;
  if (nwin > 1) {
    na = load_fe(sums + win, k, c, ca);
    nb = load_fe(sums + win, k, c, ca + 1);
  }
#pragma unroll 1
  for (int j = 1; j < nwin; ++j) {
    const fe sa = na, sb = nb;                   // X, Y or Z, T of S[j]
    if (j + 1 < nwin) {
      na = load_fe(sums + (j + 1) * win, k, c, ca);
      nb = load_fe(sums + (j + 1) * win, k, c, ca + 1);
    }
    fe t2d;
    acc = qdouble_side(acc, sb, d2, t2d);
#pragma unroll 1
    for (int r = 0; r < 3; ++r) acc = qdouble(acc, false);
    acc = qdouble(acc, true);
    const fe d = qshfl(t2d, 3);
    const fe cn = fsel(q == 0, sub(sb, sa),
                       fsel(q == 1, add(sb, sa), fsel(q == 2, d, mul_word(sa, 2))));
    acc = qadd_cached(acc, cn);
  }
  if (chain < k) store_fe(out, k, c, q, acc);
}

// Launches msm_horner_kernel over k chains on `stream`; returns
// cudaGetLastError() of the launch.
static inline int launch_msm_horner(const int32_t* sums, int nwin, int64_t k, int32_t* out,
                                    cudaStream_t stream) {
  const int64_t per_block = CHAIN_THREADS / 4;
  msm_horner_kernel<<<(unsigned)((k + per_block - 1) / per_block), CHAIN_THREADS, 0, stream>>>(
      sums, nwin, k, out);
  return (int)cudaGetLastError();
}
