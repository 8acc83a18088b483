// GF(2^255 - 19) arithmetic, one element per thread, for the port's
// hand-written Hopper kernels.
//
// The representation is the JAX package's (cometbft_tpu/ops/fe.py), kept
// on purpose so its bounds proof carries over and every intermediate
// agrees limb for limb with the plain torch version (ops/fe.py):
//   - 20 SIGNED radix-2^13 limbs in int32, lazy carries;
//   - 2^260 == 608 (mod p) folds the carry out of the top limb;
//   - op outputs are "weak" (limbs in [-1220, 9800]); mul accepts
//     |limb| <= 10300, so each of the 39 product columns, and every
//     partial sum of one, stays below 20 * 10300^2 = 2.12e9 < 2^31.
// Right shifts of negative limbs are arithmetic (floor), as in JAX and
// torch.  Left shifts of negative values are undefined in C++17, so the
// code multiplies instead (lo = x & MASK is x - (x >> 13) * 8192).
//
// Cost per element: mul is 400 multiply-adds, sqr 210 (cross terms once
// against doubled limbs).  Point operations split over a thread quad are
// in fe25519_quad.cuh.

#pragma once

#include <cstdint>

namespace fe25519 {

constexpr int NL = 20;          // limbs
constexpr int RADIX = 13;
constexpr int32_t MASK = 8191;
constexpr int32_t WRAP = 608;   // 2^260 mod p

// curve constants, limbs of ops/fe.py (a CPU test checks them)
__device__ __constant__ int32_t D_LIMBS[NL] = {
    6307, 6859, 4740, 5787, 5982, 3157, 1287, 2472, 4106, 3,
    6694, 3827, 1943, 928, 3635, 8142, 2927, 1905, 219, 164};
__device__ __constant__ int32_t D2_LIMBS[NL] = {
    4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20, 7,
    5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438, 72};
__device__ __constant__ int32_t SQRT_M1_LIMBS[NL] = {
    176, 4213, 2514, 7222, 3150, 4668, 5311, 213, 792, 6522,
    5609, 7159, 2451, 1664, 3245, 7137, 4033, 1026, 201, 87};
__device__ __constant__ int32_t PAD_8P[NL] = {
    8040, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191,
    8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 2047};
__device__ __constant__ int32_t P_CANON[NL] = {
    8173, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191,
    8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 255};

struct fe {
  int32_t v[NL];
};

// ---------------------------------------------------------------- carries

__device__ __forceinline__ fe carry(const fe& x) {
  fe r;
  int32_t top = x.v[NL - 1] >> RADIX;
  r.v[0] = (x.v[0] & MASK) + top * WRAP;
#pragma unroll
  for (int i = 1; i < NL; ++i) r.v[i] = (x.v[i] & MASK) + (x.v[i - 1] >> RADIX);
  return r;
}

__device__ __forceinline__ fe norm_weak(const fe& x) { return carry(carry(x)); }

__device__ __forceinline__ fe add(const fe& a, const fe& b) {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = a.v[i] + b.v[i];
  return carry(t);
}

__device__ __forceinline__ fe sub(const fe& a, const fe& b) {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = a.v[i] - b.v[i];
  return carry(t);
}

__device__ __forceinline__ fe neg(const fe& a) {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = -a.v[i];
  return carry(t);
}

__device__ __forceinline__ fe mul_word(const fe& a, int32_t w) {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = a.v[i] * w;
  return norm_weak(t);
}

// 39 product columns -> weak form (ops/fe.py _prod_tail)
__device__ __forceinline__ fe prod_tail(const int32_t (&c)[2 * NL - 1]) {
  int32_t a[2 * NL];
  a[0] = c[0] & MASK;
#pragma unroll
  for (int k = 1; k < 2 * NL - 1; ++k) a[k] = (c[k] & MASK) + (c[k - 1] >> RADIX);
  a[2 * NL - 1] = c[2 * NL - 2] >> RADIX;
  fe out;
#pragma unroll
  for (int k = 0; k < NL; ++k) out.v[k] = a[k] + WRAP * a[NL + k];
  return norm_weak(out);
}

__device__ __forceinline__ fe mul(const fe& a, const fe& b) {
  int32_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += a.v[i] * b.v[j];
  }
  return prod_tail(c);
}

__device__ __forceinline__ fe sqr(const fe& a) {
  int32_t c[2 * NL - 1];
  int32_t a2[NL];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) a2[i] = a.v[i] + a.v[i];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] += a.v[i] * a.v[i];
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += a2[i] * a.v[j];
  }
  return prod_tail(c);
}

// ------------------------------------------------------- canonical form

// exact ripple over the limbs; returns the carry out of limb 19
__device__ __forceinline__ int32_t ripple(fe& x) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int32_t v = x.v[i] + c;
    int32_t lo = v & MASK;
    x.v[i] = lo;
    c = (v - lo) >> RADIX;
  }
  return c;
}

__device__ __noinline__ fe freeze(const fe& a) {
  fe x = norm_weak(a);
#pragma unroll
  for (int i = 0; i < NL; ++i) x.v[i] += PAD_8P[i];   // all limbs > 0
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    int32_t c = ripple(x);
    int32_t top = x.v[NL - 1] >> 8;
    x.v[NL - 1] &= 0xFF;
    x.v[0] += top * 19 + c * WRAP;
  }
  // value < 2^255 now: subtract p once if x >= p
  bool gt = false, eq = true;
#pragma unroll
  for (int i = NL - 1; i >= 0; --i) {
    gt = gt || (eq && x.v[i] > P_CANON[i]);
    eq = eq && x.v[i] == P_CANON[i];
  }
  fe d;
#pragma unroll
  for (int i = 0; i < NL; ++i) d.v[i] = x.v[i] - P_CANON[i];
  ripple(d);
  return (gt || eq) ? d : x;
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  fe f = freeze(a);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= f.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const fe& a, const fe& b) {
  return is_zero(sub(a, b));
}

__device__ __forceinline__ fe fe_const(const int32_t (&c)[NL]) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ fe fe_small(int32_t v) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  r.v[0] = v;
  return r;
}

// ----------------------------------------------- limbs-first tensor I/O
// A point tensor is (4, 20, W) int32: element (coord c, limb l, lane) at
// (c * 20 + l) * W + lane, so neighbouring threads read neighbouring words.

__device__ __forceinline__ fe load_fe(const int32_t* base, int64_t w, int64_t lane, int coord) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = base[(int64_t)(coord * NL + l) * w + lane];
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* base, int64_t w, int64_t lane, int coord,
                                         const fe& x) {
#pragma unroll
  for (int l = 0; l < NL; ++l) base[(int64_t)(coord * NL + l) * w + lane] = x.v[l];
}

}  // namespace fe25519
