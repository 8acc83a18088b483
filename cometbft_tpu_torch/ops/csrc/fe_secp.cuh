// GF(p), p = 2^256 - 2^32 - 977, and secp256k1 Jacobian point operations,
// one element per thread, for the port's secp256k1 kernels (K11-K13 in
// secp256k1_kernels.cu).
//
// The representation is the JAX package's (cometbft_tpu/ops/fe_secp.py),
// kept on purpose so its bounds proof carries over and every intermediate
// equals the plain torch version (ops/fe_secp.py) limb for limb:
//   - 22 SIGNED radix-2^12 limbs in int32 (264 bits), lazy carries;
//   - 2^264 == 2^40 + 250112 (mod p): a carry out of the top limb
//     re-enters as +256 at limb 0, +61 at limb 1, +16 at limb 3;
//   - op outputs are "weak" (limbs in about [-1800, 4900]); mul accepts
//     |limb| <= 5000, so each of the 43 product columns, and every partial
//     sum of one, stays below 22 * 5000^2 = 5.5e8 < 2^31.
// Sums are exact int32 integer sums, so their order is free; the carry
// passes (the only nonlinear steps) run in the JAX order.  Right shifts
// of negative limbs are arithmetic (floor), as in JAX and torch; left
// shifts of negative values are undefined in C++17, so the code
// multiplies instead.
//
// Cost per element: mul 484 multiply-adds, sqr 253 (cross terms once
// against doubled limbs: the same column values).  Products, the exact
// freeze and the point operations are __noinline__ functions: each is
// one call site in the kernels' loops, which keeps the build to seconds
// and the code small; their operands live in local memory.

#pragma once

#include <cstdint>

namespace fesecp {

constexpr int NL = 22;            // limbs
constexpr int RADIX = 12;
constexpr int32_t MASK = 4095;

// 17p on the limbs (every digit but the top >= 3839) and the canonical
// digits of p: the limbs of ops/fe_secp.py (a CPU test checks them)
__device__ __constant__ int32_t PAD_17P[NL] = {
    3871, 4091, 3839, 4094, 4095, 4095, 4095, 4095, 4095, 4095, 4095,
    4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 271};
__device__ __constant__ int32_t P_CANON[NL] = {
    3119, 4095, 3839, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095,
    4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 4095, 15};
// p - 2, 32-bit words little-endian: the Fermat exponent
__device__ __constant__ uint32_t PM2_WORDS[8] = {
    0xfffffc2du, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};

struct fe {
  int32_t v[NL];
};

struct jpt {
  fe x, y, z;
};

// ---------------------------------------------------------------- carries

__device__ __forceinline__ fe carry(const fe& x) {
  fe r;
  const int32_t top = x.v[NL - 1] >> RADIX;
  r.v[0] = (x.v[0] & MASK) + top * 256;
#pragma unroll
  for (int i = 1; i < NL; ++i) r.v[i] = (x.v[i] & MASK) + (x.v[i - 1] >> RADIX);
  r.v[1] += top * 61;
  r.v[3] += top * 16;
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

// the limbs negated, no carry (the JAX package's -ent[1] on a table row)
__device__ __forceinline__ fe raw_neg(const fe& a) {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = -a.v[i];
  return t;
}

__device__ __forceinline__ fe fe_one() {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = 0;
  t.v[0] = 1;
  return t;
}

__device__ __forceinline__ fe fe_zero() {
  fe t;
#pragma unroll
  for (int i = 0; i < NL; ++i) t.v[i] = 0;
  return t;
}

// ---------------------------------------------------------------- products

// 43 product columns (c[43] = 0) -> weak form: one carry pass in 44-column
// space; the 22 high columns re-enter through 2^264 at limbs 0, 1, 3, the
// terms past limb 21 landing in a 5-limb spill; exactly one carry pass of
// the spill; the spill folded through 2^264 again; two weak passes.
__device__ __forceinline__ fe prod_tail(const int32_t (&c)[2 * NL]) {
  int32_t d[2 * NL];
  d[0] = c[0] & MASK;
#pragma unroll
  for (int k = 1; k < 2 * NL; ++k) d[k] = (c[k] & MASK) + (c[k - 1] >> RADIX);
  int32_t t[NL + 5];
#pragma unroll
  for (int k = 0; k < NL; ++k) t[k] = d[k];
#pragma unroll
  for (int k = NL; k < NL + 5; ++k) t[k] = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int32_t h = d[NL + k];
    t[k] += 256 * h;
    t[k + 1] += 61 * h;
    t[k + 3] += 16 * h;
  }
  int32_t s[5];
  s[0] = t[NL] & MASK;
#pragma unroll
  for (int j = 1; j < 5; ++j) s[j] = (t[NL + j] & MASK) + (t[NL + j - 1] >> RADIX);
  fe o;
#pragma unroll
  for (int k = 0; k < NL; ++k) o.v[k] = t[k];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    o.v[j] += 256 * s[j];
    o.v[j + 1] += 61 * s[j];
    o.v[j + 3] += 16 * s[j];
  }
  return norm_weak(o);
}

__device__ __noinline__ fe mul(const fe& a, const fe& b) {
  int32_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t ai = a.v[i];
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += ai * b.v[j];
  }
  return prod_tail(c);
}

__device__ __noinline__ fe sqr(const fe& a) {
  int32_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t ai = a.v[i];
    c[2 * i] += ai * ai;
    const int32_t a2 = 2 * ai;
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += a2 * a.v[j];
  }
  return prod_tail(c);
}

// z^(p-2): square-and-multiply over the exponent bits, MSB first
__device__ __noinline__ fe inv(const fe& z) {
  fe acc = fe_one();
  for (int i = 255; i >= 0; --i) {
    acc = sqr(acc);
    if ((PM2_WORDS[i >> 5] >> (i & 31)) & 1u) acc = mul(acc, z);
  }
  return acc;
}

// ---------------------------------------------------------------- freeze

// exact sequential carry, then the bits at and above 2^256 (limb 21 bits
// >= 4, and the carry out in units of 2^264) re-enter through
// 2^256 == 2^32 + 977 (2^32 = 2^(2*12 + 8): limb 2, times 256)
__device__ __forceinline__ void seq_canonical_pass(int32_t (&x)[NL]) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t v = x[i] + c;
    const int32_t lo = v & MASK;
    x[i] = lo;
    c = (v - lo) >> RADIX;
  }
  const int32_t extra = (x[NL - 1] >> 4) + c * 256;
  x[NL - 1] &= 0xF;
  x[0] += extra * 977;
  x[2] += extra * 256;
}

__device__ __noinline__ fe freeze(const fe& a) {
  const fe w = norm_weak(a);
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = w.v[i] + PAD_17P[i];
  seq_canonical_pass(x);
  seq_canonical_pass(x);
  seq_canonical_pass(x);
  bool gt = false, eq = true;
#pragma unroll
  for (int i = NL - 1; i >= 0; --i) {
    gt = gt || (eq && x[i] > P_CANON[i]);
    eq = eq && x[i] == P_CANON[i];
  }
  const bool take = gt || eq;
  fe r;
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t v = x[i] - P_CANON[i] + c;
    const int32_t lo = v & MASK;
    c = (v - lo) >> RADIX;
    r.v[i] = take ? lo : x[i];
  }
  return r;
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  const fe f = freeze(a);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= f.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const fe& a, const fe& b) {
  return is_zero(sub(a, b));
}

// ---------------------------------------------------------------- points

// dbl-2009-l for a = 0, in the plain version's order
__device__ __noinline__ jpt jdbl(const jpt& p) {
  const fe a = sqr(p.x);
  const fe b = sqr(p.y);
  const fe c = sqr(b);
  fe d = sub(sub(sqr(add(p.x, b)), a), c);
  d = add(d, d);
  const fe e = add(add(a, a), a);
  const fe f = sqr(e);
  jpt r;
  r.x = sub(f, add(d, d));
  fe c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  r.y = sub(mul(e, sub(d, r.x)), c8);
  const fe z3 = mul(p.y, p.z);
  r.z = add(z3, z3);
  return r;
}

// add-2007-bl; undefined for p == +-q or infinities.  h and rr out.
__device__ __noinline__ jpt jadd_core(const jpt& p, const jpt& q, fe& h,
                                      fe& rr) {
  const fe z1z1 = sqr(p.z);
  const fe z2z2 = sqr(q.z);
  const fe u1 = mul(p.x, z2z2);
  const fe u2 = mul(q.x, z1z1);
  const fe s1 = mul(mul(p.y, q.z), z2z2);
  const fe s2 = mul(mul(q.y, p.z), z1z1);
  h = sub(u2, u1);
  rr = sub(s2, s1);
  const fe h2 = sqr(h);
  const fe h3 = mul(h, h2);
  const fe v = mul(u1, h2);
  jpt r;
  r.x = sub(sub(sqr(rr), h3), add(v, v));
  r.y = sub(mul(rr, sub(v, r.x)), mul(s1, h3));
  r.z = mul(mul(p.z, q.z), h);
  return r;
}

__device__ __forceinline__ jpt jadd_fast(const jpt& p, const jpt& q) {
  fe h, rr;
  return jadd_core(p, q, h, rr);
}

// madd-2007-bl (Z2 = 1): p + affine (ax, ay); incomplete
__device__ __noinline__ jpt jadd_mixed(const jpt& p, const fe& ax,
                                       const fe& ay) {
  const fe z1z1 = sqr(p.z);
  const fe u2 = mul(ax, z1z1);
  const fe s2 = mul(mul(ay, p.z), z1z1);
  const fe h = sub(u2, p.x);
  const fe hh = sqr(h);
  const fe i4 = add(add(hh, hh), add(hh, hh));
  const fe j = mul(h, i4);
  fe rr = sub(s2, p.y);
  rr = add(rr, rr);
  const fe v = mul(p.x, i4);
  jpt r;
  r.x = sub(sub(sqr(rr), j), add(v, v));
  const fe y1j = mul(p.y, j);
  r.y = sub(mul(rr, sub(v, r.x)), add(y1j, y1j));
  r.z = sub(sub(sqr(add(p.z, h)), z1z1), hh);
  return r;
}

// Exact addition, the JAX selects in their order: the doubling where
// h == r == 0, q where p is at infinity, p where q is, the (1, 1, 1)
// filler and infinity where h == 0 != r.  The doubling is computed only
// where it is selected: it is the same value either way.
__device__ __noinline__ void jadd_complete(jpt& p, bool& p_inf, const jpt& q,
                                           bool q_inf) {
  fe h, rr;
  const jpt added = jadd_core(p, q, h, rr);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(rr);
  const bool is_dbl = h_zero && r_zero && !p_inf && !q_inf;
  const bool is_cancel = h_zero && !r_zero && !p_inf && !q_inf;
  jpt out = is_dbl ? jdbl(p) : added;
  if (p_inf) out = q;
  if (q_inf) out = p;
  if (is_cancel) {
    out.x = fe_one();
    out.y = fe_one();
    out.z = fe_one();
  }
  p_inf = (p_inf && q_inf) || is_cancel;
  p = out;
}

}  // namespace fesecp
