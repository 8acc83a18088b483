// GF(p), p = 2^256 - 2^32 - 977, in the card's native radix, and the
// secp256k1 Jacobian point operations on it, one element per thread: the
// field of K11, K12 and K13 (secp256k1_kernels.cu).
//
// Representation: eight 32-bit words, radix 2^32, little-endian, any
// value in [0, 2^256); an element is frozen to [0, p) only where it is
// compared (is_zero, eq) or stored (to_limbs).
//   - A product is an 8 x 8 schoolbook of 32 x 32 -> 64-bit products
//     (IMAD.WIDE.U32: 64, a square 36), scanned by columns: column k sums
//     the low halves of the products a_i b_j with i + j = k and the high
//     halves of those with i + j = k - 1 in 64 bits (below 2^37), so the
//     columns are independent chains and one carry pass ends them (row
//     by row, each product waits on the last one's carry: slower on the
//     card).  Then the fold of the high half through 2^256 == 2^32 +
//     977 (FOLD): lo + hi * 977 + hi * 2^32 in one pass (8
//     multiply-adds), the word above 2^256 folded the same way again (2),
//     and a last carry bit once more.
//   - add and sub fold a carry (borrow) out of 2^256 as +FOLD (-FOLD),
//     twice: the second fold meets a value below 2^65 (above 2^256 -
//     2^65), in its low three words, where it cannot carry (borrow) again.
//     No branches: a branch per operation costs more than the words it
//     skips.
// Every operation is __forceinline__ but mul and sqr, which the point
// operations call out of line (mul_inl and sqr_inl are their bodies, for
// chains that are a kernel's time); operands stay in registers either way
// (ptxas: no stack frame, no spill).
//
// The JAX layout at the kernels' edges (the tables' and keys' tensors):
// from_limbs reads 22 signed radix-2^12 limbs (sum v_i 2^(12 i), weak or
// negative, as the plain versions emit them) by one sequential signed
// carry, then folds what lies at and above 2^256 (a signed multiple e of
// 2^256) as +-|e| FOLD; to_limbs writes the frozen value's 22 canonical
// 12-bit digits.
//
// Point formulas and the order of their field operations are the plain
// version's (ops/secp256k1.py: add-2007-bl, madd-2007-bl; the doubling,
// dbl-2009-l, runs on thread quads in secp256k1_kernels.cu), so every
// coordinate equals the plain version's as a field element; only the
// limbs differ.
//
// The header also compiles as host C++ (the __device__ qualifiers
// defined away), so that its arithmetic can be checked without a card.

#pragma once

#include <cstdint>

namespace fesecpn {

constexpr int NW = 8;                 // 32-bit words
constexpr int NL = 22;                // JAX layout: radix-2^12 limbs
constexpr uint32_t FOLD_LO = 977;     // 2^256 mod p = FOLD_HI 2^32 + FOLD_LO
constexpr uint32_t FOLD_HI = 1;
// p's words, little-endian (a CPU test checks them against p)
constexpr uint32_t P_W0 = 0xFFFFFC2Fu, P_W1 = 0xFFFFFFFEu, P_WTOP = 0xFFFFFFFFu;

struct fe {
  uint32_t w[NW];
};

struct jpt {
  fe x, y, z;
};

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ fe fe_one() {
  fe r = fe_zero();
  r.w[0] = 1;
  return r;
}

// a + k FOLD (mod p) in [0, 2^256), k < 2^32, without branches: a carry
// out of 2^256 leaves a value below 2^65, which takes FOLD once more in
// its low three words
__device__ __forceinline__ fe add_fold(const fe& a, uint32_t k) {
  fe r;
  const uint64_t m = (uint64_t)k * FOLD_LO;
  uint64_t c = (uint64_t)a.w[0] + (uint32_t)m;
  r.w[0] = (uint32_t)c;
  c = (c >> 32) + a.w[1] + (m >> 32) + (uint64_t)k * FOLD_HI;
  r.w[1] = (uint32_t)c;
#pragma unroll
  for (int i = 2; i < NW; ++i) {
    c = (c >> 32) + a.w[i];
    r.w[i] = (uint32_t)c;
  }
  const uint32_t k2 = (uint32_t)(c >> 32);
  c = (uint64_t)r.w[0] + k2 * FOLD_LO;
  r.w[0] = (uint32_t)c;
  c = (c >> 32) + r.w[1] + k2 * FOLD_HI;
  r.w[1] = (uint32_t)c;
  r.w[2] += (uint32_t)(c >> 32);
  return r;
}

// a - k FOLD (mod p) in [0, 2^256), k < 2^32, without branches (signed
// carries, arithmetic shifts): a borrow out of 2^256 leaves a value above
// 2^256 - 2^65, which gives FOLD once more from its low three words
__device__ __forceinline__ fe sub_fold(const fe& a, uint32_t k) {
  fe r;
  const uint64_t m = (uint64_t)k * FOLD_LO;
  int64_t d = (int64_t)a.w[0] - (int64_t)(uint32_t)m;
  r.w[0] = (uint32_t)d;
  d = (d >> 32) + a.w[1] - (int64_t)(m >> 32) - (int64_t)k * FOLD_HI;
  r.w[1] = (uint32_t)d;
#pragma unroll
  for (int i = 2; i < NW; ++i) {
    d = (d >> 32) + a.w[i];
    r.w[i] = (uint32_t)d;
  }
  const uint32_t k2 = (uint32_t)(-(d >> 32));
  d = (int64_t)r.w[0] - (int64_t)(k2 * FOLD_LO);
  r.w[0] = (uint32_t)d;
  d = (d >> 32) + r.w[1] - (int64_t)(k2 * FOLD_HI);
  r.w[1] = (uint32_t)d;
  r.w[2] += (uint32_t)(d >> 32);
  return r;
}

__device__ __forceinline__ fe add(const fe& a, const fe& b) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return add_fold(r, (uint32_t)c);
}

__device__ __forceinline__ fe sub(const fe& a, const fe& b) {
  fe r;
  int64_t d = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    d = (d >> 32) + a.w[i] - b.w[i];
    r.w[i] = (uint32_t)d;
  }
  return sub_fold(r, (uint32_t)(-(d >> 32)));
}

__device__ __forceinline__ fe neg(const fe& a) { return sub(fe_zero(), a); }

// a 512-bit product t[16] -> [0, 2^256)
__device__ __forceinline__ fe reduce_wide(const uint32_t (&t)[2 * NW]) {
  // lo + hi * FOLD = lo + hi * 977 + hi * 2^32, one pass over words 0..8
  uint32_t u[NW + 1];
  uint64_t c = (uint64_t)t[NW] * FOLD_LO + t[0];
  u[0] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    c += (uint64_t)t[NW + i] * FOLD_LO + t[i] + t[NW + i - 1];
    u[i] = (uint32_t)c;
    c >>= 32;
  }
  c += t[2 * NW - 1];
  u[NW] = (uint32_t)c;
  const uint32_t u9 = (uint32_t)(c >> 32);        // 0 or 1
  // the part at and above 2^256, h = u[8] + u9 2^32 < 2^33, times FOLD
  const uint64_t hm = (uint64_t)u[NW] * FOLD_LO;
  fe r;
  c = (uint64_t)u[0] + (uint32_t)hm;
  r.w[0] = (uint32_t)c;
  c = (c >> 32) + u[1] + (hm >> 32) + (uint64_t)u9 * FOLD_LO +
      (uint64_t)u[NW] * FOLD_HI;
  r.w[1] = (uint32_t)c;
  c = (c >> 32) + u[2] + (uint64_t)u9 * FOLD_HI;
  r.w[2] = (uint32_t)c;
#pragma unroll
  for (int i = 3; i < NW; ++i) {
    c = (c >> 32) + u[i];
    r.w[i] = (uint32_t)c;
  }
  return add_fold(r, (uint32_t)(c >> 32));
}

__device__ __forceinline__ fe mul_inl(const fe& a, const fe& b) {
  // product scanning: column k gathers the low halves of a_i b_j, i + j = k,
  // and the high halves of those with i + j = k - 1 (each below 2^36)
  uint64_t col[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) col[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t p = (uint64_t)a.w[i] * b.w[j];
      col[i + j] += (uint32_t)p;
      col[i + j + 1] += p >> 32;
    }
  }
  uint32_t t[2 * NW];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) {
    c += col[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_wide(t);
}

__device__ __forceinline__ fe sqr_inl(const fe& a) {
  uint64_t col[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) col[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int j = i; j < NW; ++j) {
      const uint64_t p = (uint64_t)a.w[i] * a.w[j];
      const uint32_t f = i == j ? 1u : 2u;
      col[i + j] += (uint64_t)(uint32_t)p * f;
      col[i + j + 1] += (p >> 32) * f;
    }
  }
  uint32_t t[2 * NW];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) {
    c += col[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_wide(t);
}

// The point operations call the products out of line: one copy of each
// in the kernel's code, which stays in the instruction cache, where
// inlined point operations (thousands of instructions each) miss it.  The
// operands pass by value in registers (ptxas: no stack frame).
__device__ __noinline__ fe mul(const fe a, const fe b) { return mul_inl(a, b); }

__device__ __noinline__ fe sqr(const fe a) { return sqr_inl(a); }

// ---------------------------------------------------------------- freeze

// [0, 2^256) -> [0, p): a value at or above p shares p's six top words,
// and differs from it in the low two
__device__ __forceinline__ fe freeze(const fe& a) {
  bool top = true;
#pragma unroll
  for (int i = 2; i < NW; ++i) top = top && a.w[i] == P_WTOP;
  const bool ge =
      top && (a.w[1] > P_W1 || (a.w[1] == P_W1 && a.w[0] >= P_W0));
  if (!ge) return a;
  fe r = fe_zero();
  r.w[0] = a.w[0] - P_W0;
  r.w[1] = a.w[1] - P_W1 - (a.w[0] < P_W0 ? 1u : 0u);
  return r;
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  const fe f = freeze(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= f.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const fe& a, const fe& b) {
  return is_zero(sub(a, b));
}

// K13's verdict without an inverse: x(X : Y : Z) == r or, where rn_valid,
// rn = r + n, given rz2 = r Z^2 and rnz2 = rn Z^2.  With Z != 0, X / Z^2
// == r exactly when X == r Z^2.  With Z == 0 off infinity (an off-curve
// input) the plain version's Fermat inverse of Z^2 is 0, so its affine x
// is 0 and it accepts where r == 0 or rn == 0 (valid): decided so here,
// where X == r Z^2 would accept any X == 0.
__device__ __forceinline__ bool ladder_verdict(const fe& x, const fe& z,
                                               const fe& r, const fe& rn,
                                               const fe& rz2, const fe& rnz2,
                                               bool rn_valid, bool inf) {
  if (inf) return false;
  if (is_zero(z)) return is_zero(r) || (rn_valid && is_zero(rn));
  return eq(x, rz2) || (rn_valid && eq(x, rnz2));
}

// ---------------------------------------------------------------- JAX layout

// 22 signed radix-2^12 limbs at p[0], p[stride], ... -> [0, 2^256)
__device__ __forceinline__ fe from_limbs(const int32_t* p, int64_t stride) {
  uint32_t w[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i) w[i] = 0;
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t s = p[i * stride] + c;
    const uint32_t d = (uint32_t)s & 4095u;
    c = s >> 12;                        // arithmetic: floor
    const int bit = 12 * i;
    w[bit >> 5] |= d << (bit & 31);
    if ((bit & 31) > 20) w[(bit >> 5) + 1] |= d >> (32 - (bit & 31));
  }
  // value = w[0..7] + e 2^256, e = w[8] + c 2^8 (signed)
  const int32_t e = (int32_t)w[NW] + c * 256;
  fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = w[i];
  return e >= 0 ? add_fold(r, (uint32_t)e) : sub_fold(r, (uint32_t)(-e));
}

// the frozen value's 22 canonical radix-2^12 digits at p[0], p[stride], ...
__device__ __forceinline__ void to_limbs(int32_t* p, int64_t stride,
                                         const fe& a) {
  const fe f = freeze(a);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = 12 * i;
    uint32_t d = f.w[bit >> 5] >> (bit & 31);
    if ((bit & 31) > 20 && (bit >> 5) + 1 < NW)
      d |= f.w[(bit >> 5) + 1] << (32 - (bit & 31));
    p[i * stride] = (int32_t)(d & 4095u);
  }
}

// ---------------------------------------------------------------- points

// add-2007-bl; undefined for p == +-q or infinities
__device__ __forceinline__ jpt jadd_fast(const jpt& p, const jpt& q) {
  const fe z1z1 = sqr(p.z);
  const fe z2z2 = sqr(q.z);
  const fe u1 = mul(p.x, z2z2);
  const fe u2 = mul(q.x, z1z1);
  const fe s1 = mul(mul(p.y, q.z), z2z2);
  const fe s2 = mul(mul(q.y, p.z), z1z1);
  const fe h = sub(u2, u1);
  const fe rr = sub(s2, s1);
  const fe h2 = sqr(h);
  const fe h3 = mul(h, h2);
  const fe v = mul(u1, h2);
  jpt r;
  r.x = sub(sub(sqr(rr), h3), add(v, v));
  r.y = sub(mul(rr, sub(v, r.x)), mul(s1, h3));
  r.z = mul(mul(p.z, q.z), h);
  return r;
}

// madd-2007-bl (Z2 = 1): p + affine (ax, ay); incomplete
__device__ __forceinline__ jpt jadd_mixed(const jpt& p, const fe& ax,
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

}  // namespace fesecpn
