// GF(p), p = 2^255 - 19, in the card's native radix, one element per
// thread: the field of K14 (ed25519_persig.cu).  K1-K7 keep the JAX
// package's 20 x 13-bit layout (fe25519.cuh).
//
// Representation: eight 32-bit words, radix 2^32, little-endian, any
// value in [0, 2^256); an element is frozen to [0, p) only where it is
// compared (is_zero, eq) or stored (to_limbs).
//   - A product is an 8 x 8 schoolbook of 32 x 32 -> 64-bit products
//     (IMAD.WIDE.U32: 64, a square 36), scanned by columns: column k sums
//     the low halves of the products a_i b_j with i + j = k and the high
//     halves of those with i + j = k - 1 in 64 bits (below 2^37), so the
//     columns are independent chains and one carry pass ends them.  Then
//     the fold of the high half through 2^256 == 38 (FOLD): lo + 38 hi in
//     one pass (8 multiply-adds), the word above 2^256 folded the same way
//     again, and a last carry bit once more.
//   - add and sub fold a carry (borrow) out of 2^256 as +38 (-38), twice:
//     the second fold meets a value below 2^38 (above 2^256 - 2^38), in
//     its low two words, where it cannot carry (borrow) again.  No
//     branches.
//
// The JAX layout at the kernel's edges (K1's points, the B table, the
// accumulators K14 returns): from_limbs reads 20 signed radix-2^13 limbs
// (sum v_i 2^(13 i), weak or negative, as fe25519.cuh and ops/fe.py emit
// them) by one sequential signed carry, then folds what lies at and above
// 2^256 (a signed multiple e of 2^256) as +-38 |e|; to_limbs writes the
// frozen value's 20 canonical 13-bit digits.
//
// The header also compiles as host C++ (the __device__ qualifiers
// defined away), so that its arithmetic can be checked without a card.

#pragma once

#include <cstdint>

namespace fe25519n {

constexpr int NW = 8;                  // 32-bit words
constexpr int NL = 20;                 // JAX layout: radix-2^13 limbs
constexpr int RADIX = 13;
constexpr uint32_t FOLD = 38;          // 2^256 mod p
// p's words, little-endian (a CPU test checks every constant here)
constexpr uint32_t P_W0 = 0xFFFFFFEDu, P_WMID = 0xFFFFFFFFu, P_W7 = 0x7FFFFFFFu;
// d = -121665 / 121666 (the curve's, for the record) and 2d (the cached
// form's), little-endian words
constexpr uint32_t D_W0 = 0x135978A3u, D_W1 = 0x75EB4DCAu, D_W2 = 0x4141D8ABu,
                   D_W3 = 0x00700A4Du, D_W4 = 0x7779E898u, D_W5 = 0x8CC74079u,
                   D_W6 = 0x2B6FFE73u, D_W7 = 0x52036CEEu;
constexpr uint32_t D2_W0 = 0x26B2F159u, D2_W1 = 0xEBD69B94u, D2_W2 = 0x8283B156u,
                   D2_W3 = 0x00E0149Au, D2_W4 = 0xEEF3D130u, D2_W5 = 0x198E80F2u,
                   D2_W6 = 0x56DFFCE7u, D2_W7 = 0x2406D9DCu;

struct fe {
  uint32_t w[NW];
};

__device__ __forceinline__ fe fe_words(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                       uint32_t w4, uint32_t w5, uint32_t w6, uint32_t w7) {
  fe r;
  r.w[0] = w0;
  r.w[1] = w1;
  r.w[2] = w2;
  r.w[3] = w3;
  r.w[4] = w4;
  r.w[5] = w5;
  r.w[6] = w6;
  r.w[7] = w7;
  return r;
}

__device__ __forceinline__ fe fe_small(uint32_t v) { return fe_words(v, 0, 0, 0, 0, 0, 0, 0); }

__device__ __forceinline__ fe fe_d2() {
  return fe_words(D2_W0, D2_W1, D2_W2, D2_W3, D2_W4, D2_W5, D2_W6, D2_W7);
}

// a + 38 k (mod p) in [0, 2^256), k < 2^32, without branches: a carry out
// of 2^256 leaves a value below 38 k < 2^38, which takes 38 once more in
// its low two words
__device__ __forceinline__ fe add_fold(const fe& a, uint32_t k) {
  fe r;
  uint64_t c = (uint64_t)k * FOLD + a.w[0];
  r.w[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    c = (c >> 32) + a.w[i];
    r.w[i] = (uint32_t)c;
  }
  const uint32_t k2 = (uint32_t)(c >> 32);       // 0 or 1
  c = (uint64_t)r.w[0] + k2 * FOLD;
  r.w[0] = (uint32_t)c;
  r.w[1] += (uint32_t)(c >> 32);
  return r;
}

// a - 38 k (mod p) in [0, 2^256), k < 2^32, without branches (signed
// carries, arithmetic shifts): a borrow out of 2^256 leaves a value above
// 2^256 - 2^38, which gives 38 once more from its low two words
__device__ __forceinline__ fe sub_fold(const fe& a, uint32_t k) {
  fe r;
  int64_t d = (int64_t)a.w[0] - (int64_t)((uint64_t)k * FOLD);
  r.w[0] = (uint32_t)d;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    d = (d >> 32) + a.w[i];
    r.w[i] = (uint32_t)d;
  }
  const uint32_t k2 = (uint32_t)(-(d >> 32));    // 0 or 1
  d = (int64_t)r.w[0] - (int64_t)(k2 * FOLD);
  r.w[0] = (uint32_t)d;
  r.w[1] += (uint32_t)(d >> 32);
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

__device__ __forceinline__ fe neg(const fe& a) { return sub(fe_small(0), a); }

// lo + 38 hi for a 512-bit value t[16] = lo + 2^256 hi -> [0, 2^256)
__device__ __forceinline__ fe reduce_wide(const uint32_t (&t)[2 * NW]) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)t[NW + i] * FOLD + t[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return add_fold(r, (uint32_t)c);              // c < 39
}

// column sums col[0 .. 2 NW) -> the words t, one carry pass
__device__ __forceinline__ void carry_columns(const uint64_t (&col)[2 * NW],
                                              uint32_t (&t)[2 * NW]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) {
    c += col[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
}

__device__ __forceinline__ fe mul(const fe& a, const fe& b) {
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
  carry_columns(col, t);
  return reduce_wide(t);
}

__device__ __forceinline__ fe sqr(const fe& a) {
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
  carry_columns(col, t);
  return reduce_wide(t);
}

// ---------------------------------------------------------------- freeze

// [0, 2^256) -> [0, p): bit 255 folds as 19, leaving x < 2^255 + 19; then
// x >= p exactly when x + 19 has bit 255 set, and x + 19 - 2^255 is x - p
__device__ __forceinline__ fe freeze(const fe& a) {
  const uint32_t top = a.w[NW - 1] >> 31;
  fe x;
  uint64_t c = (uint64_t)a.w[0] + 19u * top;
  x.w[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    c = (c >> 32) + (i == NW - 1 ? (a.w[i] & P_W7) : a.w[i]);
    x.w[i] = (uint32_t)c;
  }
  fe y;
  c = (uint64_t)x.w[0] + 19u;
  y.w[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    c = (c >> 32) + x.w[i];
    y.w[i] = (uint32_t)c;
  }
  const bool ge = (y.w[NW - 1] >> 31) != 0;
  y.w[NW - 1] &= P_W7;
  fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = ge ? y.w[i] : x.w[i];
  return r;
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  const fe f = freeze(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= f.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const fe& a, const fe& b) { return is_zero(sub(a, b)); }

// ---------------------------------------------------------------- JAX layout

// 20 signed radix-2^13 limbs at p[0], p[stride], ... -> [0, 2^256)
__device__ __forceinline__ fe from_limbs(const int32_t* p, int64_t stride) {
  uint32_t w[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i) w[i] = 0;
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t s = p[i * stride] + c;
    const uint32_t d = (uint32_t)s & 8191u;
    c = s >> RADIX;                      // arithmetic: floor
    const int bit = RADIX * i;
    w[bit >> 5] |= d << (bit & 31);
    if ((bit & 31) > 32 - RADIX) w[(bit >> 5) + 1] |= d >> (32 - (bit & 31));
  }
  // value = w[0..7] + e 2^256, e = w[8] + c 2^4 (signed): digit 19 ends
  // at bit 260
  const int32_t e = (int32_t)w[NW] + c * 16;
  fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = w[i];
  return e >= 0 ? add_fold(r, (uint32_t)e) : sub_fold(r, (uint32_t)(-e));
}

// the frozen value's 20 canonical radix-2^13 digits at p[0], p[stride], ...
__device__ __forceinline__ void to_limbs(int32_t* p, int64_t stride, const fe& a) {
  const fe f = freeze(a);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = RADIX * i;
    uint32_t d = f.w[bit >> 5] >> (bit & 31);
    if ((bit & 31) > 32 - RADIX && (bit >> 5) + 1 < NW)
      d |= f.w[(bit >> 5) + 1] << (32 - (bit & 31));
    p[i * stride] = (int32_t)(d & 8191u);
  }
}

}  // namespace fe25519n
