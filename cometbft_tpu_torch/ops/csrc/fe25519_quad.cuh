// edwards25519 point operations on a thread quad, for the port's kernels
// K2-K7 (ed25519_kernels.cu, ed25519_engines.cu).
//
// The four threads 4m .. 4m+3 of a warp hold one point: thread q = lane & 3
// holds its coordinate q as one fe (X, Y, Z, T of an extended point).  A
// point operation (dbl-2008-hwcd, add-2008-hwcd-3: the plain versions'
// point_double and add_cached, ops/ed25519.py) runs two rounds of four
// independent field products; here each round computes its four products
// at once, one per thread, with fe25519.cuh's own mul / sqr / carry, and
// the operands move inside the quad with __shfl_sync.  Every linear step
// (add, sub, mul_word) is the sequential formula's own, on the same
// operands (add_signed forms add or sub per thread with the same limbs),
// so a quad's result equals point_double / add_cached limb for limb.  A point operation costs
// 2 products in series instead of 8, and a thread holds 20 limbs of the
// point instead of 80.
//
// Every function here shuffles with a full mask: all 32 threads of the warp
// call it together, and a quad whose result is not wanted computes it and
// drops it.

#pragma once

#include "fe25519.cuh"

namespace fe25519 {

constexpr unsigned FULL_MASK = 0xffffffffu;

// this thread's coordinate in its quad
__device__ __forceinline__ int quad_q() { return threadIdx.x & 3; }

// coordinate src of this thread's quad
__device__ __forceinline__ fe qshfl(const fe& x, int src) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = __shfl_sync(FULL_MASK, x.v[l], src, 4);
  return r;
}

// the same coordinate of the quad `quads` quads further along the warp
__device__ __forceinline__ fe qshfl_down(const fe& x, int quads) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = __shfl_down_sync(FULL_MASK, x.v[l], 4 * quads);
  return r;
}

__device__ __forceinline__ fe fsel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = c ? a.v[l] : b.v[l];
  return r;
}

// The second round shared by dbl-2008-hwcd and add-2008-hwcd-3:
// X = e f, Y = g h, Z = f g, T = e h, thread q computing coordinate q.
__device__ __forceinline__ void q_round2_operands(const fe& e, const fe& f, const fe& g,
                                                  const fe& h, fe& o1, fe& o2) {
  const int q = quad_q();
  o1 = fsel(q == 0 || q == 3, e, fsel(q == 1, g, f));
  o2 = fsel(q == 0, f, fsel(q == 2, g, h));
}

// 2P as point_double(p, with_t).  Round 1: X^2, Y^2, 2 Z^2, (X + Y)^2 on
// threads 0-3; round 2: e f, g h, f g, e h.  Without T, thread 3's round-2
// slot is free: with kSide it computes side = side_a * side_b there (an
// independent product of the caller's), and T is 0.
template <bool kSide>
__device__ __forceinline__ fe qdouble_impl(const fe& x, bool with_t, const fe& side_a,
                                           const fe& side_b, fe& side) {
  const int q = quad_q();
  const fe xs = qshfl(x, 0);
  const fe ys = qshfl(x, 1);
  fe r = sqr(fsel(q == 3, add(xs, ys), x));
  r = fsel(q == 2, mul_word(r, 2), r);
  const fe a = qshfl(r, 0);
  const fe b = qshfl(r, 1);
  const fe c = qshfl(r, 2);
  const fe s = qshfl(r, 3);
  const fe h = add(a, b);
  const fe e = sub(h, s);
  const fe g = sub(a, b);
  const fe f = add(c, g);
  fe o1, o2;
  q_round2_operands(e, f, g, h, o1, o2);
  if (kSide) {
    o1 = fsel(q == 3, side_a, o1);
    o2 = fsel(q == 3, side_b, o2);
  }
  const fe m = mul(o1, o2);
  side = m;
  return (q == 3 && !with_t) ? fe_small(0) : m;
}

__device__ __forceinline__ fe qdouble(const fe& x, bool with_t) {
  fe unused;
  return qdouble_impl<false>(x, with_t, x, x, unused);
}

// 2P without T, thread 3 also computing side = side_a * side_b
__device__ __forceinline__ fe qdouble_side(const fe& x, const fe& side_a, const fe& side_b,
                                           fe& side) {
  return qdouble_impl<true>(x, false, side_a, side_b, side);
}

// carry(p + s q) for s = 1 or -1: add(p, q) or sub(p, q), limb for limb,
// with the sign chosen per thread
__device__ __forceinline__ fe add_signed(const fe& p, const fe& q, int32_t s) {
  fe t;
#pragma unroll
  for (int l = 0; l < NL; ++l) t.v[l] = p.v[l] + s * q.v[l];
  return carry(t);
}

// P + Q as add_cached(p, q), where thread q of the quad passes `cn`, the
// one coordinate of cached Q its round-1 product needs: Y-X on thread 0,
// Y+X on thread 1, 2d T on thread 2, 2 Z on thread 3.  Round 1:
// (Y-X)(Y-X)', (Y+X)(Y+X)', T (2dT)', Z (2Z)' = a, b, c, d on threads
// 0-3; round 2 as point_double's, X = e f, Y = g h, Z = f g, T = e h with
// e = b - a, f = d - c, g = d + c, h = b + a: each thread fetches the two
// products of each of its operands and forms only those two.
__device__ __forceinline__ fe qadd_cached(const fe& x, const fe& cn) {
  const int q = quad_q();
  const fe o = qshfl(x, q ^ 1);        // thread 0: Y, 1: X, 2: T, 3: Z
  const fe lin = add_signed(o, x, q == 0 ? -1 : 1);   // Y - X, X + Y
  const fe r = mul(fsel(q < 2, lin, o), cn);
  const bool dc1 = q == 1 || q == 2;   // o1: e, g, f, e
  const bool dc2 = q == 0 || q == 2;   // o2: f, h, g, h
  const fe o1 = add_signed(qshfl(r, dc1 ? 3 : 1), qshfl(r, dc1 ? 2 : 0), q == 1 ? 1 : -1);
  const fe o2 = add_signed(qshfl(r, dc2 ? 3 : 1), qshfl(r, dc2 ? 2 : 0), q == 0 ? -1 : 1);
  return mul(o1, o2);
}

// The round-1 coordinate `cn` of to_cached(Q) for this thread, from Q held
// by the quad: Y-X, Y+X, 2d T (the round's one product, on thread 2), 2 Z.
__device__ __forceinline__ fe q_cached_operand(const fe& y) {
  const int q = quad_q();
  const fe yx = qshfl(y, 1 - (q & 1));  // thread 0: Y, 1: X (2, 3: unused)
  const fe o = qshfl(y, q == 2 ? 3 : 2);  // thread 2: T, 3: Z
  const fe m = mul(o, fe_const(D2_LIMBS));
  const fe lin = fsel(q == 0, sub(yx, y), add(y, yx));
  return fsel(q < 2, lin, fsel(q == 2, m, mul_word(o, 2)));
}

// P + Q as point_add(p, q) = add_cached(p, to_cached(q)), both held by the
// quad.
__device__ __forceinline__ fe qpoint_add(const fe& x, const fe& y) {
  return qadd_cached(x, q_cached_operand(y));
}

}  // namespace fe25519
