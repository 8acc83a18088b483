// One field product split across a thread quad, for the port's K1
// (ed25519_kernels.cu decompress_kernel).
//
// A lane's square-root chain is ~265 field products in series, with no
// independent products to share out as fe25519_quad.cuh does for point
// operations; here each product is itself cut into G = 4 parts.  The
// four threads of a quad (threads 4m .. 4m + 3 of a warp; rank
// r = lane & 3) each hold the operands replicated, and rank r owns the
// R = 5 limbs 5r .. 5r + 4 of every product's result:
//   1. rows: rank r multiplies its own R limbs of a (rows R r + s) by all
//      20 limbs of b: 20 R multiply-adds into NP = R + 19 partial
//      columns p[n], column R r + n;
//   2. reduce-scatter: the 39 columns fall in 2G blocks of R, block beta
//      owned by rank beta mod G (its "low" block beta < G, "high" block
//      beta >= G); p's block delta goes to block r + delta, to rank
//      (r + delta) mod G by one shuffle per column (none for delta = 0
//      and delta = G, the rank's own);
//   3. tail: fe25519.cuh's prod_tail on the owned columns, then out[k] =
//      a[k] + 608 a[k + 20] (both owned by rank r), then norm_weak's two
//      carry passes; the carries across block edges (two of prod_tail's,
//      one per pass) come by four shuffles sent together;
//   4. gather: 20 shuffles give every rank the whole result again.
// Each column is an exact integer sum whose partial sums stay below
// 2^31 (fe25519.cuh's bound), so any split of its terms gives the same
// int32, and the same carries in the same order give the same limbs:
// a split product equals fe25519.cuh's mul limb for limb.  A squaring
// is the product of a with itself (rows of a times a): 20 R multiply-adds
// per rank, without sqr's doubled cross terms, which do not split evenly.
// A pair (G = 2: R = 10, 200 multiply-adds per rank) measured slower than
// the quad at every main-path width on the H100.
//
// Every function shuffles with a full mask: all 32 threads of the warp
// call it together, and a quad whose result is not wanted computes it
// and drops it.

#pragma once

#include "fe25519.cuh"

namespace fe25519 {

struct split {
  static constexpr int G = 4;              // threads per lane
  static constexpr int R = NL / G;         // owned limbs per rank
  static constexpr int NP = R + NL - 1;    // partial columns per rank
  static constexpr unsigned FULL = 0xffffffffu;

  // a field element held by the group: x replicated on every rank, o the
  // rank's own limbs x[R r + t]
  struct elem {
    fe x;
    int32_t o[R];
  };

  __device__ static __forceinline__ int rank() { return threadIdx.x & (G - 1); }

  __device__ static __forceinline__ int32_t from(int32_t v, int src) {
    return __shfl_sync(FULL, v, src, G);
  }

  // the rank's own limbs of a replicated element
  __device__ static __forceinline__ elem own(const fe& x) {
    elem e;
    e.x = x;
    const int r = rank();
#pragma unroll
    for (int t = 0; t < R; ++t) {
      int32_t v = x.v[t];
#pragma unroll
      for (int s = 1; s < G; ++s) v = r == s ? x.v[R * s + t] : v;
      e.o[t] = v;
    }
    return e;
  }

  // one carry pass (fe25519.cuh carry) over the limbs owned by the
  // rank, with `in` the carry into its lowest limb
  __device__ static __forceinline__ void carry_in(int32_t (&x)[R], int32_t in) {
    int32_t y[R];
    y[0] = (x[0] & MASK) + in;
#pragma unroll
    for (int t = 1; t < R; ++t) y[t] = (x[t] & MASK) + (x[t - 1] >> RADIX);
#pragma unroll
    for (int t = 0; t < R; ++t) x[t] = y[t];
  }

  // rows x b, both given by the group: the weak-form product, as mul(a, b)
  __device__ static __forceinline__ elem mul(const int32_t (&rows)[R], const fe& b) {
    const int r = rank();
    int32_t p[NP];
#pragma unroll
    for (int n = 0; n < NP; ++n) p[n] = 0;
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int j = 0; j < NL; ++j) p[s + j] += rows[s] * b.v[j];
    }
    // columns R r + t (lo) and 20 + R r + t (hi)
    int32_t lo[R], hi[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      int32_t sum = 0, low = 0;
#pragma unroll
      for (int d = 1; d < G; ++d) {
        const int32_t v = from(p[R * d + t], (r - d) & (G - 1));
        sum += v;
        low += r >= d ? v : 0;
      }
      lo[t] = p[t] + low;
      hi[t] = (G * R + t < NP ? p[(G * R + t) % NP] : 0) + sum - low;
    }
    // prod_tail, a[k] = (c[k] & MASK) + (c[k - 1] >> 13) with c[-1] = 0,
    // out[k] = a[k] + 608 a[k + 20], then norm_weak's two carry passes.
    // The carries into rank r's block come from rank r - 1's top limbs,
    // which do not depend on that rank's own carry-ins (R >= 3), so all
    // four are computed first and shuffled at once.
    elem e;
#pragma unroll
    for (int t = 1; t < R; ++t)
      e.o[t] = (lo[t] & MASK) + (lo[t - 1] >> RADIX) +
               WRAP * ((hi[t] & MASK) + (hi[t - 1] >> RADIX));
    const int32_t top1 = (e.o[R - 1] & MASK) + (e.o[R - 2] >> RADIX);
    const int prev = (r - 1) & (G - 1);
    const int32_t lo_in = from(lo[R - 1] >> RADIX, prev);
    const int32_t hi_in = from(hi[R - 1] >> RADIX, prev);
    const int32_t in1 = from(e.o[R - 1] >> RADIX, prev);
    const int32_t in2 = from(top1 >> RADIX, prev);
    e.o[0] = (lo[0] & MASK) + (r == 0 ? 0 : lo_in) +
             WRAP * ((hi[0] & MASK) + (r == 0 ? lo_in : hi_in));
    carry_in(e.o, r == 0 ? in1 * WRAP : in1);
    carry_in(e.o, r == 0 ? in2 * WRAP : in2);
#pragma unroll
    for (int s = 0; s < G; ++s) {
#pragma unroll
      for (int t = 0; t < R; ++t) e.x.v[R * s + t] = from(e.o[t], s);
    }
    return e;
  }

  __device__ static __forceinline__ elem mul(const elem& a, const fe& b) {
    return mul(a.o, b);
  }

  __device__ static __forceinline__ elem sqr(const elem& a) { return mul(a.o, a.x); }

  __device__ static __noinline__ elem sq_n(elem x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = sqr(x);
    return x;
  }

  // z^((p-5)/8): fe25519.cuh pow_p58's chain, each product split
  __device__ static __noinline__ elem pow_p58(const elem& z) {
    const elem z2 = sqr(z);
    const elem z9 = mul(sq_n(z2, 2), z.x);
    const elem z11 = mul(z9, z2.x);
    const elem z2_5_0 = mul(sqr(z11), z9.x);
    const elem z2_10_0 = mul(sq_n(z2_5_0, 5), z2_5_0.x);
    const elem z2_20_0 = mul(sq_n(z2_10_0, 10), z2_10_0.x);
    const elem z2_40_0 = mul(sq_n(z2_20_0, 20), z2_20_0.x);
    const elem z2_50_0 = mul(sq_n(z2_40_0, 10), z2_10_0.x);
    const elem z2_100_0 = mul(sq_n(z2_50_0, 50), z2_50_0.x);
    const elem z2_200_0 = mul(sq_n(z2_100_0, 100), z2_100_0.x);
    const elem z2_250_0 = mul(sq_n(z2_200_0, 50), z2_50_0.x);
    return mul(sq_n(z2_250_0, 2), z.x);
  }
};

}  // namespace fe25519
