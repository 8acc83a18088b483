// Kernel K14, the per-signature ZIP-215 program of reject localization,
// with an extern "C" launcher for ctypes (ops/_build.py):
//   K14 ed25519_verify_ladder <- cometbft_tpu/ops/ed25519.py::verify_kernel
//       (:238), its body after decompression (:254-275)
//
// The JAX package runs it as one XLA program: a lax.scan of 64 4-bit
// Straus windows over a static B table and a per-signature table of -A.
// Here one launch runs it on fe25519_n.cuh, GF(2^255 - 19) in eight 32-bit
// words, a thread quad a signature, in the plain version's order
// (ops/cuda_persig.verify_ladder_plain):
//   1. the -A table: rows k (-A), k = 0..15, in cached form; row 1's
//      cached operand is the add of rows 2..15 (14 add_cached), and each
//      row is converted once (cached_operand);
//   2. 64 windows, MSB first: 3 doublings without T, one with T,
//      add_cached of the B row of s's nibble, then of the -A row of h's
//      nibble;
//   3. add_cached(to_cached(-R)), 3 cofactor doublings, the identity test
//      X == 0 and Y == Z, each on a frozen value;
//   4. the verdict ok_A & ok_R & identity.
// The same formulas (dbl-2008-hwcd, add-2008-hwcd-3) on the same operands
// in the same order, so every coordinate of every accumulator equals the
// plain version's as a field element; only the limbs differ (acc_out
// stores the frozen digits).
//
// Threads.  Four threads, a quad, hold one accumulator: thread q = lane & 3
// holds coordinate q, and a point operation runs as two rounds of four
// independent products, one a thread, the operands moving inside the quad
// by shuffles (as fe25519_quad.cuh does on the 13-bit field).  Eight
// threads a signature, each product split by rows of the schoolbook
// between two threads of a coordinate and joined by a shuffle and an add,
// lost to the quads at every width from 16 to 16,384 signatures on the
// H100 (the join's serial carry chain costs a round more than the 32
// multiply-adds it saves), so the quads run every width.
//
// Where the tables live: shared memory, in native words.  A cached row is
// 4 x 8 words (128 B): the B table (16 rows, 2 KB) is converted from the
// JAX layout once a block, and each signature's -A table (2 KB) is built
// by its own threads, coordinate q's 32 bytes of a row by thread q.  A
// 64-thread block holds 16 signatures (34 KB).  A row read is two
// 16-byte loads a thread; the two signatures of a
// quarter-warp read them in opposite order (by the parity of the
// signature in the block), so their 8 lanes meet 8 distinct bank groups.
//
// What bounds it: integer multiply-adds, 195,730 a signature on this
// field (2,001 products of 74 and 1,036 squarings of 46, the 8 x 8
// schoolbook and its fold), against 770 bytes in (two K1 points, their
// flags, s and h) and one out; the chain of ~820 product rounds in series
// is the latency floor at any width.
//
// Every shuffle uses a full mask, so the threads past the last signature
// run on lane N - 1's input, keep their own table rows, and store no
// verdict.  Lanes whose decompression failed hold a defined but
// arbitrary point (weak limbs): they run like any other and the ok flags
// mask them.  The launcher returns cudaGetLastError() of its launch; the
// Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519_n.cuh"

using namespace fe25519n;

// threads of a block, a quad a signature; ops/cuda_persig.py
// PERSIG_THREADS mirrors it
#define PERSIG_THREADS 64

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NWIN = 64;                 // 4-bit windows of a 256-bit scalar
constexpr int L1 = 20;                   // JAX layout: limbs of an element
constexpr int ROW4 = 8;                  // 16-byte words of a cached row
constexpr int SIGS = PERSIG_THREADS / 4;

__device__ __forceinline__ int quad_q() { return threadIdx.x & 3; }

// coordinate src of this thread's quad
__device__ __forceinline__ fe qshfl(const fe& x, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = __shfl_sync(FULL_MASK, x.w[i], src, 4);
  return r;
}

__device__ __forceinline__ fe fsel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// The cached coordinate (Y+X, Y-X, 2dT, 2Z) = 0..3 whose value thread q's
// round-1 product in qadd_cached takes: Y-X, Y+X, 2dT, 2Z.
__device__ __forceinline__ int operand_coord(int q) { return q < 2 ? q ^ 1 : q; }

// 2P as point_double(p, with_t).  Round 1: X^2, Y^2, 2 Z^2, (X + Y)^2 on
// threads 0-3; round 2: X = e f, Y = g h, Z = f g, T = e h.
__device__ __forceinline__ fe qdouble(const fe& x, bool with_t) {
  const int q = quad_q();
  const fe xs = qshfl(x, 0);
  const fe ys = qshfl(x, 1);
  fe r = sqr(fsel(q == 3, add(xs, ys), x));
  r = fsel(q == 2, add(r, r), r);
  const fe a = qshfl(r, 0);
  const fe b = qshfl(r, 1);
  const fe c = qshfl(r, 2);
  const fe s = qshfl(r, 3);
  const fe h = add(a, b);
  const fe e = sub(h, s);
  const fe g = sub(a, b);
  const fe f = add(c, g);
  const fe o1 = fsel(q == 0 || q == 3, e, fsel(q == 1, g, f));
  const fe o2 = fsel(q == 0, f, fsel(q == 2, g, h));
  const fe m = mul(o1, o2);
  return fsel(q == 3 && !with_t, fe_small(0), m);
}

// P + Q as add_cached(p, q), where thread q of the quad passes `cn`, the
// one coordinate of cached Q its round-1 product needs: Y-X on thread 0,
// Y+X on thread 1, 2d T on thread 2, 2 Z on thread 3.  Round 1:
// (Y-X)(Y-X)', (Y+X)(Y+X)', T (2dT)', Z (2Z)' = a, b, c, d on threads
// 0-3; round 2 X = e f, Y = g h, Z = f g, T = e h with e = b - a,
// f = d - c, g = d + c, h = b + a: each thread fetches the two products
// of each of its operands and forms only those two.
__device__ __forceinline__ fe qadd_cached(const fe& x, const fe& cn) {
  const int q = quad_q();
  const fe o = qshfl(x, q ^ 1);        // thread 0: Y, 1: X, 2: T, 3: Z
  const fe lin = fsel(q == 0, sub(o, x), add(o, x));   // Y - X, X + Y
  const fe r = mul(fsel(q < 2, lin, o), cn);
  const bool dc1 = q == 1 || q == 2;   // o1: e, g, f, e
  const bool dc2 = q == 0 || q == 2;   // o2: f, h, g, h
  const fe u1 = qshfl(r, dc1 ? 3 : 1), v1 = qshfl(r, dc1 ? 2 : 0);
  const fe u2 = qshfl(r, dc2 ? 3 : 1), v2 = qshfl(r, dc2 ? 2 : 0);
  const fe o1 = fsel(q == 1, add(u1, v1), sub(u1, v1));
  const fe o2 = fsel(q == 0, sub(u2, v2), add(u2, v2));
  return mul(o1, o2);
}

// The round-1 coordinate `cn` of to_cached(Q) for this thread, from Q held
// by the quad: Y-X, Y+X, 2d T (the round's one product, on thread 2), 2 Z.
__device__ __forceinline__ fe cached_operand(const fe& y) {
  const int q = quad_q();
  const fe yx = qshfl(y, 1 - (q & 1));      // thread 0: Y, 1: X
  const fe o = qshfl(y, q == 2 ? 3 : 2);    // thread 2: T, 3: Z
  const fe m = mul(o, fe_d2());
  const fe lin = fsel(q == 0, sub(yx, y), add(y, yx));
  return fsel(q < 2, lin, fsel(q == 2, m, add(o, o)));
}

// thread q's coordinate of a cached row: two 16-byte words, words 0-3 at
// row[2q] and 4-7 at row[2q + 1], which odd signatures of a block (par =
// 1) read or write in the opposite order
__device__ __forceinline__ fe load_row(const uint4* row, int q, int par) {
  const uint4 u = row[2 * q + par], v = row[2 * q + (par ^ 1)];
  const uint4 lo = par ? v : u, hi = par ? u : v;
  return fe_words(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w);
}

__device__ __forceinline__ void store_row(uint4* row, int q, int par, const fe& x) {
  const uint4 lo = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
  const uint4 hi = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
  row[2 * q + par] = par ? hi : lo;
  row[2 * q + (par ^ 1)] = par ? lo : hi;
}

// nibble w (LSB first) of a (16, n) radix-2^16 scalar at lane i
__device__ __forceinline__ int nibble(const int32_t* __restrict__ limbs, int64_t n, int64_t i,
                                      int w) {
  return (limbs[(int64_t)(w >> 2) * n + i] >> (4 * (w & 3))) & 15;
}

// coordinate c of a (4, 20, w) JAX-layout point at lane i
__device__ __forceinline__ fe load_point(const int32_t* __restrict__ pts, int64_t w, int64_t i,
                                         int c) {
  return from_limbs(pts + (int64_t)c * L1 * w + i, w);
}

// pts: (4, 20, 2n) K1 output, A at lanes [0, n), R at [n, 2n); oks: (2n,);
// s_limbs, h_limbs: (16, n); btab: (16, 4, 20) cached B rows; out: (n,)
// verdicts; acc_out: (4, 20, n) frozen accumulators before the identity
// test, or null.
__global__ void __launch_bounds__(PERSIG_THREADS)
verify_ladder_kernel(const int32_t* __restrict__ pts, const uint8_t* __restrict__ oks,
                     const int32_t* __restrict__ s_limbs, const int32_t* __restrict__ h_limbs,
                     const int32_t* __restrict__ btab, int64_t n, uint8_t* __restrict__ out,
                     int32_t* __restrict__ acc_out) {
  __shared__ uint4 bs[16 * ROW4];
  __shared__ uint4 tabs[SIGS * 16 * ROW4];
  const int q = quad_q();
  const int local = threadIdx.x / 4;                  // signature in the block
  const int par = local & 1;
  const int64_t slot = (int64_t)blockIdx.x * SIGS + local;
  const bool live = slot < n;
  const int64_t i = live ? slot : n - 1;
  const int64_t w2 = 2 * n;
  // the B table: element (row, c) of the JAX layout to row `row`, the
  // operand slot of coordinate c, in native words
  for (int t = threadIdx.x; t < 16 * 4; t += PERSIG_THREADS) {
    const int row = t >> 2, c = t & 3;
    store_row(bs + row * ROW4, operand_coord(c), 0, from_limbs(btab + t * L1, 1));
  }

  // 1. the -A table: row 0 is to_cached(identity) = (1, 1, 0, 2)
  uint4* tab = tabs + local * 16 * ROW4;
  fe a = load_point(pts, w2, i, q);
  a = fsel(q == 0 || q == 3, neg(a), a);
  const fe cn_a = cached_operand(a);
  store_row(tab, q, par, fe_small(q == 2 ? 0 : (q == 3 ? 2 : 1)));
  store_row(tab + ROW4, q, par, cn_a);
  fe cur = a;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    cur = qadd_cached(cur, cn_a);
    store_row(tab + k * ROW4, q, par, cached_operand(cur));
  }
  __syncthreads();

  // 2. the windows, MSB first; the next window's nibbles load ahead
  fe acc = fe_small(q == 1 || q == 2 ? 1 : 0);
  int sn = nibble(s_limbs, n, i, NWIN - 1), hn = nibble(h_limbs, n, i, NWIN - 1);
#pragma unroll 1
  for (int w = NWIN - 1; w >= 0; --w) {
    const int wn = w > 0 ? w - 1 : 0;
    const int sn_next = nibble(s_limbs, n, i, wn), hn_next = nibble(h_limbs, n, i, wn);
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = qdouble(acc, d == 3);
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      const fe cn = s == 0 ? load_row(bs + sn * ROW4, q, par) : load_row(tab + hn * ROW4, q, par);
      acc = qadd_cached(acc, cn);
    }
    sn = sn_next;
    hn = hn_next;
  }

  // 3. -R, the cofactor, the identity test
  fe r = load_point(pts, w2, n + i, q);
  r = fsel(q == 0 || q == 3, neg(r), r);
  acc = qadd_cached(acc, cached_operand(r));
#pragma unroll 1
  for (int k = 0; k < 3; ++k) acc = qdouble(acc, false);
  if (acc_out != nullptr && live) to_limbs(acc_out + (int64_t)q * L1 * n + i, n, acc);
  const fe y = qshfl(acc, 1), z = qshfl(acc, 2);
  const bool zero = is_zero(fsel(q == 1, sub(y, z), acc));   // X on 0, Y - Z on 1
  const bool y_eq_z = __shfl_sync(FULL_MASK, (int)zero, 1, 4) != 0;

  // 4. the verdict
  if (live && q == 0) out[i] = (oks[i] && oks[n + i] && zero && y_eq_z) ? 1 : 0;
}

}  // namespace

extern "C" {

int ed25519_persig_threads(void) { return PERSIG_THREADS; }

// acc_out may be null
int ed25519_verify_ladder(const void* pts, const void* oks, const void* s_limbs,
                          const void* h_limbs, const void* btab, int64_t n, void* out,
                          void* acc_out, void* stream) {
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + SIGS - 1) / SIGS);
  verify_ladder_kernel<<<grid, PERSIG_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const uint8_t*)oks, (const int32_t*)s_limbs,
      (const int32_t*)h_limbs, (const int32_t*)btab, n, (uint8_t*)out, (int32_t*)acc_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
