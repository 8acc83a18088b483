// Kernel K14, the per-signature ZIP-215 program of reject localization,
// with an extern "C" launcher for ctypes (ops/_build.py):
//   K14 ed25519_verify_ladder <- cometbft_tpu/ops/ed25519.py::verify_kernel
//       (:238), its body after decompression (:254-275)
//
// The JAX package runs it as one XLA program: a lax.scan of 64 4-bit
// Straus windows over a static B table and a per-signature table of -A.
// Eager torch runs the same scan as ~10^5 small launches at 16,384
// signatures; here one launch runs it, a thread quad per signature
// (fe25519_quad.cuh), thread q holding coordinate q of the accumulator,
// in the plain version's order (ops/cuda_persig.verify_ladder_plain):
//   1. the -A table: rows k (-A), k = 0..15, in cached form; row 1's
//      cached operand is the add of rows 2..15 (14 qadd_cached), and each
//      row is converted once (q_cached_operand);
//   2. 64 windows, MSB first: 3 doublings without T, one with T,
//      add_cached of the B row of s's nibble, then of the -A row of h's
//      nibble;
//   3. add_cached(to_cached(-R)), 3 cofactor doublings, the identity test
//      X == 0 (thread 0) and Y == Z (thread 1), each on a frozen value;
//   4. the verdict ok_A & ok_R & identity.
// The same formulas on the same operands in the same order, so every
// accumulator equals the plain version's limb for limb.
//
// Where the tables live.  The B table (16 rows x 4 x 20 int32, 5,120 B)
// is copied into shared memory once a block: a per-lane __constant__
// read serializes when the lanes' nibbles differ.  A -A table is 5,120 B
// a signature: as a local array that is 1,280 B of stack a thread, and in
// shared memory it would bound a block to 8 signatures under the 48 KB
// static limit and an SM to ~44 signatures at 227 KB, about what the
// registers already allow.  So it lives in a global scratch the wrapper
// allocates, signature major: quad `slot` owns 16 rows of 320 contiguous
// bytes, thread q the 80 bytes of its coordinate in each row (stored as five
// 16-byte words).  Each thread reads only what it wrote, so no fence is
// needed.  A resident signature rereads its 5 KB 64 times, mostly from the
// L2; the whole traffic is ~0.34 GB at 16,384 signatures.
//
// What bounds it: integer multiply-adds, 1,017,960 a signature (2,001
// field products and 1,036 squarings), against 770 bytes in (two K1
// points, their flags, s and h) and one out; the chain of a quad is ~820
// product rounds in series, the latency floor at any width.
//
// Every function of fe25519_quad.cuh shuffles with a full mask, so quads
// past the last signature run on lane N - 1's input, keep their own
// scratch rows, and store no verdict.  Lanes whose decompression failed
// hold a defined but arbitrary point (weak limbs): they run like any
// other and the ok flags mask them.  The identity test's out-of-line
// freeze takes its operand by reference: that is the kernel's one stack
// slot (80 bytes, used once).  The launcher returns
// cudaGetLastError() of its launch; the Python wrapper raises when it is
// not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"
#include "fe25519_quad.cuh"

using namespace fe25519;

// threads of a block, a quad per signature; ops/cuda_persig.py
// PERSIG_THREADS mirrors it
#define PERSIG_THREADS 64

namespace {

constexpr int NWIN = 64;                 // 4-bit windows of a 256-bit scalar
constexpr int ROW = 4 * NL;              // words of a cached row
constexpr int BROW = ROW + 1;            // a B row in shared memory, padded
constexpr int SIGS = PERSIG_THREADS / 4;

// The cached coordinate (Y+X, Y-X, 2dT, 2Z) = 0..3 whose value thread q's
// round-1 product in qadd_cached takes: Y-X, Y+X, 2dT, 2Z.
__device__ __forceinline__ int operand_coord(int q) { return q < 2 ? q ^ 1 : q; }

__device__ __forceinline__ void store_row(int32_t* row, const fe& x) {
  int4* dst = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int k = 0; k < NL / 4; ++k)
    dst[k] = make_int4(x.v[4 * k], x.v[4 * k + 1], x.v[4 * k + 2], x.v[4 * k + 3]);
}

// nibble w (LSB first) of a (16, n) radix-2^16 scalar at lane i
__device__ __forceinline__ int nibble(const int32_t* __restrict__ limbs, int64_t n, int64_t i,
                                      int w) {
  return (limbs[(int64_t)(w >> 2) * n + i] >> (4 * (w & 3))) & 15;
}

// pts: (4, 20, 2n) K1 output, A at lanes [0, n), R at [n, 2n); oks: (2n,);
// s_limbs, h_limbs: (16, n); btab: (16, 4, 20) cached B rows; atab: the
// scratch, 16 rows of 80 words per quad of the grid; out: (n,) verdicts;
// acc_out: (4, 20, n) accumulators before the identity test, or null.
__global__ void __launch_bounds__(PERSIG_THREADS)
verify_ladder_kernel(const int32_t* __restrict__ pts, const uint8_t* __restrict__ oks,
                     const int32_t* __restrict__ s_limbs, const int32_t* __restrict__ h_limbs,
                     const int32_t* __restrict__ btab, int32_t* __restrict__ atab, int64_t n,
                     uint8_t* __restrict__ out, int32_t* __restrict__ acc_out) {
  __shared__ int32_t bs[16 * BROW];
  const int q = quad_q();
  const int64_t slot = ((int64_t)blockIdx.x * PERSIG_THREADS + threadIdx.x) >> 2;
  const bool live = slot < n;
  const int64_t i = live ? slot : n - 1;
  const int64_t w2 = 2 * n;
  for (int t = threadIdx.x; t < 16 * ROW; t += PERSIG_THREADS) {
    const int row = t / ROW, c = (t / NL) & 3, l = t % NL;
    bs[row * BROW + operand_coord(c) * NL + l] = btab[t];
  }

  // 1. the -A table: row 0 is to_cached(identity) = (1, 1, 0, 2)
  int32_t* tab = atab + slot * 16 * ROW + q * NL;
  fe a = load_fe(pts, w2, i, q);
  a = fsel(q == 0 || q == 3, neg(a), a);
  const fe cn_a = q_cached_operand(a);
  store_row(tab, fe_small(q == 2 ? 0 : (q == 3 ? 2 : 1)));
  store_row(tab + ROW, cn_a);
  fe cur = a;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    cur = qadd_cached(cur, cn_a);
    store_row(tab + k * ROW, q_cached_operand(cur));
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
      // the B row in shared memory, then the -A row in the scratch, through
      // one generic pointer: one call site of qadd_cached
      const int32_t* row = s == 0 ? bs + sn * BROW + q * NL : tab + hn * ROW;
      fe cn;
#pragma unroll
      for (int l = 0; l < NL; ++l) cn.v[l] = row[l];
      acc = qadd_cached(acc, cn);
    }
    sn = sn_next;
    hn = hn_next;
  }

  // 3. -R, the cofactor, the identity test
  fe r = load_fe(pts, w2, n + i, q);
  r = fsel(q == 0 || q == 3, neg(r), r);
  acc = qadd_cached(acc, q_cached_operand(r));
#pragma unroll 1
  for (int k = 0; k < 3; ++k) acc = qdouble(acc, false);
  if (acc_out != nullptr && live) store_fe(acc_out, n, i, q, acc);
  const fe y = qshfl(acc, 1), z = qshfl(acc, 2);
  const bool zero = is_zero(fsel(q == 1, sub(y, z), acc));   // X on 0, Y - Z on 1
  const bool y_eq_z = __shfl_sync(FULL_MASK, (int)zero, 1, 4) != 0;

  // 4. the verdict
  if (live && q == 0) out[i] = (oks[i] && oks[n + i] && zero && y_eq_z) ? 1 : 0;
}

}  // namespace

extern "C" {

int ed25519_persig_threads(void) { return PERSIG_THREADS; }

// scratch: (ceil(n / SIGS) * SIGS, 16, 4, 20) int32 (the wrapper sizes it
// from ed25519_persig_threads); acc_out may be null
int ed25519_verify_ladder(const void* pts, const void* oks, const void* s_limbs,
                          const void* h_limbs, const void* btab, void* scratch, int64_t n,
                          void* out, void* acc_out, void* stream) {
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + SIGS - 1) / SIGS);
  verify_ladder_kernel<<<grid, PERSIG_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const uint8_t*)oks, (const int32_t*)s_limbs,
      (const int32_t*)h_limbs, (const int32_t*)btab, (int32_t*)scratch, n, (uint8_t*)out,
      (int32_t*)acc_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
