// The four Hopper kernels of the ed25519 RLC verify path, with extern "C"
// launchers for ctypes (ops/_build.py).  Each replaces one Pallas TPU
// kernel of the JAX package:
//   K1 ed25519_decompress   <- cometbft_tpu/ops/pallas_decompress.py::decompress
//   K2 ed25519_table17_neg  <- cometbft_tpu/ops/pallas_msm.py::table17_neg
//   K3 ed25519_msm_window_major <- cometbft_tpu/ops/pallas_msm.py::msm_window_major
//   K4 ed25519_fold_verify  <- cometbft_tpu/ops/pallas_msm.py::fold_verify
//
// What bounds them: all four are integer multiply-add chains on
// registers (a field product is 400 dependent-ish IMADs); they read each
// input word once and write each output word once, so the bytes are small
// next to the operations.  All keep the limbs-first (..., 20, W) layout,
// so a warp reads consecutive words per limb, and every intermediate in
// registers.  One thread per lane leaves most of the card idle at the
// main path's widths and runs each lane's chain at one warp's instruction
// rate, so: K2 and K3 split each point operation across a thread quad
// (fe25519_quad.cuh), one coordinate per thread; K1, whose chain is
// single field products in series, splits each product across a thread
// quad (fe25519_split.cuh); K3 also runs its window sums across
// the whole card; K4 runs one quad per fold slot.  Faster radix and
// tensor-core products are later work.
//
// Every launcher returns cudaGetLastError() of its launch (of each of its
// launches); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"
#include "fe25519_quad.cuh"
#include "fe25519_split.cuh"
#include "msm_quad.cuh"

using namespace fe25519;

// warps of a K3 window-sum block, 8 point-holding quads each;
// ops/cuda_msm.py MSM_WARPS mirrors it (CHAIN_THREADS: msm_quad.cuh)
#define MSM_WARPS 4
#define MSM_HOLDERS (8 * MSM_WARPS)
// slots of the K4 fold, one thread quad each, so the block has
// 4 * FOLD_SLOTS threads; ops/cuda_msm.py FOLD_THREADS mirrors it
#define FOLD_SLOTS 128
#define DECOMPRESS_THREADS 128
#define TABLE_THREADS 128

// ------------------------------------------------------------------ K1

// ZIP-215 decompression of one 32-byte encoding per thread quad: y from
// bits 0..254, u = y^2 - 1, v = d y^2 + 1, r = u v^3 (u v^7)^((p-5)/8),
// the sqrt(-1) fix-up, reject x = 0 with sign 1, sign fix, T = X Y.  Every field product of
// the chain is split across the quad (fe25519_split.cuh); the linear
// steps, freeze, eq and the sign fix run replicated on every thread of
// the quad.  r sqrt(-1) is computed on every lane and kept where the
// fix-up applies.  Thread r stores coordinate r of the point and thread
// 0 the ok flag.  Spare quads past W decode lane W - 1 and store
// nothing.
// words: (8, W) int32 bit patterns of LE uint32 words; pt: (4, 20, W);
// ok: (W,) int32.
__global__ void __launch_bounds__(DECOMPRESS_THREADS)
decompress_kernel(const int32_t* __restrict__ words, int64_t w,
                  int32_t* __restrict__ pt_out, int32_t* __restrict__ ok_out) {
  using S = split;
  using E = S::elem;
  const int64_t slot = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / S::G;
  const int64_t lane = slot < w ? slot : w - 1;
  const int rk = S::rank();
  uint32_t wd[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wd[j] = (uint32_t)words[j * w + lane];
  int32_t sign = (int32_t)(wd[7] >> 31);
  fe y;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int bit = RADIX * i;
    int j = bit / 32, r = bit % 32;
    uint32_t v = wd[j] >> r;
    if (r + RADIX > 32 && j + 1 < 8) v |= wd[j + 1] << (32 - r);
    y.v[i] = (int32_t)(v & (i < NL - 1 ? (uint32_t)MASK : 0xFFu));
  }
  const fe one = fe_small(1);
  const E y2 = S::sqr(S::own(y));
  const fe u = sub(y2.x, one);
  const fe v = add(S::mul(y2, fe_const(D_LIMBS)).x, one);
  const E ve = S::own(v);
  const E ue = S::own(u);

  const E v3 = S::mul(S::sqr(ve), v);
  const E v7 = S::mul(S::sqr(v3), v);
  const E r = S::mul(S::mul(ue, v3.x), S::pow_p58(S::mul(ue, v7.x)).x);
  const fe check = S::mul(ve, S::sqr(r).x).x;
  const bool correct = eq(check, u);
  const bool flipped = eq(check, neg(u));
  const fe rm = S::mul(r, fe_const(SQRT_M1_LIMBS)).x;
  fe x = flipped ? rm : r.x;
  bool ok = correct || flipped;

  fe xf = freeze(x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= xf.v[i];
  ok = ok && !(any == 0 && sign == 1);
  if ((xf.v[0] & 1) != sign) x = neg(x);
  const fe t = S::mul(S::own(x), y).x;
  if (slot < w) {
    store_fe(pt_out, w, lane, rk, fsel(rk == 0, x, fsel(rk == 1, y, fsel(rk == 2, one, t))));
    if (rk == 0) ok_out[lane] = ok ? 1 : 0;
  }
}

// ------------------------------------------------------------------ K2

// Rows k * (-P), k = 0..16, of one point per thread quad
// (fe25519_quad.cuh): thread q loads coordinate q and negates X and T,
// gets its coordinate of to_cached(-P) once, then runs the 15 cached adds
// in series, storing its coordinate of each row.  Spare quads past W
// build lane W - 1's table and store nothing.
// pt: (4, 20, W); tab: (17, 4, 20, W).
__global__ void __launch_bounds__(TABLE_THREADS)
table17_neg_kernel(const int32_t* __restrict__ pt_in, int64_t w,
                   int32_t* __restrict__ tab) {
  const int q = quad_q();
  const int64_t slot = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int64_t lane = slot < w ? slot : w - 1;
  const bool live = slot < w;
  const int64_t row = 4 * NL * w;
  fe x = load_fe(pt_in, w, lane, q);
  x = fsel(q == 0 || q == 3, neg(x), x);
  if (live) {
    store_fe(tab, w, lane, q, fe_small(q == 1 || q == 2 ? 1 : 0));
    store_fe(tab + row, w, lane, q, x);
  }
  const fe cn = q_cached_operand(x);
  fe cur = x;
#pragma unroll 1
  for (int k = 2; k < 17; ++k) {
    cur = qadd_cached(cur, cn);
    if (live) store_fe(tab + k * row, w, lane, q, cur);
  }
}

// ------------------------------------------------------------------ K3

// Straus MSM with signed 5-bit windows, MSB-first, in two launches.  The
// TPU kernel runs its grid in order and carries one accumulator: per
// window the blocks' sums, then the doublings once.  Here the lanes are
// cut into k chunks of MSM_HOLDERS * rows lanes, and:
//   1. msm_window_sums_kernel, one block per (window j, chunk c), all in
//      parallel across the card: S[j][c] = the chunk's selected, signed
//      rows summed, with no doubling in it;
//   2. msm_horner_kernel (msm_quad.cuh, shared with K5), one quad per
//      chunk: acc = S[0][c], then acc <- 32 acc + S[j][c] (4 doublings
//      without T, one with T, the add) for j = 1 .. nwin-1; acc is
//      partial c.
// The recurrence is linear, so the lane sum of the k partials is the MSM.
// The chain, (nwin - 1) Straus steps in series, is the latency floor of
// the method.  Every point operation runs on a thread quad
// (fe25519_quad.cuh).

// Window sums.  Holder h (quad h of the block) sums the lanes
// c * chunk + h + i * MSM_HOLDERS, i = 0 .. rows-1, in order: its first
// row, then one cached add per row.  Each add needs 2d T of its row, the
// one product of to_cached: a group of four rows computes theirs in one
// round (thread q for row q of the group) and hands each to thread 2 by
// shuffle, so an add costs 2.25 product rounds, not 3.  Then the block's
// holders are halved pairwise (quad t < s adds quad t + s): within each
// warp by shuffles (s = 4, 2, 1), then across the warps inside warp 0
// (s = MSM_WARPS/2 .. 1) — the plain version's two _block_tree calls.
// tab: (17, 4, 20, W); mags: (nwin, W) int32; negs: (nwin, W) uint8;
// sums: (nwin, 4, 20, k).
__global__ void __launch_bounds__(MSM_WARPS * 32)
msm_window_sums_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ mags,
                       const uint8_t* __restrict__ negs, int64_t w, int rows, int64_t k,
                       int32_t* __restrict__ sums) {
  __shared__ int32_t sm[MSM_WARPS][4 * NL];
  const int q = quad_q();
  const int holder = threadIdx.x >> 2;
  const int wq = holder & 7;                 // quad within its warp
  const int warp = threadIdx.x >> 5;
  const int64_t j = blockIdx.x / k;
  const int64_t c = blockIdx.x % k;
  const int32_t* mj = mags + j * w;
  const uint8_t* nj = negs + j * w;
  const int64_t base = c * rows * MSM_HOLDERS + holder;

  fe acc = load_signed(tab, mj, nj, w, base, q);
#pragma unroll 1
  for (int i0 = 1; i0 < rows; i0 += 4) {
    const int n = min(4, rows - i0);
    const int64_t lq = q < n ? base + (int64_t)(i0 + q) * MSM_HOLDERS : w;
    const fe t2d = mul(load_signed(tab, mj, nj, w, lq, 3), fe_const(D2_LIMBS));
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      const int64_t lane = base + (int64_t)(i0 + s) * MSM_HOLDERS;
      const fe u = load_signed(tab, mj, nj, w, lane, q == 3 ? 2 : 0);   // X, or Z
      const fe y = load_signed(tab, mj, nj, w, lane, 1);
      const fe d = qshfl(t2d, s);
      const fe cn = fsel(q == 0, sub(y, u),
                         fsel(q == 1, add(y, u), fsel(q == 2, d, mul_word(u, 2))));
      acc = qadd_cached(acc, cn);
    }
  }

#pragma unroll 1
  for (int s = 4; s >= 1; s >>= 1) {
    const fe r = qpoint_add(acc, qshfl_down(acc, s));
    acc = fsel(wq < s, r, acc);
  }
  if (wq == 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) sm[warp][q * NL + l] = acc.v[l];
  }
  __syncthreads();
  if (warp == 0) {
    const int src = wq < MSM_WARPS ? wq : 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) acc.v[l] = sm[src][q * NL + l];
#pragma unroll 1
    for (int s = MSM_WARPS / 2; s >= 1; s >>= 1) {
      const fe r = qpoint_add(acc, qshfl_down(acc, s));
      acc = fsel(wq < s, r, acc);
    }
    if (wq == 0) store_fe(sums + j * 4 * NL * k, k, c, q, acc);
  }
}

// ------------------------------------------------------------------ K4

// RLC epilogue in one block of FOLD_SLOTS thread quads, in the plain
// version's order (fold_verify_plain), every point operation on a quad
// (fe25519_quad.cuh), thread q holding coordinate q:
//   1. slot t starts at the identity and adds the concatenated partials
//      [A | R] t, t + FOLD_SLOTS, ... (strided sums in place of the TPU's
//      tile halving); every slot runs the same number of adds and keeps
//      a result only where its partial exists, so whole warps shuffle
//      (letting a warp with no partial left stop early made the kernel
//      spill at its 128-register cap);
//   2. a pairwise halving tree over the slots (slot t < s adds slot
//      t + s, in place of the pltpu.roll butterfly): s = 64 .. 8 across
//      warps through shared memory, whole warps adding, then s = 4, 2, 1
//      inside warp 0 by shuffles;
//   3. quad 0 runs the 3 cofactor doublings without T, then the frozen
//      identity test X == 0 and Y == Z.
// A point operation is 2-3 product rounds in series, about 30 rounds in
// all at one partial per slot.  Takes any widths.
// pa: (4, 20, na); pr: (4, 20, nr); out: (1,) int32 verdict.
__global__ void __launch_bounds__(4 * FOLD_SLOTS)
fold_verify_kernel(const int32_t* __restrict__ pa, int64_t na,
                   const int32_t* __restrict__ pr, int64_t nr,
                   int32_t* __restrict__ out) {
  // the upper half of the live slots at one tree level, [limb][4 slot + q]
  __shared__ int32_t sm[NL][2 * FOLD_SLOTS];
  const int q = quad_q();
  const int slot = threadIdx.x >> 2;
  const int64_t n = na + nr;
  fe acc = fe_small(q == 1 || q == 2 ? 1 : 0);       // the identity
#pragma unroll 1
  for (int64_t j0 = 0; j0 < n; j0 += FOLD_SLOTS) {
    const int64_t j = j0 + slot < n ? j0 + slot : n - 1;
    const fe p = j < na ? load_fe(pa, na, j, q) : load_fe(pr, nr, j - na, q);
    acc = fsel(j0 + slot < n, qpoint_add(acc, p), acc);
  }
#pragma unroll 1
  for (int s = FOLD_SLOTS / 2; s >= 8; s >>= 1) {    // whole warps
    if (slot >= s && slot < 2 * s) {
#pragma unroll
      for (int l = 0; l < NL; ++l) sm[l][threadIdx.x - 4 * s] = acc.v[l];
    }
    __syncthreads();
    fe other;
    if (slot < s) {
#pragma unroll
      for (int l = 0; l < NL; ++l) other.v[l] = sm[l][threadIdx.x];
    }
    __syncthreads();
    if (slot < s) acc = qpoint_add(acc, other);
  }
  if (threadIdx.x < 32) {
#pragma unroll 1
    for (int s = 4; s >= 1; s >>= 1) {
      const fe r = qpoint_add(acc, qshfl_down(acc, s));
      acc = fsel(slot < s, r, acc);
    }
#pragma unroll 1
    for (int k = 0; k < 3; ++k) acc = qdouble(acc, false);
    // X == 0 on thread 0 and Y == Z (Y - Z == 0) on thread 1, together
    const fe y = qshfl(acc, 1), z = qshfl(acc, 2);
    const bool zero = is_zero(q == 1 ? sub(y, z) : acc);
    const bool y_eq_z = __shfl_sync(FULL_MASK, zero, 1);
    if (threadIdx.x == 0) out[0] = (zero && y_eq_z) ? 1 : 0;
  }
}

// ----------------------------------------------------------- launchers

extern "C" {

int ed25519_decompress(const void* words, int64_t w, void* pt, void* ok, void* stream) {
  const int64_t per_block = DECOMPRESS_THREADS / split::G;
  int grid = (int)((w + per_block - 1) / per_block);
  decompress_kernel<<<grid, DECOMPRESS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, w, (int32_t*)pt, (int32_t*)ok);
  return (int)cudaGetLastError();
}

int ed25519_table17_neg(const void* pt, int64_t w, void* tab, void* stream) {
  const int64_t per_block = TABLE_THREADS / 4;
  int grid = (int)((w + per_block - 1) / per_block);
  table17_neg_kernel<<<grid, TABLE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pt, w, (int32_t*)tab);
  return (int)cudaGetLastError();
}

// sums: (nwin, 4, 20, k) scratch; k = ceil(W / (MSM_HOLDERS * rows)).
int ed25519_msm_window_major(const void* tab, const void* mags, const void* negs,
                             int64_t w, int nwin, int rows, int64_t k, void* sums,
                             void* out, void* stream) {
  msm_window_sums_kernel<<<(unsigned)(nwin * k), MSM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)mags, (const uint8_t*)negs, w, rows, k,
      (int32_t*)sums);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_msm_horner((const int32_t*)sums, nwin, k, (int32_t*)out,
                           (cudaStream_t)stream);
}

int ed25519_fold_verify(const void* pa, int64_t na, const void* pr, int64_t nr,
                        void* out, void* stream) {
  fold_verify_kernel<<<1, 4 * FOLD_SLOTS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pa, na, (const int32_t*)pr, nr, (int32_t*)out);
  return (int)cudaGetLastError();
}

int ed25519_msm_warps(void) { return MSM_WARPS; }
int ed25519_chain_threads(void) { return CHAIN_THREADS; }
int ed25519_fold_slots(void) { return FOLD_SLOTS; }

}  // extern "C"
