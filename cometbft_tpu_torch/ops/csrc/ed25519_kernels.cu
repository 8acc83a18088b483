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
// next to the operations.  The design keeps one lane per thread, the
// limbs-first (..., 20, W) layout so a warp reads 32 consecutive words per
// limb, and every intermediate in registers.  Faster radix and tensor-core
// products are later work.
//
// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"

using namespace fe25519;

// lanes per K3 block (one warp); ops/cuda_msm.py MSM_LANES mirrors it
#define MSM_LANES 32
// threads of the single K4 block; ops/cuda_msm.py FOLD_THREADS mirrors it
#define FOLD_THREADS 128
#define DECOMPRESS_THREADS 128
#define TABLE_THREADS 128

// ------------------------------------------------------------------ K1

// ZIP-215 decompression of one 32-byte encoding per thread: y from bits
// 0..254, u = y^2 - 1, v = d y^2 + 1, r = u v^3 (u v^7)^((p-5)/8), the
// sqrt(-1) fix-up, reject x = 0 with sign 1, sign fix, T = X Y.
// words: (8, W) int32 bit patterns of LE uint32 words; pt: (4, 20, W);
// ok: (W,) int32.
__global__ void __launch_bounds__(DECOMPRESS_THREADS)
decompress_kernel(const int32_t* __restrict__ words, int64_t w,
                  int32_t* __restrict__ pt_out, int32_t* __restrict__ ok_out) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= w) return;
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
  fe one = fe_small(1);
  fe y2 = sqr(y);
  fe u = sub(y2, one);
  fe v = add(mul(y2, fe_const(D_LIMBS)), one);

  fe v3 = mul(sqr(v), v);
  fe v7 = mul(sqr(v3), v);
  fe r = mul(mul(u, v3), pow_p58(mul(u, v7)));
  fe check = mul(v, sqr(r));
  bool correct = eq(check, u);
  bool flipped = eq(check, neg(u));
  fe x = flipped ? mul(r, fe_const(SQRT_M1_LIMBS)) : r;
  bool ok = correct || flipped;

  fe xf = freeze(x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= xf.v[i];
  ok = ok && !(any == 0 && sign == 1);
  if ((xf.v[0] & 1) != sign) x = neg(x);
  pt p;
  p.X = x;
  p.Y = y;
  p.Z = one;
  p.T = mul(x, y);
  store_point(pt_out, w, lane, p);
  ok_out[lane] = ok ? 1 : 0;
}

// ------------------------------------------------------------------ K2

// Rows k * (-P), k = 0..16, of one point per thread: identity, -P, then
// 15 cached adds.  pt: (4, 20, W); tab: (17, 4, 20, W).
__global__ void __launch_bounds__(TABLE_THREADS)
table17_neg_kernel(const int32_t* __restrict__ pt_in, int64_t w,
                   int32_t* __restrict__ tab) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= w) return;
  const int64_t row = 4 * NL * w;
  pt p = load_point(pt_in, w, lane);
  p.X = neg(p.X);
  p.T = neg(p.T);
  store_point(tab, w, lane, identity());
  store_point(tab + row, w, lane, p);
  pt pc = to_cached(p);
  pt cur = p;
#pragma unroll 1
  for (int k = 2; k < 17; ++k) {
    cur = add_cached(cur, pc);
    store_point(tab + k * row, w, lane, cur);
  }
}

// ------------------------------------------------------------------ K3

// Shared-memory copy of one point per thread, [coord*20 + limb][thread],
// so a warp's stores and loads hit 32 consecutive banks.
template <int N>
__device__ __forceinline__ void smem_store(int32_t (*sm)[N], int t, const pt& p) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    sm[l][t] = p.X.v[l];
    sm[NL + l][t] = p.Y.v[l];
    sm[2 * NL + l][t] = p.Z.v[l];
    sm[3 * NL + l][t] = p.T.v[l];
  }
}

template <int N>
__device__ __forceinline__ pt smem_load(int32_t (*sm)[N], int t) {
  pt p;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    p.X.v[l] = sm[l][t];
    p.Y.v[l] = sm[NL + l][t];
    p.Z.v[l] = sm[2 * NL + l][t];
    p.T.v[l] = sm[3 * NL + l][t];
  }
  return p;
}

// Pairwise halving tree over the block's points: at step s, thread
// t < s adds the point of thread t + s (the plain version's
// pts[..., :s] + pts[..., s:2s], in the same order).  Thread 0 returns
// the sum.
template <int N>
__device__ __forceinline__ pt block_tree(int32_t (*sm)[N], pt p) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int s = N / 2; s >= 1; s >>= 1) {
    if (t >= s && t < 2 * s) smem_store<N>(sm, t, p);
    __syncthreads();
    if (t < s) p = point_add(p, smem_load<N>(sm, t + s));
    __syncthreads();
  }
  return p;
}

// Straus MSM with signed 5-bit windows, MSB-first.  The TPU kernel runs
// its grid in order and carries one accumulator across grid steps; CUDA
// blocks run in no order, so each block owns MSM_LANES lanes and keeps
// its own accumulator over all windows (acc <- 32 acc + window sum is
// linear in the contributions, so the lane sum of the per-block
// accumulators is the MSM).  Per window: each thread reads only the row
// |d| of its lane from the table in global memory (the TPU selects with a
// 17-way cascade over the whole block), negates X and T if d < 0, the
// block tree-reduces to one point, and thread 0 runs 5 doublings and the
// add.  Lanes past W, and magnitudes outside 0..16, contribute the
// identity.
// tab: (17, 4, 20, W); mags: (nwin, W) int32; negs: (nwin, W) uint8;
// out: (4, 20, nblk) partials, nblk = ceil(W / MSM_LANES).
__global__ void __launch_bounds__(MSM_LANES)
msm_window_major_kernel(const int32_t* __restrict__ tab,
                        const int32_t* __restrict__ mags,
                        const uint8_t* __restrict__ negs, int64_t w, int nwin,
                        int32_t* __restrict__ out) {
  __shared__ int32_t sm[4 * NL][MSM_LANES];
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * MSM_LANES + t;
  pt acc = identity();
#pragma unroll 1
  for (int j = 0; j < nwin; ++j) {
    pt p = lane < w ? select_signed(tab, mags + (int64_t)j * w, negs + (int64_t)j * w, w, lane)
                    : identity();
    p = block_tree<MSM_LANES>(sm, p);
    if (t == 0) acc = j == 0 ? p : straus_step(acc, p);
  }
  if (t == 0) store_point(out, gridDim.x, blockIdx.x, acc);
}

// ------------------------------------------------------------------ K4

// RLC epilogue in one block: thread t sums lanes t, t + T, ... of the
// concatenated partials [A | R] (strided sums in place of the TPU's
// tile halving), the block tree-reduces (in place of the pltpu.roll
// butterfly), thread 0 runs the 3 cofactor doublings and the frozen
// identity test X == 0 and Y == Z.  Takes any widths.
// pa: (4, 20, na); pr: (4, 20, nr); out: (1,) int32 verdict.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_verify_kernel(const int32_t* __restrict__ pa, int64_t na,
                   const int32_t* __restrict__ pr, int64_t nr,
                   int32_t* __restrict__ out) {
  __shared__ int32_t sm[4 * NL][FOLD_THREADS];
  const int t = threadIdx.x;
  pt acc = identity();
#pragma unroll 1
  for (int64_t j = t; j < na + nr; j += FOLD_THREADS) {
    pt q = j < na ? load_point(pa, na, j) : load_point(pr, nr, j - na);
    acc = point_add(acc, q);
  }
  acc = block_tree<FOLD_THREADS>(sm, acc);
  if (t == 0) {
#pragma unroll 1
    for (int k = 0; k < 3; ++k) acc = point_double(acc, false);
    out[0] = (is_zero(acc.X) && eq(acc.Y, acc.Z)) ? 1 : 0;
  }
}

// ----------------------------------------------------------- launchers

extern "C" {

int ed25519_decompress(const void* words, int64_t w, void* pt, void* ok, void* stream) {
  int grid = (int)((w + DECOMPRESS_THREADS - 1) / DECOMPRESS_THREADS);
  decompress_kernel<<<grid, DECOMPRESS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, w, (int32_t*)pt, (int32_t*)ok);
  return (int)cudaGetLastError();
}

int ed25519_table17_neg(const void* pt, int64_t w, void* tab, void* stream) {
  int grid = (int)((w + TABLE_THREADS - 1) / TABLE_THREADS);
  table17_neg_kernel<<<grid, TABLE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pt, w, (int32_t*)tab);
  return (int)cudaGetLastError();
}

int ed25519_msm_window_major(const void* tab, const void* mags, const void* negs,
                             int64_t w, int nwin, void* out, void* stream) {
  int grid = (int)((w + MSM_LANES - 1) / MSM_LANES);
  msm_window_major_kernel<<<grid, MSM_LANES, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)mags, (const uint8_t*)negs, w, nwin,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int ed25519_fold_verify(const void* pa, int64_t na, const void* pr, int64_t nr,
                        void* out, void* stream) {
  fold_verify_kernel<<<1, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pa, na, (const int32_t*)pr, nr, (int32_t*)out);
  return (int)cudaGetLastError();
}

int ed25519_msm_lanes(void) { return MSM_LANES; }
int ed25519_fold_threads(void) { return FOLD_THREADS; }

}  // extern "C"
