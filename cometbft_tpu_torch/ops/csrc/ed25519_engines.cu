// The engine configurations of the ed25519 RLC MSM, as Hopper kernels with
// extern "C" launchers for ctypes (ops/_build.py).  Each replaces one
// Pallas TPU kernel of the JAX package; ops/ed25519._msm_scan chooses
// between them with the JAX package's flags:
//   K5 ed25519_msm_window_major_grouped
//        <- cometbft_tpu/ops/pallas_msm.py::msm_window_major(group > 1)
//   K6 ed25519_msm_window_loop  <- cometbft_tpu/ops/pallas_msm.py::msm_window_loop
//   K7 ed25519_select_tree      <- cometbft_tpu/ops/pallas_msm.py::select_tree
//
// What bounds them: chains of 20-limb int32 field products; the window
// tables are read one row per lane and window, so the bytes are small
// next to the operations.  K5 runs on thread quads (fe25519_quad.cuh):
// its window sums across the card, four quads per window and block,
// then K3's Horner chains (msm_quad.cuh).  K6 and K7 run one output
// lane per thread, every point in registers or thread-local memory.  No
// atomics: the results equal the plain torch versions in
// ops/cuda_msm.py limb for limb.
//
// Every launcher returns cudaGetLastError() of its launch (of each of its
// launches); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"
#include "fe25519_quad.cuh"
#include "msm_quad.cuh"

using namespace fe25519;

// threads per K6 / K7 block; ops/cuda_msm.py LOOP_THREADS mirrors it
#define LOOP_THREADS 128
// most table rows one K6 / K7 thread sums per window (blk / out lanes, so
// blocks up to 1,024 lanes); they sit in thread-local memory.
// ops/cuda_msm.py LOOP_MAX_ROWS mirrors it
#define LOOP_MAX_ROWS 8
// warps of a K5 window-sum block, and thread quads per window sum;
// ops/cuda_msm.py GROUP_WARPS and GROUP_QUADS mirror them
#define GROUP_WARPS 4
#define GROUP_QUADS 4

// ------------------------------------------------------- K6 / K7 shared

// One output lane's share of one window: the rows of lanes
// i * blk + o + k * out_l (k < r = blk / out_l) selected, then summed in
// the Pallas kernel's pairwise halving order (_block_contrib: lane L adds
// lane L + half while the block is wider than out_l), which on the r
// rows of one output lane is v[k] += v[k + s] for s = r/2, ..., 1.
// Lanes past W contribute the identity.
__device__ __forceinline__ pt block_contrib(const int32_t* __restrict__ tab,
                                            const int32_t* __restrict__ mags,
                                            const uint8_t* __restrict__ negs, int64_t w,
                                            int blk, int out_l, int64_t i, int o) {
  const int r = blk / out_l;
  pt v[LOOP_MAX_ROWS];
#pragma unroll 1
  for (int k = 0; k < r; ++k) {
    const int64_t lane = i * blk + o + (int64_t)k * out_l;
    v[k] = lane < w ? select_signed(tab, mags, negs, w, lane) : identity();
  }
#pragma unroll 1
  for (int s = r / 2; s >= 1; s >>= 1) {
#pragma unroll 1
    for (int k = 0; k < s; ++k) v[k] = point_add(v[k], v[k + s]);
  }
  return v[0];
}

// ------------------------------------------------------------------ K6

// The whole Straus window loop with per-block accumulators.  The TPU grid
// (block i, window j), j fastest, keeps each block's accumulator in its
// output block across the window steps; here one thread owns output lane
// (i, o) and carries its accumulator in registers over all windows:
// j = 0 sets it to the window's contribution, later windows run the 5
// doublings and the add (the recurrence is linear, so the lane sum of the
// per-block accumulators is the MSM).  Every thread's chain is
// independent: no shared memory, no barrier.
// tab: (17, 4, 20, W); mags: (nwin, W) int32; negs: (nwin, W) uint8;
// out: (4, 20, nblk * out_l), lane i * out_l + o (block-major, as the
// Pallas kernel's transpose leaves it).
__global__ void __launch_bounds__(LOOP_THREADS)
msm_window_loop_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ mags,
                       const uint8_t* __restrict__ negs, int64_t w, int nwin, int blk,
                       int out_l, int64_t nout, int32_t* __restrict__ out) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= nout) return;
  const int64_t i = gid / out_l;
  const int o = (int)(gid % out_l);
  pt acc = identity();
#pragma unroll 1
  for (int j = 0; j < nwin; ++j) {
    pt c = block_contrib(tab, mags + (int64_t)j * w, negs + (int64_t)j * w, w, blk, out_l,
                         i, o);
    acc = j == 0 ? c : straus_step(acc, c);
  }
  store_point(out, nout, gid, acc);
}

// ------------------------------------------------------------------ K7

// One window's select, negate and halving tree: output lane (i, o) of the
// partials is block_contrib for that lane.  The caller's window scan
// (ops/ed25519._msm_scan) launches it once per window on one stream and
// folds the partials with torch point ops.
// tab: (17, 4, 20, W); mag: (W,) int32; neg: (W,) uint8;
// out: (4, 20, nblk * out_l).
__global__ void __launch_bounds__(LOOP_THREADS)
select_tree_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ mag,
                   const uint8_t* __restrict__ neg, int64_t w, int blk, int out_l,
                   int64_t nout, int32_t* __restrict__ out) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= nout) return;
  store_point(out, nout, gid,
              block_contrib(tab, mag, neg, w, blk, out_l, gid / out_l, (int)(gid % out_l)));
}

// ------------------------------------------------------------------ K5

// Window-major Straus over 32-lane blocks, in two launches, as K3:
//   1. msm_grouped_sums_kernel, GROUP_QUADS thread quads per (window j,
//      block b), all in parallel across the card: S[j][b] = the block's
//      selected, signed rows reduced by the plain version's pairwise
//      tree (lane t adds lane t + s for s = 16, 8, 4, 2, 1);
//   2. msm_horner_kernel (msm_quad.cuh), one quad per block: acc =
//      S[0][b], then acc <- straus_step(acc, S[j][b]) in MSB order.
// Those are msm_window_major_grouped_plain's operations in its order, so
// the partials equal it limb for limb, and their lane sum is K3's MSM.
// The group G divides nwin (the wrapper checks) and decides nothing
// here: on the TPU a group shares one fetch of the table block across
// G window steps, but each quad reads only its own block's rows of its
// own window, so there is nothing to share, and every window's sums run
// at once whatever G is.

// Window sums, GROUP_QUADS = 4 quads per task, 2 tasks per warp.  Write
// T_s(t) for lane t after level s (T_s(t) = T_2s(t) + T_2s(t + s),
// T_32(t) = row t).  Quad h < 4 computes T_4(h) from lanes h, h + 4, ..,
// h + 28 depth first: leaf i (i = 0..3) is T_16(t) = row t + row t + 16
// for t = h, h + 8, h + 4, h + 12; after leaf 1, T_8(h) = leaf 0 + leaf
// 1; after leaf 3, T_8(h + 4) = leaf 2 + leaf 3, then T_4(h) = T_8(h) +
// T_8(h + 4).  Each point operation has one call site, in a loop:
// unrolled, the same walk took 216 registers instead of 168, and an SM
// held two blocks instead of three.  Levels 2 and 1 are quad h < s adding quad h + s by
// shuffles.  Every add of the plain tree is made once on the same two
// operands (the two cross-quad levels are computed by all four quads,
// the quads past s dropping theirs).  The leaves' right rows need 2d T,
// the one product of to_cached: thread q computes leaf q's in one round
// and hands each to thread 2 by shuffle, as K3's holders do, so a leaf
// add costs 2.25 product rounds and a tree add 3: 24 rounds in series
// per task.  (One quad per task does fewer rounds in all but holds more
// pending sums in registers; eight quads, four lanes each, waste more
// adds at levels 4 .. 1: both measured slower at the engine
// configurations' widths.)  Lanes past W are the identity; magnitudes
// outside 0..16 select row 0.  Spare quads past the last task repeat it
// and store nothing.
// tab: (17, 4, 20, W); mags: (nwin, W) int32; negs: (nwin, W) uint8;
// sums: (nwin, 4, 20, nblk), nblk = ceil(W / 32).
__global__ void __launch_bounds__(GROUP_WARPS * 32)
msm_grouped_sums_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ mags,
                        const uint8_t* __restrict__ negs, int64_t w, int nwin, int64_t nblk,
                        int32_t* __restrict__ sums) {
  const int q = quad_q();
  const int wq = (threadIdx.x & 31) >> 2;          // quad within its warp
  const int h = wq % GROUP_QUADS;
  const int64_t quad = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int64_t tasks = (int64_t)nwin * nblk;
  if ((quad - wq) / GROUP_QUADS >= tasks) return;  // a whole spare warp
  const int64_t mine = quad / GROUP_QUADS;
  const int64_t task = mine < tasks ? mine : tasks - 1;
  const int64_t j = task / nblk;
  const int64_t b = task % nblk;
  const int32_t* mj = mags + j * w;
  const uint8_t* nj = negs + j * w;
  const int64_t base = b * 32 + h;
  // leaf i's left lane: base + 4 * (i = 0, 1, 2, 3 -> 0, 2, 1, 3)
  const fe t2d = mul(load_signed(tab, mj, nj, w, base + 4 * ((q & 1) << 1 | q >> 1) + 16, 3),
                     fe_const(D2_LIMBS));
  // after leaf i, for each trailing one bit l of i: v = st_l + v (st_0
  // the pending leaf, st_1 the pending T_8); then v waits in st_l
  fe st0, st1, v;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int64_t right = base + 4 * ((i & 1) << 1 | i >> 1) + 16;
    const fe u = load_signed(tab, mj, nj, w, right, q == 3 ? 2 : 0);   // X, or Z
    const fe y = load_signed(tab, mj, nj, w, right, 1);
    const fe d = qshfl(t2d, i);
    const fe cn = fsel(q == 0, sub(y, u),
                       fsel(q == 1, add(y, u), fsel(q == 2, d, mul_word(u, 2))));
    v = qadd_cached(load_signed(tab, mj, nj, w, right - 16, q), cn);
    int l = 0;
#pragma unroll 1
    for (; l < 2 && ((i >> l) & 1); ++l) v = qpoint_add(fsel(l == 0, st0, st1), v);
    st0 = fsel(l == 0, v, st0);
    st1 = fsel(l == 1, v, st1);
  }
#pragma unroll 1
  for (int s = GROUP_QUADS / 2; s >= 1; s >>= 1) {
    const fe r = qpoint_add(v, qshfl_down(v, s));
    v = fsel(h < s, r, v);
  }
  if (h == 0 && mine < tasks) store_fe(sums + j * 4 * NL * nblk, nblk, b, q, v);
}

// ----------------------------------------------------------- launchers

extern "C" {

int ed25519_msm_window_loop(const void* tab, const void* mags, const void* negs, int64_t w,
                            int nwin, int blk, int out_l, int64_t nout, void* out,
                            void* stream) {
  int grid = (int)((nout + LOOP_THREADS - 1) / LOOP_THREADS);
  msm_window_loop_kernel<<<grid, LOOP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)mags, (const uint8_t*)negs, w, nwin, blk, out_l,
      nout, (int32_t*)out);
  return (int)cudaGetLastError();
}

int ed25519_select_tree(const void* tab, const void* mag, const void* neg, int64_t w,
                        int blk, int out_l, int64_t nout, void* out, void* stream) {
  int grid = (int)((nout + LOOP_THREADS - 1) / LOOP_THREADS);
  select_tree_kernel<<<grid, LOOP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)mag, (const uint8_t*)neg, w, blk, out_l, nout,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// sums: (nwin, 4, 20, ceil(W / 32)) scratch; out: (4, 20, ceil(W / 32)).
int ed25519_msm_window_major_grouped(const void* tab, const void* mags, const void* negs,
                                     int64_t w, int nwin, void* sums, void* out,
                                     void* stream) {
  const int64_t nblk = (w + 31) / 32;
  const int64_t per_block = GROUP_WARPS * 8 / GROUP_QUADS;   // tasks
  msm_grouped_sums_kernel<<<(unsigned)(((int64_t)nwin * nblk + per_block - 1) / per_block),
                            GROUP_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)mags, (const uint8_t*)negs, w, nwin, nblk,
      (int32_t*)sums);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_msm_horner((const int32_t*)sums, nwin, nblk, (int32_t*)out,
                           (cudaStream_t)stream);
}

int ed25519_loop_threads(void) { return LOOP_THREADS; }
int ed25519_loop_max_rows(void) { return LOOP_MAX_ROWS; }
int ed25519_group_warps(void) { return GROUP_WARPS; }
int ed25519_group_quads(void) { return GROUP_QUADS; }

}  // extern "C"
