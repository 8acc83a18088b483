// The engine configurations of the ed25519 RLC MSM, as Hopper kernels with
// extern "C" launchers for ctypes (ops/_build.py).  Each replaces one
// Pallas TPU kernel of the JAX package; ops/ed25519._msm_scan chooses
// between them with the JAX package's flags:
//   K5 ed25519_msm_window_major_grouped
//        <- cometbft_tpu/ops/pallas_msm.py::msm_window_major(group > 1)
//   K6 ed25519_msm_window_loop  <- cometbft_tpu/ops/pallas_msm.py::msm_window_loop
//   K7 ed25519_select_tree      <- cometbft_tpu/ops/pallas_msm.py::select_tree
//
// What bounds them: chains of 20-limb int32 field products per thread; the
// window tables are read one row per lane and window, so the bytes are
// small next to the operations.  One lane (K5) or one output lane (K6, K7)
// per thread, every point in registers or thread-local memory, no atomics:
// the result equals the plain torch versions in ops/cuda_msm.py limb for
// limb.
//
// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"

using namespace fe25519;

// threads per K6 / K7 block; ops/cuda_msm.py LOOP_THREADS mirrors it
#define LOOP_THREADS 128
// most table rows one K6 / K7 thread sums per window (blk / out lanes, so
// blocks up to 1,024 lanes); they sit in thread-local memory.
// ops/cuda_msm.py LOOP_MAX_ROWS mirrors it
#define LOOP_MAX_ROWS 8
// warps of a K5 block; ops/cuda_msm.py GROUP_WARPS mirrors it
#define GROUP_WARPS 4

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

// The window sum of one 32-lane block on one warp: at step s, lane t < s
// adds the point of lane t + s (the plain version's _block_tree order),
// through shuffles; the sum is in lane 0.
__device__ __forceinline__ pt warp_tree(pt p) {
  const int t = threadIdx.x & 31;
#pragma unroll 1
  for (int s = 16; s >= 1; s >>= 1) {
    pt q;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      q.X.v[l] = __shfl_down_sync(0xffffffffu, p.X.v[l], s);
      q.Y.v[l] = __shfl_down_sync(0xffffffffu, p.Y.v[l], s);
      q.Z.v[l] = __shfl_down_sync(0xffffffffu, p.Z.v[l], s);
      q.T.v[l] = __shfl_down_sync(0xffffffffu, p.T.v[l], s);
    }
    if (t < s) p = point_add(p, q);
  }
  return p;
}

// Window-major Straus with G = group windows per pass, one partial per
// 32-lane block.  On the TPU a group shares one fetch of the table block
// across G window steps; here a thread reads only its lane's row per
// window, so there is no table block to share, and the group buys
// parallelism instead: the block's GROUP_WARPS warps each select and
// tree-reduce windows g, g + GROUP_WARPS, ... of the group over the
// block's 32 lanes into the shared scratch wacc[g], then thread 0 closes
// the group in MSB order with the 5-doublings-then-add chain per window
// (the first window of the first group sets the accumulator).  The order
// does not depend on G: the partials are msm_window_major_grouped_plain's
// (K3's order before it was redesigned), and their lane sum is K3's MSM.
// tab: (17, 4, 20, W); mags: (nwin, W) int32; negs: (nwin, W) uint8;
// out: (4, 20, nblk) partials, nblk = ceil(W / 32); nwin % group == 0;
// dynamic shared memory: group * 80 int32.
__global__ void __launch_bounds__(GROUP_WARPS * 32)
msm_window_major_grouped_kernel(const int32_t* __restrict__ tab,
                                const int32_t* __restrict__ mags,
                                const uint8_t* __restrict__ negs, int64_t w, int nwin,
                                int group, int32_t* __restrict__ out) {
  extern __shared__ int32_t wacc[];    // [g][coord * 20 + limb]
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t lane = (int64_t)blockIdx.x * 32 + t;
  pt acc = identity();
#pragma unroll 1
  for (int jg = 0; jg < nwin / group; ++jg) {
#pragma unroll 1
    for (int g = warp; g < group; g += GROUP_WARPS) {
      const int64_t j = (int64_t)jg * group + g;
      pt p = lane < w ? select_signed(tab, mags + j * w, negs + j * w, w, lane) : identity();
      p = warp_tree(p);
      if (t == 0) store_point(wacc + g * 4 * NL, 1, 0, p);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 1
      for (int g = 0; g < group; ++g) {
        pt p = load_point(wacc + g * 4 * NL, 1, 0);
        acc = (jg == 0 && g == 0) ? p : straus_step(acc, p);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) store_point(out, gridDim.x, blockIdx.x, acc);
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

int ed25519_msm_window_major_grouped(const void* tab, const void* mags, const void* negs,
                                     int64_t w, int nwin, int group, void* out,
                                     void* stream) {
  int grid = (int)((w + 31) / 32);
  size_t smem = (size_t)group * 4 * NL * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(msm_window_major_grouped_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  msm_window_major_grouped_kernel<<<grid, GROUP_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)mags, (const uint8_t*)negs, w, nwin, group,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int ed25519_loop_threads(void) { return LOOP_THREADS; }
int ed25519_loop_max_rows(void) { return LOOP_MAX_ROWS; }
int ed25519_group_warps(void) { return GROUP_WARPS; }

}  // extern "C"
