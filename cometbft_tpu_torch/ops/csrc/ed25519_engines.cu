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
// next to the operations (but see K7 where the table outgrows the L2).
// All three run on thread quads (fe25519_quad.cuh) and split the work as
// K3 does: window sums across the card, with no doubling in them, then K3's
// Horner chains (msm_quad.cuh), one quad per partial, where there is more
// than one window.  K5's sums are 32-lane blocks (msm_grouped_sums_kernel);
// K6's and K7's are the Pallas kernels' output lanes
// (loop_window_sums_kernel).  No atomics: the results equal the plain torch
// versions in ops/cuda_msm.py limb for limb.
//
// Every launcher returns cudaGetLastError() of its launch (of each of its
// launches); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe25519.cuh"
#include "fe25519_quad.cuh"
#include "msm_quad.cuh"

using namespace fe25519;

// threads per K6 / K7 window-sum block; ops/cuda_msm.py LOOP_THREADS
// mirrors it
#define LOOP_THREADS 128
// quads a K6 / K7 launch aims to spread its tasks over: the launcher
// doubles the quads per task, up to min(r / 2, 8), while the launch has
// fewer
#define LOOP_FILL_QUADS 16384
// warps of a K5 window-sum block, and thread quads per window sum;
// ops/cuda_msm.py GROUP_WARPS and GROUP_QUADS mirror them
#define GROUP_WARPS 4
#define GROUP_QUADS 4

// ------------------------------------------------------------- K6 / K7

// Window sums of the Pallas partial layout: task (j, g), for window j and
// output lane g = i * out_l + o of block i, is S[j][g], the sum of the r =
// blk / out_l selected, signed rows of lanes i * blk + o + k * out_l (k <
// r), in the plain version's pairwise order (_block_contrib: lane L adds
// lane L + half while the block is wider than out_l), which on the task's
// rows is v[k] = v[k] + v[k + s] for s = r/2, ..., 1.  K7 is this kernel
// over one window; K6 is this kernel over all windows, then K3's Horner
// chains, one per output lane: acc = S[0], acc <- straus_step(acc, S[j]),
// the Pallas window loop's recurrence in its order.
//
// qt = 1, 2, 4 or 8 quads per task (a power of two <= r, chosen by the
// launcher; tasks never straddle a warp).  Quad h < qt holds the rows k =
// h + qt t, t < m = r / qt, and reduces them to T(h) = the sum the plain
// order has at k = h once s falls to qt: on local index t that is the
// same halving tree, u[t] += u[t + s'] for s' = m/2, ..., 1.  Its first
// level is the leaves, row t + row t + m/2 for t < m/2 (add_cached
// against the right row's cached form, whose one product, 2d T, thread q
// computes for leaf i + q of each four in one round); the levels above are
// walked depth first: leaf i in order is position bitrev(i), and after it,
// for each trailing one bit l of i, v = st[l] + v (the pending left sum at
// level l), then v waits in st[l].  The pending sums live in shared
// memory, [level][limb][thread], each thread reading only what it wrote,
// so the registers do not grow with r: one call site per point operation,
// in a loop.  Then the levels s = qt/2, ..., 1 across quads: quad h < s
// adds quad h + s by shuffles (all quads compute, those past s drop
// theirs).  Every add of the plain order is made once, on the same two
// operands: the kernel equals the plain version limb for limb.  m = 1
// (r = 1, at blocks of up to 128 lanes) is a row load.  Lanes
// past W are the identity; magnitudes outside 0..16 select row 0.  Spare
// quads past the last task repeat it and store nothing, so full-mask
// shuffles stay legal; a warp with no task returns at once.
// tab: (17, 4, 20, W); mags: (nwin, W) int32; negs: (nwin, W) uint8;
// sums: (nwin, 4, 20, nout), nout = nblk * out_l, block-major as the
// Pallas kernels' transpose leaves it.  Dynamic shared memory: depth *
// NL * LOOP_THREADS int32, depth = log2(m / 2) levels.
// A row's 80 words lie W words apart, so a quad's select reads 80
// scattered words, and with random digits one window's selects touch
// nearly every 128-byte line of the table.  At W = 10,240 the table (56
// MB) is larger than the H100's 50 MB L2, and K7 there is bound by those
// reads (measured at every qt alike), not by its adds.
__global__ void __launch_bounds__(LOOP_THREADS)
loop_window_sums_kernel(const int32_t* __restrict__ tab, const int32_t* __restrict__ mags,
                        const uint8_t* __restrict__ negs, int64_t w, int nwin, int blk,
                        int out_l, int64_t nout, int qt, int32_t* __restrict__ sums) {
  extern __shared__ int32_t pending[];
  const int q = quad_q();
  const int wq = (threadIdx.x & 31) >> 2;          // quad within its warp
  const int h = wq & (qt - 1);
  const int64_t quad = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int64_t tasks = (int64_t)nwin * nout;
  if ((quad - wq) / qt >= tasks) return;           // a whole spare warp
  const int64_t mine = quad / qt;
  const int64_t task = mine < tasks ? mine : tasks - 1;
  const int64_t j = task / nout;
  const int64_t g = task % nout;
  const int32_t* mj = mags + j * w;
  const uint8_t* nj = negs + j * w;
  const int m = blk / out_l / qt;
  // local row t of this quad is lane base + t * step
  const int64_t step = (int64_t)qt * out_l;
  const int64_t base = g / out_l * blk + g % out_l + (int64_t)h * out_l;
  fe v;
  if (m == 1) {
    v = load_signed(tab, mj, nj, w, base, q);
  } else {
    const int leaves = m / 2;
    const int bits = __ffs(leaves) - 1;
    const int64_t half = (int64_t)leaves * step;   // a leaf's right row
    fe t2d;
#pragma unroll 1
    for (int i = 0; i < leaves; ++i) {
      if ((i & 3) == 0) {
        const int iq = min(i + q, leaves - 1);
        const int64_t at = base + (bits ? __brev(iq) >> (32 - bits) : 0) * step + half;
        t2d = mul(load_signed(tab, mj, nj, w, at, 3), fe_const(D2_LIMBS));
      }
      const int64_t left = base + (bits ? __brev(i) >> (32 - bits) : 0) * step;
      const fe u = load_signed(tab, mj, nj, w, left + half, q == 3 ? 2 : 0);   // X, or Z
      const fe y = load_signed(tab, mj, nj, w, left + half, 1);
      const fe d = qshfl(t2d, i & 3);
      const fe cn = fsel(q == 0, sub(y, u),
                         fsel(q == 1, add(y, u), fsel(q == 2, d, mul_word(u, 2))));
      v = qadd_cached(load_signed(tab, mj, nj, w, left, q), cn);
      int l = 0;
#pragma unroll 1
      for (; (i >> l) & 1; ++l) {
        fe st;
#pragma unroll
        for (int k = 0; k < NL; ++k) st.v[k] = pending[(l * NL + k) * LOOP_THREADS + threadIdx.x];
        v = qpoint_add(st, v);
      }
      if (i + 1 < leaves) {
#pragma unroll
        for (int k = 0; k < NL; ++k) pending[(l * NL + k) * LOOP_THREADS + threadIdx.x] = v.v[k];
      }
    }
  }
#pragma unroll 1
  for (int s = qt / 2; s >= 1; s >>= 1) {
    const fe x = qpoint_add(v, qshfl_down(v, s));
    v = fsel(h < s, x, v);
  }
  if (h == 0 && mine < tasks) store_fe(sums + j * 4 * NL * nout, nout, g, q, v);
}

// Launches loop_window_sums_kernel over nwin windows into sums: qt quads
// per task, doubled from 1 while the launch has fewer than
// LOOP_FILL_QUADS quads and each quad keeps two rows or more, and the
// pending sums' shared memory.  One quad per task does the fewest adds;
// more quads shorten the chain where the tasks are too few to fill the
// card.  A quad of one row only trades its leaf for a cross-quad level
// that costs more: timed on the H100 at every K7 shape of the engine
// configurations, it was never faster than half as many quads.  r = blk /
// out_l is a power of two (the wrapper checks).
static int launch_loop_sums(const int32_t* tab, const int32_t* mags, const uint8_t* negs,
                            int64_t w, int nwin, int blk, int out_l, int64_t nout,
                            int32_t* sums, cudaStream_t stream) {
  const int r = blk / out_l;
  const int64_t tasks = (int64_t)nwin * nout;
  int qt = 1;
  while (qt < 8 && 2 * qt < r && tasks * qt < LOOP_FILL_QUADS) qt *= 2;
  int depth = 0;
  for (int x = r / qt / 2; x > 1; x >>= 1) ++depth;
  const size_t smem = (size_t)depth * NL * LOOP_THREADS * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        loop_window_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t per_block = LOOP_THREADS / 4 / qt;   // tasks
  loop_window_sums_kernel<<<(unsigned)((tasks + per_block - 1) / per_block), LOOP_THREADS,
                            smem, stream>>>(tab, mags, negs, w, nwin, blk, out_l, nout, qt,
                                            sums);
  return (int)cudaGetLastError();
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

// K6.  sums: (nwin, 4, 20, nout) scratch; out: (4, 20, nout).
int ed25519_msm_window_loop(const void* tab, const void* mags, const void* negs, int64_t w,
                            int nwin, int blk, int out_l, int64_t nout, void* sums, void* out,
                            void* stream) {
  const int rc = launch_loop_sums((const int32_t*)tab, (const int32_t*)mags,
                                  (const uint8_t*)negs, w, nwin, blk, out_l, nout,
                                  (int32_t*)sums, (cudaStream_t)stream);
  if (rc != 0) return rc;
  return launch_msm_horner((const int32_t*)sums, nwin, nout, (int32_t*)out,
                           (cudaStream_t)stream);
}

// K7: one window's sums, straight into out: (4, 20, nout).
int ed25519_select_tree(const void* tab, const void* mag, const void* neg, int64_t w,
                        int blk, int out_l, int64_t nout, void* out, void* stream) {
  return launch_loop_sums((const int32_t*)tab, (const int32_t*)mag, (const uint8_t*)neg, w, 1,
                          blk, out_l, nout, (int32_t*)out, (cudaStream_t)stream);
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
int ed25519_group_warps(void) { return GROUP_WARPS; }
int ed25519_group_quads(void) { return GROUP_QUADS; }

}  // extern "C"
