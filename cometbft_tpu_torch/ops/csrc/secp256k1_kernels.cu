// Kernels K11, K12 and K13: secp256k1 ECDSA verification, with extern "C"
// launchers for ctypes (ops/_build.py).  They replace the JAX package's
// plain-jnp programs under lax.scan, which XLA compiles into one program
// each (in eager torch each would be tens of thousands of launches):
//   K11 secp_q_tables  <- cometbft_tpu/ops/secp256k1.py::q_msm_tables_kernel (:327)
//   K12 secp_msm_verify <- cometbft_tpu/ops/secp256k1.py::msm_verify_kernel (:360)
//   K13 secp_ladder    <- cometbft_tpu/ops/secp256k1.py::verify_kernel (:186)
//
// Layouts at the C interface are the JAX package's, limbs first and the
// lane minor: a field element (22, B) int32, a Jacobian point (3, 22, B),
// the key tables (52, 16, 3, 22, K), bool tensors as one byte.
//
// What bounds them on the H100: the field products (K12 about 1,230 a
// signature, K11 about 13,000 a key, K13 about 4,100 a signature;
// chip_smoke.py counts them) and, for K11, K13 and a small batch of K12,
// the length of a dependent chain of them; for K12 also its gathers,
// 66 words a key-table row at a stride of K words (a 32-byte sector each).
//
// All three run on fe_secp_n.cuh, GF(p) in eight 32-bit words with the
// operands in registers; they read and write the JAX layout through
// from_limbs / to_limbs and store frozen values, so K11's tables equal
// the plain version's (ops/secp256k1.py) at canonical value, coordinate by
// coordinate (the same formulas, their products in the same order), and
// K12's and K13's verdicts the plain version's.
//   - K11, two launches, each on thread quads: four threads share a point
//     and run each point operation as rounds of independent products,
//     thread l computing the l-th product of a round and the round's
//     results going to all four by shuffles (jdbl_quad: 3 rounds for 7
//     products; jadd_quad: 5 for 16).  The walk: a quad per key takes the
//     52 window bases 2^(5j) Q (5 doublings a window, 260 in all, a chain
//     no split shortens) and the correction 2^260 Q, the bases into the
//     caller's scratch in native words (52, 3, 8, K).  The rows: a quad
//     per (window, key) builds the window's 16 odd rows (a doubling, then
//     15 adds in the plain version's order), each thread of the quad
//     storing one coordinate.  The products are inline: these chains are
//     the kernel's time.
//   - K12: each signature's sum S + 32 G terms + 52 Q terms + the two
//     corrections - S has no doubling and is associative, so it is split
//     over T neighbouring threads of a warp.  Thread t adds the G windows
//     j == t (mod T) (mixed adds, all threads in step), then the Q slots
//     s == t (mod T): the 52 key-table rows, then 2^260 Q, 2^256 G (as a
//     Jacobian point with Z = 1) and -2T S, so that every add of a warp
//     step is the same operation.  log2 T rounds of shuffles and jadd_fast
//     fold the partial sums onto the signature's lead thread, which runs
//     the inversion-free epilogue.  T = 8 while the launch's blocks fit on
//     the card at once (the chain is the time), else 4 (msm_split).  Each
//     thread stages its next term's limbs into shared memory with cp.async
//     while it adds the current one, and the point operations call the
//     products out of line (one copy of each in the instruction cache).
//     Blinding.  Every partial starts from a multiple of the pack's random
//     point S, never from a table term or the identity: thread t from
//     m_t S, m = (1, 2, 4, 1) by t mod 4, and the thread of slot 54 (m = 4)
//     adds -2T S = -(sum of the m_t) S.  Then the two points of every add
//     differ by, or sum to, the terms' sum plus a nonzero multiple k S with
//     |k| <= 2T + 4: in the partials a point m S + X meets a term or
//     -2T S; in the combine the halves carry 1 / 2, 4 / 1 and 4 - 2T / 1
//     times S in the first round, 3 / 5 and 3 / 5 - 2T in the second
//     (T = 8), never equal or opposite, and in the last round two
//     opposite multiples (3 / -3, 8 / -8), whose sum is zero exactly when
//     u1 G + u2 Q is infinity, where the JAX order's last add (-S) meets
//     P = -Q too and both reject.  So a
//     collision (P = +-Q, where the incomplete formulas fail) needs
//     k S to equal a point fixed by the signature, with S = t G for a
//     secret random t: the JAX order's own probability, so the verdicts
//     stay the JAX package's (check (1) of ROADMAP.md's North star).
//     S, 2S, 4S and -2T S are made once a block by its first warp, on
//     quads, into shared memory (log2 2T doublings).
//
//   - K13, on thread quads as K11: a quad per signature holds the
//     accumulator, and runs the plain version's ladder in its order: the
//     16-row Q table (the (1, 1, 1) filler, Q, 2Q by jdbl_quad, 13
//     jadd_quad), then 64 windows of 4 jdbl_quad and two exact additions
//     (jadd_complete_quad: jadd_quad's five rounds, exposing h and rr,
//     then the plain version's selects), the G row before the Q row.  The
//     tables live in shared memory in native words: the G table converted
//     once a block from the JAX layout, each signature's Q table stored
//     by its quad, one coordinate a thread (1.5 KB a signature), so a
//     row select reads shared memory, not a local-memory stack.  The
//     epilogue is K12's, without the inversion: X == r Z^2 or (r + n) Z^2,
//     with the case Z == 0 decided as the plain version's Fermat inverse
//     (0) decides it (ladder_verdict, fe_secp_n.cuh).  The same formulas
//     in the same order give the same field element at every step, the
//     off-curve inputs' too, so the verdicts are the plain version's.
//     The bound: the chain, about 1,500 rounds of independent products.
//
// Every launcher returns cudaGetLastError() of its launches; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "fe_secp_n.cuh"

#define SECP_THREADS 64         // K13: a quad per signature
#define K11_THREADS 32          // K11: a quad per key or (window, key)
#define K12_THREADS 128         // K12: T threads per signature

namespace {

constexpr int NG = 32, GROWS = 128;     // u1: 8-bit odd windows
constexpr int NQ = 52, QROWS = 16;      // u2: 5-bit odd windows, 5 doublings
constexpr int WQ = 5;
constexpr int NIB = 64;                 // ladder: 4-bit windows

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

int blocks_for(int64_t n, int threads = SECP_THREADS) {
  return (int)((n + threads - 1) / threads);
}

// ------------------------------------------------------------------ K11, K12

namespace native {

using namespace fesecpn;

// a JAX-layout point (3, 22, n) at lane i
__device__ __forceinline__ jpt load_pt(const int32_t* p, int64_t n,
                                       int64_t i) {
  jpt r;
  r.x = from_limbs(p + i, n);
  r.y = from_limbs(p + NL * n + i, n);
  r.z = from_limbs(p + 2 * NL * n + i, n);
  return r;
}

// a native point (3, 8, n) words at lane i
__device__ __forceinline__ jpt load_words(const uint32_t* p, int64_t n,
                                          int64_t i) {
  jpt r;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    r.x.w[w] = p[w * n + i];
    r.y.w[w] = p[(NW + w) * n + i];
    r.z.w[w] = p[(2 * NW + w) * n + i];
  }
  return r;
}

__device__ __forceinline__ void store_words(uint32_t* p, int64_t n,
                                            int64_t i, const jpt& a) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    p[w * n + i] = a.x.w[w];
    p[(NW + w) * n + i] = a.y.w[w];
    p[(2 * NW + w) * n + i] = a.z.w[w];
  }
}

// ------------------------------------------------------------------ quads

// the l-th of four elements, word by word (selects, no local copy)
__device__ __forceinline__ fe pick(int l, const fe& a, const fe& b,
                                   const fe& c, const fe& d) {
  fe r;
#pragma unroll
  for (int w = 0; w < NW; ++w)
    r.w[w] = l == 0 ? a.w[w] : (l == 1 ? b.w[w] : (l == 2 ? c.w[w] : d.w[w]));
  return r;
}

// word by word from thread src of this thread's quad
__device__ __forceinline__ fe quad_bcast(const fe& v, int src) {
  const int lane = (int)(threadIdx.x & 28u) | src;
  fe r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.w[w] = __shfl_sync(0xffffffffu, v.w[w], lane);
  return r;
}

// a product inline (INL: a chain that is the kernel's time) or out of line
template <bool INL>
__device__ __forceinline__ fe qmul(const fe& a, const fe& b) {
  return INL ? mul_inl(a, b) : mul(a, b);
}

// jdbl on a quad, every thread holding the point: its seven products in
// three rounds of independent ones (thread l computes the l-th product of
// a round, and the round's results go to all four), the same operations
// on the same values as dbl-2009-l in the plain version (ops/secp256k1.jdbl)
template <bool INL>
__device__ __forceinline__ jpt jdbl_quad(const jpt& p, int l) {
  const fe r1 = qmul<INL>(pick(l, p.x, p.y, p.y, p.y),
                          pick(l, p.x, p.y, p.z, p.z));
  const fe a = quad_bcast(r1, 0);       // X^2
  const fe b = quad_bcast(r1, 1);       // Y^2
  const fe yz = quad_bcast(r1, 2);      // Y Z
  const fe e = add(add(a, a), a);
  const fe pb = pick(l, b, e, add(p.x, b), b);
  const fe r2 = INL ? sqr_inl(pb) : sqr(pb);
  const fe c = quad_bcast(r2, 0);       // B^2
  const fe f = quad_bcast(r2, 1);       // E^2
  fe d = sub(sub(quad_bcast(r2, 2), a), c);
  d = add(d, d);
  jpt r;
  r.x = sub(f, add(d, d));
  fe c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  r.y = sub(qmul<INL>(e, sub(d, r.x)), c8);
  r.z = add(yz, yz);
  return r;
}

// jadd_fast on a quad: its sixteen products in five rounds, as jdbl_quad;
// h = U2 - U1 and rr = S2 - S1 out as well, for the exact addition's tests
__device__ __forceinline__ jpt jadd_quad_hr(const jpt& p, const jpt& q, int l,
                                            fe& h, fe& rr) {
  const fe r1 = mul_inl(pick(l, p.z, q.z, p.y, q.y),
                        pick(l, p.z, q.z, q.z, p.z));
  const fe z1z1 = quad_bcast(r1, 0);
  const fe z2z2 = quad_bcast(r1, 1);
  const fe r2 = mul_inl(pick(l, p.x, q.x, quad_bcast(r1, 2),
                             quad_bcast(r1, 3)),
                        pick(l, z2z2, z1z1, z2z2, z1z1));
  const fe u1 = quad_bcast(r2, 0);
  const fe s1 = quad_bcast(r2, 2);
  h = sub(quad_bcast(r2, 1), u1);
  rr = sub(quad_bcast(r2, 3), s1);
  const fe r3 = mul_inl(pick(l, h, rr, p.z, p.z), pick(l, h, rr, q.z, q.z));
  const fe h2 = quad_bcast(r3, 0);
  const fe r4 = mul_inl(pick(l, h, u1, quad_bcast(r3, 2), h),
                        pick(l, h2, h2, h, h));
  const fe h3 = quad_bcast(r4, 0);
  const fe v = quad_bcast(r4, 1);
  jpt r;
  r.x = sub(sub(quad_bcast(r3, 1), h3), add(v, v));
  const fe r5 = mul_inl(pick(l, rr, s1, rr, rr),
                        pick(l, sub(v, r.x), h3, h3, h3));
  r.y = sub(quad_bcast(r5, 0), quad_bcast(r5, 1));
  r.z = quad_bcast(r4, 2);
  return r;
}

__device__ __forceinline__ jpt jadd_quad(const jpt& p, const jpt& q, int l) {
  fe h, rr;
  return jadd_quad_hr(p, q, l, h, rr);
}

// coordinate l < 3 of a point, frozen, in the JAX layout (3, 22, n) at
// lane i: the quad's threads store one coordinate each
__device__ __forceinline__ void store_coord(int32_t* p, int64_t n, int64_t i,
                                            const jpt& a, int l) {
  if (l < 3) to_limbs(p + l * NL * n + i, n, pick(l, a.x, a.y, a.z, a.z));
}

// ------------------------------------------------------------------ K11

// the walk: a quad per key, bases[j] = 2^(5j) Q for j < 52 (native words,
// the scratch), corr = 2^260 Q (JAX layout, frozen)
__global__ void __launch_bounds__(K11_THREADS)
q_bases_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
               int64_t nk, uint32_t* __restrict__ bases,
               int32_t* __restrict__ corr) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t key = g >> 2;
  const int l = (int)(g & 3);
  // the quads past the last key repeat it and store nothing
  const int64_t k = key < nk ? key : nk - 1;
  const bool live = key < nk;
  jpt b;
  b.x = from_limbs(qx + k, nk);
  b.y = from_limbs(qy + k, nk);
  b.z = fe_one();
#pragma unroll 1
  for (int j = 0; j < NQ; ++j) {
    if (live && l == 0) store_words(bases + (int64_t)j * 3 * NW * nk, nk, k, b);
#pragma unroll 1
    for (int d = 0; d < WQ; ++d) b = jdbl_quad<true>(b, l);
  }
  if (live) store_coord(corr, nk, k, b, l);
}

// the rows: a quad per (window j, key k): b, b + 2b, ..., b + 15 * 2b
__global__ void __launch_bounds__(K11_THREADS)
q_rows_kernel(const uint32_t* __restrict__ bases, int64_t nk,
              int32_t* __restrict__ qtab) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t task = g >> 2;
  const int l = (int)(g & 3);
  const bool live = task < NQ * nk;
  const int64_t t = live ? task : NQ * nk - 1;
  const int64_t j = t / nk, k = t % nk;
  const jpt b = load_words(bases + j * 3 * NW * nk, nk, k);
  const jpt d2 = jdbl_quad<true>(b, l);
  int32_t* win = qtab + j * QROWS * 3 * NL * nk;
  jpt prev = b;
  if (live) store_coord(win, nk, k, prev, l);
#pragma unroll 1
  for (int m = 1; m < QROWS; ++m) {
    prev = jadd_quad(prev, d2, l);
    if (live) store_coord(win + (int64_t)m * 3 * NL * nk, nk, k, prev, l);
  }
}

// ------------------------------------------------------------------ K12

// the staging slots: K12_STAGE words a thread, word-major
constexpr int K12_STAGE = 3 * NL;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// ncoord x 22 limbs p[(c * 22 + l) * stride] into this thread's slots,
// asynchronously (cp.async): they land while the thread computes
__device__ __forceinline__ void stage(uint32_t* slots, const int32_t* p,
                                      int64_t stride, int ncoord) {
#pragma unroll 1
  for (int c = 0; c < ncoord; ++c) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
      cp_async4(slots + (c * NL + l) * K12_THREADS, p + (c * NL + l) * stride);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void staged_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// T threads per signature (see the note at the top)
template <int T>
__global__ void __launch_bounds__(K12_THREADS)
msm_verify_kernel(const int32_t* __restrict__ qtab,
                  const int32_t* __restrict__ q_corr,
                  const int32_t* __restrict__ gid,
                  const int32_t* __restrict__ g_rows,
                  const uint8_t* __restrict__ g_neg,
                  const int32_t* __restrict__ q_rows,
                  const uint8_t* __restrict__ q_neg,
                  const int32_t* __restrict__ r_limbs,
                  const int32_t* __restrict__ rn_limbs,
                  const uint8_t* __restrict__ rn_valid,
                  const int32_t* __restrict__ s_pt,
                  const int32_t* __restrict__ gtab,
                  const int32_t* __restrict__ gcorr, int64_t nb, int64_t nk,
                  uint8_t* __restrict__ out) {
  static_assert(T == 4 || T == 8, "the blinding multiples are for T = 4, 8");
  static_assert(NG % T == 0 && 32 % T == 0 && K12_THREADS % T == 0, "T");
  constexpr int QSLOTS = NQ + 3;        // key rows, 2^260 Q, 2^256 G, -2T S
  constexpr int QITER = (QSLOTS + T - 1) / T;
  __shared__ uint32_t mults[4][3 * NW];  // S, 2S, 4S, -2T S
  __shared__ uint32_t slots_all[K12_STAGE * K12_THREADS];
  uint32_t* slots = slots_all + threadIdx.x;

  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int t = (int)(g % T);
  const int64_t lane = g / T;
  // threads past the batch repeat its last signature and write nothing:
  // every thread of a warp takes part in the shuffles
  const int64_t i = lane < nb ? lane : nb - 1;
  const int64_t slot = clampi(gid[i], 0, (int)(nk - 1));
  // the first G term's limbs start to land while warp 0 makes the
  // multiples of S (on quads)
  int row = clampi(g_rows[t * nb + i], 0, GROWS - 1);
  bool negate = g_neg[t * nb + i];
  stage(slots, gtab + ((int64_t)t * GROWS + row) * 2 * NL, 1, 2);
  if (threadIdx.x < 32) {
    constexpr int NDBL = T == 4 ? 3 : 4;    // 2T S = 2^NDBL S
    const int l = threadIdx.x & 3;
    jpt m = load_pt(s_pt, 1, 0);
    if (threadIdx.x == 0) store_words(&mults[0][0], 1, 0, m);
#pragma unroll 1
    for (int c = 1; c <= NDBL; ++c) {
      m = jdbl_quad<false>(m, l);
      if (threadIdx.x == 0 && c < 3) store_words(&mults[c][0], 1, 0, m);
    }
    m.y = neg(m.y);
    if (threadIdx.x == 0) store_words(&mults[3][0], 1, 0, m);
  }
  __syncthreads();
  const int start = (t & 3) == 1 ? 1 : ((t & 3) == 2 ? 2 : 0);
  jpt acc = load_words(&mults[start][0], 1, 0);

  // G windows j = it T + t: convert the staged row, stage the next term
  // (the next G row, or the first Q slot), then add
#pragma unroll 1
  for (int it = 0; it < NG / T; ++it) {
    staged_wait();
    const fe ax = from_limbs((const int32_t*)slots, K12_THREADS);
    fe ay = from_limbs((const int32_t*)slots + NL * K12_THREADS, K12_THREADS);
    if (negate) ay = neg(ay);
    if (it + 1 < NG / T) {
      const int j = (it + 1) * T + t;
      row = clampi(g_rows[j * nb + i], 0, GROWS - 1);
      negate = g_neg[j * nb + i];
      stage(slots, gtab + ((int64_t)j * GROWS + row) * 2 * NL, 1, 2);
    } else {
      row = clampi(q_rows[t * nb + i], 0, QROWS - 1);
      negate = q_neg[t * nb + i];
      stage(slots, qtab + ((int64_t)t * QROWS + row) * 3 * NL * nk + slot,
            nk, 3);
    }
    acc = jadd_mixed(acc, ax, ay);
  }
  // Q slots s = it T + t: the key rows, then 2^260 Q, 2^256 G with Z = 1
  // and -2T S
#pragma unroll 1
  for (int it = 0; it < QITER; ++it) {
    const int s = it * T + t;
    jpt ent;
    if (s <= NQ + 1) {
      staged_wait();
      const int32_t* sl = (const int32_t*)slots;
      ent.x = from_limbs(sl, K12_THREADS);
      ent.y = from_limbs(sl + NL * K12_THREADS, K12_THREADS);
      ent.z = s == NQ + 1 ? fe_one()
                          : from_limbs(sl + 2 * NL * K12_THREADS, K12_THREADS);
      if (negate) ent.y = neg(ent.y);
    } else {
      ent = load_words(&mults[3][0], 1, 0);
    }
    const int sn = s + T;
    negate = false;
    if (sn < NQ) {
      row = clampi(q_rows[sn * nb + i], 0, QROWS - 1);
      negate = q_neg[sn * nb + i];
      stage(slots, qtab + ((int64_t)sn * QROWS + row) * 3 * NL * nk + slot,
            nk, 3);
    } else if (sn == NQ) {
      stage(slots, q_corr + slot, nk, 3);
    } else if (sn == NQ + 1) {
      stage(slots, gcorr, 1, 2);
    }
    if (s < QSLOTS) acc = jadd_fast(acc, ent);
  }
#pragma unroll 1
  for (int off = 1; off < T; off *= 2) {
    jpt o;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      o.x.w[w] = __shfl_down_sync(0xffffffffu, acc.x.w[w], off, T);
      o.y.w[w] = __shfl_down_sync(0xffffffffu, acc.y.w[w], off, T);
      o.z.w[w] = __shfl_down_sync(0xffffffffu, acc.z.w[w], off, T);
    }
    if ((t & (2 * off - 1)) == 0) acc = jadd_fast(acc, o);
  }
  if (t != 0 || lane >= nb) return;
  // inversion-free epilogue: Z != 0 and X == r Z^2 or (r + n) Z^2
  const fe z2 = sqr(acc.z);
  const bool not_inf = !is_zero(acc.z);
  const bool ok_r = eq(acc.x, mul(from_limbs(r_limbs + i, nb), z2));
  const bool ok_rn =
      eq(acc.x, mul(from_limbs(rn_limbs + i, nb), z2)) && rn_valid[i];
  out[i] = not_inf && (ok_r || ok_rn);
}

template <int T>
void msm_verify_launch(const void* qtab, const void* q_corr, const void* gid,
                       const void* g_rows, const void* g_neg,
                       const void* q_rows, const void* q_neg,
                       const void* r_limbs, const void* rn_limbs,
                       const void* rn_valid, const void* s_pt,
                       const void* gtab, const void* gcorr, int64_t nb,
                       int64_t nk, void* out, cudaStream_t stream) {
  msm_verify_kernel<T><<<blocks_for(nb * T, K12_THREADS), K12_THREADS, 0,
                         stream>>>(
      (const int32_t*)qtab, (const int32_t*)q_corr, (const int32_t*)gid,
      (const int32_t*)g_rows, (const uint8_t*)g_neg, (const int32_t*)q_rows,
      (const uint8_t*)q_neg, (const int32_t*)r_limbs,
      (const int32_t*)rn_limbs, (const uint8_t*)rn_valid,
      (const int32_t*)s_pt, (const int32_t*)gtab, (const int32_t*)gcorr, nb,
      nk, (uint8_t*)out);
}

// T = 8 while its blocks fit on the card at once (the chain is the time),
// else T = 4 (fewer threads for the same sum: throughput is the time); the
// card's room for blocks of T = 8, read once per device
int msm_split(int64_t nb) {
  static int room[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 4;
  if (room[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, msm_verify_kernel<8>, K12_THREADS, 0) != cudaSuccess)
      return 4;
    room[dev] = sms * per_sm;
  }
  return blocks_for(nb * 8, K12_THREADS) <= room[dev] ? 8 : 4;
}

// ------------------------------------------------------------------ K13

// a table row (3 coordinates of 8 words) at word stride ws: word w of
// coordinate c of row k at base[(k * rs + c * NW + w) * ws]
__device__ __forceinline__ jpt load_row(const uint32_t* base, int k, int rs,
                                        int ws) {
  jpt r;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    r.x.w[w] = base[(k * rs + w) * ws];
    r.y.w[w] = base[(k * rs + NW + w) * ws];
    r.z.w[w] = base[(k * rs + 2 * NW + w) * ws];
  }
  return r;
}

// row k of a quad's Q table: thread l < 3 stores coordinate l
__device__ __forceinline__ void store_row(uint32_t* base, int k, int ws,
                                          const jpt& a, int l) {
  if (l < 3) {
    const fe v = pick(l, a.x, a.y, a.z, a.z);
#pragma unroll
    for (int w = 0; w < NW; ++w) base[(k * 3 * NW + l * NW + w) * ws] = v.w[w];
  }
}

__device__ __forceinline__ jpt filler() {
  jpt r;
  r.x = fe_one();
  r.y = fe_one();
  r.z = fe_one();
  return r;
}

// The exact addition (the plain version's jadd_complete) on a quad: the
// doubling where h == rr == 0, q where p is at infinity, p where q is,
// the (1, 1, 1) filler and infinity where h == 0 != rr, selected in that
// order.  h and rr reach all four threads, so a quad agrees on every
// branch; the doubling runs when any quad of the warp takes it (the
// shuffles need the whole warp), and is the same value either way.
__device__ __forceinline__ void jadd_complete_quad(jpt& p, bool& p_inf,
                                                   const jpt& q, bool q_inf,
                                                   int l) {
  fe h, rr;
  jpt out = jadd_quad_hr(p, q, l, h, rr);
  const bool h_zero = is_zero(h);
  const bool r_zero = is_zero(rr);
  const bool is_dbl = h_zero && r_zero && !p_inf && !q_inf;
  const bool is_cancel = h_zero && !r_zero && !p_inf && !q_inf;
  if (__any_sync(0xffffffffu, is_dbl)) {
    const jpt d = jdbl_quad<true>(p, l);
    if (is_dbl) out = d;
  }
  if (p_inf) out = q;
  if (q_inf) out = p;
  if (is_cancel) out = filler();
  p_inf = (p_inf && q_inf) || is_cancel;
  p = out;
}

// The ladder's shared memory: the G table, 16 rows of GROW words (3 x 8,
// padded by one so that the 16 rows start on 16 distinct banks), then
// each signature's Q table, (16, 3, 8) words, the block's SIGS signatures
// minor (the quads of a warp read their own rows: distinct banks).
constexpr int GROW = 3 * NW + 1;
constexpr int SIGS = SECP_THREADS / 4;

// a quad per signature (see the note at the top)
__global__ void __launch_bounds__(SECP_THREADS)
ladder_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
              const int32_t* __restrict__ u1_nibs,
              const int32_t* __restrict__ u2_nibs,
              const int32_t* __restrict__ r_limbs,
              const int32_t* __restrict__ rn_limbs,
              const uint8_t* __restrict__ rn_valid,
              const int32_t* __restrict__ gtab, int64_t nb,
              uint8_t* __restrict__ out) {
  __shared__ uint32_t gs[16 * GROW];
  __shared__ uint32_t qs_all[16 * 3 * NW * SIGS];
  const int l = (int)(threadIdx.x & 3u);
  uint32_t* qs = qs_all + (threadIdx.x >> 2);
  const int64_t lane =
      ((int64_t)blockIdx.x * SECP_THREADS + threadIdx.x) >> 2;
  // the quads past the batch repeat its last signature and write nothing:
  // every thread of a warp takes part in the shuffles
  const int64_t i = lane < nb ? lane : nb - 1;
  // the G table, from the JAX layout (16, 3, 22), once a block
  for (int t = threadIdx.x; t < 16 * 3; t += SECP_THREADS) {
    const fe v = from_limbs(gtab + t * NL, 1);
#pragma unroll
    for (int w = 0; w < NW; ++w) gs[(t / 3) * GROW + (t % 3) * NW + w] = v.w[w];
  }
  // rows k Q, k = 0..15: the (1, 1, 1) filler, Q, 2Q, then 13 adds of Q
  jpt q1;
  q1.x = from_limbs(qx + i, nb);
  q1.y = from_limbs(qy + i, nb);
  q1.z = fe_one();
  store_row(qs, 0, SIGS, filler(), l);
  store_row(qs, 1, SIGS, q1, l);
  jpt prev = jdbl_quad<true>(q1, l);
  store_row(qs, 2, SIGS, prev, l);
#pragma unroll 1
  for (int k = 3; k < 16; ++k) {
    prev = jadd_quad(prev, q1, l);
    store_row(qs, k, SIGS, prev, l);
  }
  __syncthreads();

  jpt acc;
  acc.x = fe_one();
  acc.y = fe_one();
  acc.z = fe_zero();
  bool inf = true;
  int n1 = u1_nibs[i], n2 = u2_nibs[i];
#pragma unroll 1
  for (int w = 0; w < NIB; ++w) {
    // the next window's nibbles load while this one computes
    const int wn = w + 1 < NIB ? w + 1 : w;
    const int n1_next = u1_nibs[wn * nb + i], n2_next = u2_nibs[wn * nb + i];
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = jdbl_quad<true>(acc, l);
    // the G row, then the Q row; a nibble outside 1..15 takes row 0, as
    // the plain version's select does, and 0 marks the operand infinity
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      const int n = s == 0 ? n1 : n2;
      const int row = (n >= 1 && n <= 15) ? n : 0;
      const jpt ent = s == 0 ? load_row(gs, row, GROW, 1)
                             : load_row(qs, row, 3 * NW, SIGS);
      jadd_complete_quad(acc, inf, ent, n == 0, l);
    }
    n1 = n1_next;
    n2 = n2_next;
  }
  // inversion-free epilogue: Z^2 (every thread), then r Z^2 and (r + n)
  // Z^2 in one round (threads 0 and 1); the lead thread decides
  const fe z2 = sqr_inl(acc.z);
  const fe r = from_limbs(r_limbs + i, nb);
  const fe rn = from_limbs(rn_limbs + i, nb);
  const fe prod = mul_inl(pick(l, r, rn, r, r), z2);
  const fe rz2 = quad_bcast(prod, 0);
  const fe rnz2 = quad_bcast(prod, 1);
  if (l == 0 && lane < nb)
    out[i] = ladder_verdict(acc.x, acc.z, r, rn, rz2, rnz2, rn_valid[i] != 0,
                            inf);
}

}  // namespace native

}  // namespace

extern "C" {

int secp_threads() { return SECP_THREADS; }

// K11: qx, qy (22, K) -> qtab (52, 16, 3, 22, K), corr (3, 22, K), through
// the (52, 3, 22, K) int32 scratch `bases` (its first 52 * 3 * 8 * K words);
// the walk and the rows are also exported alone, to be timed apart
int secp_q_tables_walk(const void* qx, const void* qy, int64_t nk,
                       void* bases, void* corr, void* stream) {
  if (nk == 0) return 0;
  native::q_bases_kernel<<<blocks_for(4 * nk, K11_THREADS), K11_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, nk, (uint32_t*)bases,
      (int32_t*)corr);
  return (int)cudaGetLastError();
}

int secp_q_tables_rows(const void* bases, int64_t nk, void* qtab,
                       void* stream) {
  if (nk == 0) return 0;
  native::q_rows_kernel<<<blocks_for(4 * NQ * nk, K11_THREADS), K11_THREADS,
                          0, (cudaStream_t)stream>>>(
      (const uint32_t*)bases, nk, (int32_t*)qtab);
  return (int)cudaGetLastError();
}

int secp_q_tables(const void* qx, const void* qy, int64_t nk, void* bases,
                  void* qtab, void* corr, void* stream) {
  const int rc = secp_q_tables_walk(qx, qy, nk, bases, corr, stream);
  if (rc != 0) return rc;
  return secp_q_tables_rows(bases, nk, qtab, stream);
}

// K12: one verdict byte per signature
int secp_msm_verify(const void* qtab, const void* q_corr, const void* gid,
                    const void* g_rows, const void* g_neg, const void* q_rows,
                    const void* q_neg, const void* r_limbs,
                    const void* rn_limbs, const void* rn_valid,
                    const void* s_pt, const void* gtab, const void* gcorr,
                    int64_t nb, int64_t nk, void* out, void* stream) {
  if (nb == 0) return 0;
  if (native::msm_split(nb) == 8)
    native::msm_verify_launch<8>(qtab, q_corr, gid, g_rows, g_neg, q_rows,
                                 q_neg, r_limbs, rn_limbs, rn_valid, s_pt,
                                 gtab, gcorr, nb, nk, out,
                                 (cudaStream_t)stream);
  else
    native::msm_verify_launch<4>(qtab, q_corr, gid, g_rows, g_neg, q_rows,
                                 q_neg, r_limbs, rn_limbs, rn_valid, s_pt,
                                 gtab, gcorr, nb, nk, out,
                                 (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K13: one verdict byte per signature
int secp_ladder(const void* qx, const void* qy, const void* u1_nibs,
                const void* u2_nibs, const void* r_limbs,
                const void* rn_limbs, const void* rn_valid, const void* gtab,
                int64_t nb, void* out, void* stream) {
  if (nb == 0) return 0;
  native::ladder_kernel<<<blocks_for(4 * nb), SECP_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)u1_nibs,
      (const int32_t*)u2_nibs, (const int32_t*)r_limbs,
      (const int32_t*)rn_limbs, (const uint8_t*)rn_valid,
      (const int32_t*)gtab, nb, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
