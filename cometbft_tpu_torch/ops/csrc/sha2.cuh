// SHA-512 and SHA-256 for kernels K9 and K10 (sha2_kernels.cu): the
// round, the schedule step and the two halves of the warp-pair design,
// written once over the word.  Sha512 keeps its 64-bit words as uint64_t,
// which sm_90 computes as hi and lo halves on the 32-bit ALUs (a rotation
// is two funnel shifts, a sum of three terms one IADD3 pair); Sha256 has
// 32-bit words.
//
// The design (sha_pair_kernel below): a warp pair for each group of 32
// messages.  The schedule warp loads each message block into shared
// memory with coalesced 16-byte cp.async copies, one block ahead of its
// use, and expands the block's schedule into KW[i] = K[i] + W[i] in
// shared memory, laid out [round][message] in two stages (blocks) of
// 16-round chunks; it signals each chunk on a named barrier once it is
// written.  The round warp runs only the rounds: one shared-memory read
// of KW a round, no schedule and no global load on its stream.  A barrier
// in the other direction hands a stage back before it is written again.
//
// Everything above the `#ifdef __CUDACC__` line compiles as host C++ too
// (with __device__, __forceinline__ and __constant__ defined away and a
// host __funnelshift_r), so the CPU tests hash in the kernel's order.

#pragma once

#include <cstdint>

namespace sha2 {

__constant__ uint64_t K512[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull};

__constant__ uint64_t H512[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};

__constant__ uint32_t K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__constant__ uint32_t H256[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};

// words a row of the staged block takes in shared memory: 16 and a pad
// that keeps a row 16-byte aligned and spreads eight lanes' 16-byte reads
// over all 32 banks (row j starts at bank 20 j mod 32)
constexpr int WROW = 20;

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// 64-bit rotation right by a constant n (1..63, not 32) as two funnel
// shifts on the 32-bit halves
__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  uint32_t rlo, rhi;
  if (n < 32) {
    rlo = __funnelshift_r(lo, hi, n);
    rhi = __funnelshift_r(hi, lo, n);
  } else {
    rlo = __funnelshift_r(hi, lo, n - 32);
    rhi = __funnelshift_r(lo, hi, n - 32);
  }
  return ((uint64_t)rhi << 32) | rlo;
}

// a count above the bucket's B is B, a negative one 0: the JAX scan's mask
__device__ __forceinline__ int clamp_blocks(int nb, int nmax) {
  return nb < 0 ? 0 : (nb > nmax ? nmax : nb);
}

struct Sha512 {
  typedef uint64_t word;
  static constexpr int ROUNDS = 80;
  static constexpr int HALVES = 2;      // input arrays: hi and lo words
  static __device__ __forceinline__ word k(int i) { return K512[i]; }
  static __device__ __forceinline__ word h(int i) { return H512[i]; }
  static __device__ __forceinline__ word big0(word a) {
    return rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
  }
  static __device__ __forceinline__ word big1(word e) {
    return rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
  }
  static __device__ __forceinline__ word small0(word w) {
    return rotr64(w, 1) ^ rotr64(w, 8) ^ (w >> 7);
  }
  static __device__ __forceinline__ word small1(word w) {
    return rotr64(w, 19) ^ rotr64(w, 61) ^ (w >> 6);
  }
  // word j of a staged block: its hi half from row0, its lo half from row1
  static __device__ __forceinline__ word join(const uint32_t* row0,
                                              const uint32_t* row1, int j) {
    return ((uint64_t)row0[j] << 32) | row1[j];
  }
  static __device__ __forceinline__ void store(uint32_t* out0, uint32_t* out1,
                                               int64_t i, word x) {
    out0[i] = (uint32_t)(x >> 32);
    out1[i] = (uint32_t)x;
  }
};

struct Sha256 {
  typedef uint32_t word;
  static constexpr int ROUNDS = 64;
  static constexpr int HALVES = 1;
  static __device__ __forceinline__ word k(int i) { return K256[i]; }
  static __device__ __forceinline__ word h(int i) { return H256[i]; }
  static __device__ __forceinline__ word big0(word a) {
    return rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
  }
  static __device__ __forceinline__ word big1(word e) {
    return rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
  }
  static __device__ __forceinline__ word small0(word w) {
    return rotr32(w, 7) ^ rotr32(w, 18) ^ (w >> 3);
  }
  static __device__ __forceinline__ word small1(word w) {
    return rotr32(w, 17) ^ rotr32(w, 19) ^ (w >> 10);
  }
  static __device__ __forceinline__ word join(const uint32_t* row0,
                                              const uint32_t*, int j) {
    return row0[j];
  }
  static __device__ __forceinline__ void store(uint32_t* out0, uint32_t*,
                                               int64_t i, word x) {
    out0[i] = x;
  }
};

// One round on the working state s in place, at round r of a run of 8:
// working variable v (a = 0 .. h = 7) lives in s[(v - r) & 7], so the
// round writes only the new a (into h's slot) and the new e (d's slot),
// and every index is static once the rounds are unrolled.  kw = K + W.
template <class T>
__device__ __forceinline__ void sha_round(typename T::word* s, int r,
                                          typename T::word kw) {
  typedef typename T::word W;
  const W a = s[(0 - r) & 7], b = s[(1 - r) & 7], c = s[(2 - r) & 7];
  const W e = s[(4 - r) & 7], f = s[(5 - r) & 7], g = s[(6 - r) & 7];
  const W t1 = s[(7 - r) & 7] + T::big1(e) + ((e & f) ^ (~e & g)) + kw;
  const W t2 = T::big0(a) + ((a & b) ^ (a & c) ^ (b & c));
  s[(3 - r) & 7] += t1;
  s[(7 - r) & 7] = t1 + t2;
}

// Schedule step: W[i] for round i >= 16 into w[i & 15] (r = i & 15), from
// the 16 words before it
template <class T>
__device__ __forceinline__ void schedule_step(typename T::word* w, int r) {
  w[r & 15] += T::small1(w[(r - 2) & 15]) + w[(r - 7) & 15] +
               T::small0(w[(r - 15) & 15]);
}

// The schedule warp's chunk c: K + W of rounds 16 c .. 16 c + 15 into
// kw[r * stride], r = 0..15.  The first chunk of a block (expand false)
// takes the loaded words; each later one first advances w by 16
// schedule steps.
template <class T>
__device__ __forceinline__ void kw_chunk(typename T::word* w, int c,
                                         bool expand, typename T::word* kw,
                                         int stride) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (expand) schedule_step<T>(w, r);
    kw[r * stride] = T::k(16 * c + r) + w[r];
  }
}

// The round warp's chunk: 16 rounds reading kw[r * stride].  16 is a
// multiple of 8, so s is in its own order again after it.
template <class T>
__device__ __forceinline__ void rounds_chunk(typename T::word* s,
                                             const typename T::word* kw,
                                             int stride) {
#pragma unroll
  for (int r = 0; r < 16; ++r) sha_round<T>(s, r, kw[r * stride]);
}

#ifdef __CUDACC__

// -- the kernel ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes and no read
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Named barriers of a pair (64 threads; id 0 is __syncthreads'): the
// schedule warp arrives, the round warp waits.  A bar.arrive is preceded
// by a fence, so the words written before it are visible once the
// matching bar.sync returns.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// A pair's shared memory: K + W of two blocks (stage = block parity),
// each NCHUNK chunks of 16 rounds x 32 messages, and the staged
// block, one row of WROW words per message and input array.  Barrier
// full(st, c) = 1 + st * NCHUNK + c: chunk c of stage st written;
// empty(st) = 1 + 2 * NCHUNK + st: stage st read (12 ids for SHA-512).
template <class T>
struct __align__(16) PairSmem {
  static constexpr int NCHUNK = T::ROUNDS / 16;
  typename T::word kw[2][NCHUNK][16][32];
  uint32_t wbuf[T::HALVES][32][WROW];
  static __device__ __forceinline__ int full(int st, int c) {
    return 1 + st * NCHUNK + c;
  }
  static __device__ __forceinline__ int empty(int st) {
    return 1 + 2 * NCHUNK + st;
  }
};

// The schedule warp's copies of block b of its group into wbuf: chunk k
// = it * 32 + lane (4 a lane and input array) is quarter k & 3 of message
// k >> 2's 64 bytes; a message past its count copies zeros, unread.
template <class T>
__device__ __forceinline__ void stage_block(PairSmem<T>& sm,
                                            const uint32_t* in0,
                                            const uint32_t* in1, int64_t m0,
                                            int nmax, int nb, int b,
                                            int lane) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int j = it * 8 + (lane >> 2), q = lane & 3;
    const bool valid = b < __shfl_sync(0xffffffffu, nb, j);
    const int64_t off = valid ? ((m0 + j) * nmax + b) * 16 + q * 4 : 0;
    cp_async16(&sm.wbuf[0][j][q * 4], in0 + off, valid);
    if (T::HALVES == 2) cp_async16(&sm.wbuf[T::HALVES - 1][j][q * 4],
                                   in1 + off, valid);
  }
  cp_async_commit();
}

// a lane's staged message block (its rows of wbuf, 16-byte reads) -> w
template <class T>
__device__ __forceinline__ void load_words(const uint32_t* row0,
                                           const uint32_t* row1,
                                           typename T::word* w) {
  uint32_t r0[16], r1[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 x = reinterpret_cast<const uint4*>(row0)[q];
    const uint4 y = reinterpret_cast<const uint4*>(row1)[q];
    r0[4 * q] = x.x; r0[4 * q + 1] = x.y; r0[4 * q + 2] = x.z; r0[4 * q + 3] = x.w;
    r1[4 * q] = y.x; r1[4 * q + 1] = y.y; r1[4 * q + 2] = y.z; r1[4 * q + 3] = y.w;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = T::join(r0, r1, j);
}

// K9 / K10: one warp pair a 64-thread block, hashing 32 messages (message
// m = 32 * blockIdx.x + lane), warp 0 the schedule warp, warp 1 the round
// warp.  Both loop to the group's largest count; a lane past its own
// count (or past n) takes part in every barrier, and its blocks leave its
// state untouched.  The schedule warp writes block b into stage b & 1
// chunk by chunk, once the round warp has read block b - 2 from it; the
// chunk loops stay rolled (one chunk of code a warp, which the
// instruction cache holds for both warps).
template <class T>
__global__ void __launch_bounds__(64)
sha_pair_kernel(const uint32_t* __restrict__ in0,
                const uint32_t* __restrict__ in1,
                const int32_t* __restrict__ nblocks, int64_t n, int nmax,
                uint32_t* __restrict__ out0, uint32_t* __restrict__ out1) {
  typedef typename T::word W;
  typedef PairSmem<T> S;
  constexpr int NCHUNK = S::NCHUNK;
  __shared__ S sm;
  const int lane = threadIdx.x & 31;
  const int64_t m0 = (int64_t)blockIdx.x * 32;
  const int64_t m = m0 + lane;
  const int nb = m < n ? clamp_blocks(nblocks[m], nmax) : 0;
  const int nbmax = __reduce_max_sync(0xffffffffu, nb);
  if (threadIdx.x < 32) {
    // the schedule warp: block b + 1's copies are in flight while block
    // b's chunks are expanded
    if (nbmax > 0) stage_block(sm, in0, in1, m0, nmax, nb, 0, lane);
    for (int b = 0; b < nbmax; ++b) {
      const int st = b & 1;
      cp_async_wait_all();
      __syncwarp();
      W w[16];
      load_words<T>(sm.wbuf[0][lane], sm.wbuf[T::HALVES - 1][lane], w);
      __syncwarp();
      if (b >= 2) bar_sync(S::empty(st));
      kw_chunk<T>(w, 0, false, &sm.kw[st][0][0][lane], 32);
      __threadfence_block();
      bar_arrive(S::full(st, 0));
      if (b + 1 < nbmax) stage_block(sm, in0, in1, m0, nmax, nb, b + 1, lane);
#pragma unroll 1
      for (int c = 1; c < NCHUNK; ++c) {
        kw_chunk<T>(w, c, true, &sm.kw[st][c][0][lane], 32);
        __threadfence_block();
        bar_arrive(S::full(st, c));
      }
    }
  } else {
    // the round warp
    W s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = T::h(i);
    for (int b = 0; b < nbmax; ++b) {
      const int st = b & 1;
      W v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll 1
      for (int c = 0; c < NCHUNK; ++c) {
        bar_sync(S::full(st, c));
        rounds_chunk<T>(v, &sm.kw[st][c][0][lane], 32);
      }
      // the stage is read (its last word went into the last round)
      if (b + 2 < nbmax) bar_arrive(S::empty(st));
      if (b < nb) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += v[i];
      }
    }
    if (m < n) {
#pragma unroll
      for (int i = 0; i < 8; ++i) T::store(out0, out1, m * 8 + i, s[i]);
    }
  }
}

#endif  // __CUDACC__

}  // namespace sha2
