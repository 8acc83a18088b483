// Kernels K9 and K10: SHA-512 and SHA-256 of pre-padded messages, with
// extern "C" launchers for ctypes (ops/_build.py).  They replace the JAX
// package's plain-jnp SHA-2 loops, which XLA compiles into one program:
//   K9  sha512_blocks <- cometbft_tpu/ops/sha2.py::sha512_blocks (:210)
//   K10 sha256_blocks <- cometbft_tpu/ops/sha2.py::sha256_blocks (:78)
//
// Interface as in the JAX package: (N, B, 16) 32-bit words of pre-padded
// messages (SHA-512's 64-bit words as separate hi and lo halves), (N,)
// block counts, (N, 8) digest words out.  Blocks past a message's count
// are not read: a count of 0 returns the initial state.  A count above B
// is taken as B, and a negative one as 0, as the JAX scan's mask does.
//
// What bounds them on the H100: 32-bit integer operations.  At the
// fewest sm_90 needs (a 3-input logic function such as ch, maj or a
// 3-way xor is one LOP3 per 32-bit half, a 64-bit rotation or shift is
// two shifts, a sum of three 64-bit terms is one IADD3 pair), a SHA-512
// round is 28 operations, a schedule step 20 and the final add 16:
// 80 x 28 + 64 x 20 + 16 = 3,536 operations against 128 bytes read.  A
// SHA-256 block is 64 x 14 + 48 x 10 + 8 = 1,384 against 64 bytes.  The
// design is the simple one: one thread per message, the state and the
// 16-word schedule in registers, the rounds unrolled so that every
// schedule index is static.  Vote sign-bytes of one window take the same
// number of blocks, so a warp seldom diverges.  Neighbouring threads read
// words B * 64 bytes apart; each line is reused from L1 by the thread's
// next loads, and the bytes are small next to the operations.
//
// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#define SHA_THREADS 128

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

// 64-bit rotation right by a constant n (1..63) as two funnel shifts on
// the 32-bit halves
__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32), rlo, rhi;
  if (n < 32) {
    rlo = __funnelshift_r(lo, hi, n);
    rhi = __funnelshift_r(hi, lo, n);
  } else {
    rlo = __funnelshift_r(hi, lo, n - 32);
    rhi = __funnelshift_r(lo, hi, n - 32);
  }
  return ((uint64_t)rhi << 32) | rlo;
}

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ int clamp_blocks(int nb, int nmax) {
  return nb < 0 ? 0 : (nb > nmax ? nmax : nb);
}

__global__ void __launch_bounds__(SHA_THREADS)
sha512_kernel(const uint32_t* __restrict__ bhi, const uint32_t* __restrict__ blo,
              const int32_t* __restrict__ nblocks, int64_t n, int nmax,
              uint32_t* __restrict__ ohi, uint32_t* __restrict__ olo) {
  const int64_t m = (int64_t)blockIdx.x * SHA_THREADS + threadIdx.x;
  if (m >= n) return;
  const int nb = clamp_blocks(nblocks[m], nmax);
  uint64_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = H512[i];
  for (int blk = 0; blk < nb; ++blk) {
    const uint32_t* ph = bhi + (m * nmax + blk) * 16;
    const uint32_t* pl = blo + (m * nmax + blk) * 16;
    uint64_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = ((uint64_t)ph[j] << 32) | pl[j];
    uint64_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint64_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int i = 0; i < 80; ++i) {
      if (i >= 16) {
        const uint64_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
        const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        w[i & 15] += s0 + w[(i - 7) & 15] + s1;
      }
      const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      const uint64_t ch = (e & f) ^ (~e & g);
      const uint64_t t1 = h + S1 + ch + K512[i] + w[i & 15];
      const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint64_t t2 = S0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d;
    s[4] += e; s[5] += f; s[6] += g; s[7] += h;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ohi[m * 8 + i] = (uint32_t)(s[i] >> 32);
    olo[m * 8 + i] = (uint32_t)s[i];
  }
}

__global__ void __launch_bounds__(SHA_THREADS)
sha256_kernel(const uint32_t* __restrict__ blocks,
              const int32_t* __restrict__ nblocks, int64_t n, int nmax,
              uint32_t* __restrict__ out) {
  const int64_t m = (int64_t)blockIdx.x * SHA_THREADS + threadIdx.x;
  if (m >= n) return;
  const int nb = clamp_blocks(nblocks[m], nmax);
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = H256[i];
  for (int blk = 0; blk < nb; ++blk) {
    const uint32_t* p = blocks + (m * nmax + blk) * 16;
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = p[j];
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (i >= 16) {
        const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
        const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
        w[i & 15] += s0 + w[(i - 7) & 15] + s1;
      }
      const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = h + S1 + ch + K256[i] + w[i & 15];
      const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint32_t t2 = S0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d;
    s[4] += e; s[5] += f; s[6] += g; s[7] += h;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[m * 8 + i] = s[i];
}

extern "C" {

int sha512_blocks(const void* bhi, const void* blo, const void* nblocks,
                  int64_t n, int nmax, void* ohi, void* olo, void* stream) {
  if (n == 0) return 0;
  int grid = (int)((n + SHA_THREADS - 1) / SHA_THREADS);
  sha512_kernel<<<grid, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bhi, (const uint32_t*)blo, (const int32_t*)nblocks, n,
      nmax, (uint32_t*)ohi, (uint32_t*)olo);
  return (int)cudaGetLastError();
}

int sha256_blocks(const void* blocks, const void* nblocks, int64_t n, int nmax,
                  void* out, void* stream) {
  if (n == 0) return 0;
  int grid = (int)((n + SHA_THREADS - 1) / SHA_THREADS);
  sha256_kernel<<<grid, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const int32_t*)nblocks, n, nmax,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
