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
// The block arrays must be 16-byte aligned (the copies are 16 bytes); a
// launcher refuses others with cudaErrorInvalidValue.
//
// What bounds them on the H100.  At the fewest 32-bit operations sm_90
// needs (a 3-input logic function is one LOP3 per half, a 64-bit
// rotation or shift two shifts, a sum of three 64-bit terms one IADD3
// pair), a SHA-512 block is 80 rounds of 28, 64 schedule steps of 20 and
// 16 final adds: 3,536 operations against 128 bytes; a SHA-256 block
// 64 x 14 + 48 x 10 + 8 = 1,384 against 64 bytes.  At the main path's
// widths (up to 8,192 messages: at most one warp of 32 messages for each
// of the card's 528 schedulers) the card's throughput is never the
// limit.  One message's chain is: B blocks of rounds on one warp's
// instruction stream, and a scheduler issues LOP3, IADD3 and funnel
// shifts for a whole warp at most every second cycle (16 lanes), so each
// integer instruction on that stream costs two cycles.
//
// The design (sha2.cuh) takes the schedule off that stream.  A warp pair
// hashes 32 messages: the schedule warp stages each block into shared
// memory with coalesced 16-byte cp.async copies one block ahead and
// expands its schedule into KW = K + W, two stages (blocks) of 16-round
// chunks, [round][message]; the round warp reads one KW word a round and
// runs only the rounds (about 30 instructions each for SHA-512, against
// about 45 with the schedule on the same stream).  Chunks are handed over
// by named barriers (bar.arrive from the schedule warp after a fence,
// bar.sync from the round warp), a stage handed back the same way.  One
// pair a 64-thread block, so the pairs spread over every SM; the stages
// and the staged block take 46,080 bytes (SHA-512) or 18,944 (SHA-256)
// of shared memory a block.
//
// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

#include "sha2.cuh"

namespace {

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <class T>
int launch(const void* in0, const void* in1, const void* nblocks, int64_t n,
           int nmax, void* out0, void* out1, void* stream) {
  if (n == 0) return 0;
  if (!aligned16(in0) || (in1 != nullptr && !aligned16(in1)))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)((n + 31) / 32);
  sha2::sha_pair_kernel<T><<<grid, 64, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in0, (const uint32_t*)in1, (const int32_t*)nblocks, n,
      nmax, (uint32_t*)out0, (uint32_t*)out1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sha512_blocks(const void* bhi, const void* blo, const void* nblocks,
                  int64_t n, int nmax, void* ohi, void* olo, void* stream) {
  return launch<sha2::Sha512>(bhi, blo, nblocks, n, nmax, ohi, olo, stream);
}

int sha256_blocks(const void* blocks, const void* nblocks, int64_t n, int nmax,
                  void* out, void* stream) {
  return launch<sha2::Sha256>(blocks, nullptr, nblocks, n, nmax, out, nullptr,
                              stream);
}

}  // extern "C"
