#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's commit-verification paths on one NVIDIA
card (Ed25519 in each of its MSM engine configurations, the device-hash
route, secp256k1 and mixed-key commits, the verify pipeline, the
consensus vote stream, the light client, block sync, the light-client
serving plane, consensus among live validators, and full nodes over the
p2p stack), and hold each
of its CUDA kernels against its plain torch version.  Every per-signature
localization of an Ed25519 reject (ops/ed25519.verify_kernel) must launch
exactly one K1 and one K14, on one device over the live signatures.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero and prints no
result):
  1. build   compile ops/csrc/*.cu with nvcc (one nvcc per source, in
             parallel), print the card's name and power limit, and
             report each kernel's registers, shared memory, stack and
             spills (ptxas -v) and each library's build seconds and
             load ms; K9-K14 must show neither a stack nor spills;
  2. commit  one 150-validator commit through verify_commit_light on the
             card: accept, one tampered signature (ErrInvalidSignature
             naming its index; one localization over its 101
             signatures), a commit below +2/3.  That localization is the
             process's first: its ms, its torch.cat and K1's and K14's
             calls, and the same localization again, apart
             (`first_localization`);
  3. window  a blocksync window — 48 heights x 150 validators collected
             with DeferredSigBatch — three times with one validator set
             (whole program, then the cached-A program once the
             ATableCache holds the set's tables), then a window with one
             bad signature at a known height (one localization, over its
             4,848 signatures);
  4. batch   8,192 signatures under distinct keys through
             create_batch_verifier("ed25519", device="cuda"): clean, then
             with an s >= L signature, non-canonical-y keys and a tampered
             signature (one localization over the 8,192), every verdict
             held against the pure-Python ed25519_ref.verify;
  5. mesh    the multi-device path on device lists [cuda:(i % cards)
             for i in range(n)] (n logical shards on one card): K8
             (ops/msm_shard.rlc_verify_sharded) on the window's and the
             batch's packed inputs at n = 1, 2, 4, clean and tampered,
             each call launching exactly 2n K1, 2n K2, 2n K3 and one
             K4, its verdict equal to the unsharded program's; the
             4,848-signature window split over 2 and 4 devices
             (crypto/mesh.split_rlc_verify: only the bad height's chunk
             rejects), then localized by the per-signature program split
             over them (verify_batch_mesh: n K1 and n K14), and the
             hostile 8,192 batch the same way against the unsharded
             verify_kernel; a placed
             cached-A call made twice, the second hitting its device's
             entry; K8's gathered partials on the window's R side at
             n = 4 against the same function over four "cpu" shards;
  6. hash    the device-hash path (SHA-512 on K9, hash-to-scalar in torch
             ops, then K1-K4): the commit's, the window's (clean and with
             the bad signature) and the batch's (clean and hostile)
             signatures through crypto/batch._device_verify_hash and
             rlc_verify_hash, every verdict the host-hash route's and
             ed25519_ref.verify's, the bad signature localized by
             verify_hash_kernel, each RLC call launching one K9 beside the
             K1-K4 of the host-hash program at the same widths and each
             localization one K9, one K1 and one K14 over its live
             signatures; a message over
             DEVICE_HASH_MAX_BLOCKS raising ValueError; a 10,000-validator
             ValidatorSet.hash() equal to the host Merkle root with one
             K10 launch (and, outside the count, its time split by stage:
             leaf encoding, padding, copy to the card, K10, copy back,
             the host's inner tree), and sum_sha256_many of 511
             messages with none;
             the host packing time of pack_rlc_device_hash beside
             parse_and_hash + pack_rlc, and each route's time (printed,
             nothing claimed);
  7. secp    secp256k1 on the card (crypto/secp256k1.py, K11-K13): a
             150-validator all-secp256k1 commit through
             verify_commit_light (accept; one bad signature named by
             index), a 48-commit window through DeferredSigBatch (101
             signatures a commit over all 150 keys, K = 192) twice, the
             second a QTableCache hit, and with one bad signature named
             by height; bench.py's 4,096-signature batch over 128 keys,
             clean and with r = 0, s >= n, high s, a key that fails to
             decompress, a tampered message and r + n < p, on the MSM
             program and on the ladder (COMETBFT_TPU_SECP_MSM=0);
             bench.py's mixed commit, 9,000 ed25519 + 1,000 secp256k1
             signatures (one bad of each) through MixedBatchVerifier; the
             hostile batch split over two devices.  Each call's launches
             are exact (one K12 a MSM call, K11 on a key-table miss only,
             one K13 a ladder call; the mixed commit's ed25519 part the
             whole RLC program, 2 K1, 2 K2, 2 K3 and 1 K4, and one K1
             and one K14 over its 9,000 for its localization); every
             verdict is _verify_py's
             (ed25519: ed25519_ref.verify's).  Outside the count: the
             host waits inside verify_msm_async (none allowed), the
             split's launch-before-read order, the host packing time;
  8. sr25519 sr25519 on the Edwards kernels (crypto/sr25519.py: ristretto
             decode, Merlin challenge and Edwards re-encoding on the host,
             then K1-K4, and K1 + K14 for each localization): a
             150-validator sr25519 commit through verify_commit_light
             (accept: phase 2's whole RLC program; one bad signature:
             one more K1 and K14, over its 101), a 48-commit window
             through DeferredSigBatch (4,848 signatures over 101 keys) as
             its A table is built and on its table hit, with its host
             stages timed (collect, ristretto decode, Merlin challenge,
             Edwards compress, pack_rlc, the device program), and with one
             bad signature named by height; BASELINE's mixed commit (50
             ed25519, 50 secp256k1 and 50 sr25519 keys) through
             verify_commit, accepted and with one bad signature of each
             type; MixedBatchVerifier over phase 7's mixed items plus 1,000
             sr25519 signatures over 128 keys, one bad of each type,
             launching exactly its three sub-batches' kernels.  Every
             verdict is the host oracle's (CpuSr25519BatchVerifier, in the
             pool);
  9. sigcache the verdict cache on: the ed25519 and sr25519 commits each
             verified twice (the second launches nothing), the tampered
             commit twice (the second raises the same error with no
             launch), a 48-commit window of which 24 commits were
             verified before (only the 2,424 misses reach the card), and
             the window re-verified with every triple a hit (signatures
             per second, as bench.py's bench_commit_reverify); the cache
             is off again after it, as every other phase runs;
 10. pipeline crypto/dispatch.VerifyPipeline, its kernels launched from its
             dispatch threads: eight blocksync windows serial
             (DeferredSigBatch.verify) and pipelined (verify_async,
             depth 2, the machine's host pool), sigs/s both ways, each
             window's latency (the latency ledger), the dispatch
             thread's busy share and idle causes (devprof), exactly eight
             serial windows' K1-K4 and no K14; the eight with a bad
             fifth (its error and one K1 + K14 over the live lanes); two
             windows on the device-hash route (K9); the three-type commit
             with its secp256k1 sub-batch over the crossover as one mixed
             window, on the MSM program (K11, K12) and on the ladder
             (K13); a consensus window dispatched ahead of
             six queued blocksync windows; an injected fault (drain,
             SUSPECT), a hang past a 1 s deadline (host resolve,
             QUARANTINED, the known-answer probe on the card, HEALTHY);
             a cached window (path "cache", no launch); two logical
             shards (in-order publication, exact launches per window).
             Outside the fault steps every window resolves on the device;
 11. votes   the consensus vote path: crypto/votestream's StreamingVerifier
             on the pipeline's consensus lane, its verdicts consumed by
             types/vote_set.VoteSet (the exact-triple Preverified
             contract), as the consensus reactor does, with the verdict
             cache on: four peers gossip the 300 votes of one height (a
             prevote and a precommit of each of 150 validators, one
             tampered) into one window (one RLC program, one K1 + K14
             over its 300 lanes, 900 submissions coalesced or cached,
             every verdict ed25519_ref.verify's, the tampered precommit
             rejected, the other 299 accepted with no verify of add_vote's
             own, +2/3 precommits); make_commit() re-verified at the next
             height with no launch; an equivocation raising
             ErrVoteConflictingVotes and its DuplicateVoteEvidence
             verified with no launch; one peer's votes behind six queued
             blocksync windows (the seal advisory submits the first vote
             window within 0.4 s, the consensus windows dispatch ahead,
             launches exact, the latency ledger's p50 / p99); the same
             votes paced through default_verifier at the default knobs
             (flushes by path, per-vote p50 / p99); the host verify's time
             a vote against a device window's at 1-300 votes (the
             crossover, reported);
 12. light   the light client (light/client.py) over 150 validators and
             heights 1-193 (BASELINE's 10,000-header sync cut to 193; 60
             of the root's validators replaced at height 66 and 60 more
             at 130, so 30 remain at 193, under the 1/3 trust level),
             signed in the pool: sequential sync 1 -> 193 in four
             48-header windows on a VerifyPipeline of depth 2 (one RLC
             program a window, the latency ledger's stages a window),
             the same serial in one 192-header window, skipping sync
             (the bisection's hops, two RLC programs a verified hop, none
             for a hop refused on trust), backwards 193 -> 100 (no
             launch), a tampered signature at height 150 (the error names
             it; one K1 + K14 over the window's 4,848 lanes; the store
             holds the root alone) and a witness serving a lunatic fork
             from height 191 (ErrLightClientAttack, common height 190,
             150 byzantine validators, each side sent the other's
             evidence); headers/s for the three forward syncs;
 13. blocksync block sync (blocksync/reactor.py) of a kvstore chain of 193
             heights over the 150 validators (BASELINE's 100k blocks x
             10k validators cut to 193 x 150; a kvstore `val:` transaction
             at 79 adds a 151st validator, the set changes at 81), built
             by the port's BlockExecutor and signed in the pool, each
             step a fresh node syncing 192 blocks from serving reactors
             over an in-process loopback double (every message as wire
             bytes), its BlockExecutor applying them to a kvstore app and
             its BlockStore storing them, with the verdict cache on (as a
             node runs): serial (pipeline_depth 1) and pipelined (depth
             2, the pipeline's blocksync lane), each window one RLC
             program (VERIFY_WINDOW 48 quantizes to 32 blocks) and each
             applied block's verify_commit one more (its 49-50 cache
             misses), exact per window and per block; the latency
             ledger's windows by stage, devprof's busy share, pipelined
             / serial; a lying peer serving a LastCommit with one flipped
             signature (its window fails, one K1 + K14 over the window's
             1,616 live lanes, the tampered height blamed, the liar
             stopped, the sync finished by two honest peers); the window
             cut at the validator-set change; every step's app hash and
             stored blocks the source's;
 14. lightserve the light-client serving plane (lightserve/,
             simnet/lightfleet.py) over phase 13's source chain, read
             only: DeferredSigBatch's threshold at 1, a seeded fleet of
             1,000 clients (16 workers) through fleet_ab, coalescing off
             then on: every client served, identical digests, fewer
             windows and signatures on; every window one RLC program and
             each of the 5% of clients that verify their bytes on the
             card one, exactly; a read-only store double forging height
             100's commit under 200 clients to height 102: exactly the
             clients whose path holds 100 fail, each window holding it
             localized by one K1 + K14 and counted once; the default
             knobs (cache on, 300 clients): windows on the card and on
             the host;
 15. consensus 11 in-process validators, each a full port node
             (ConsensusState, ConsensusReactor, CListMempool,
             EvidencePool, FilePV, EventBus, a BlockExecutor over a
             kvstore app, a WAL) over the loopback double, at CometBFT's
             default timeouts: with the cache off and the vote stream's
             device threshold 1, 2,000 transactions committed once each
             by height 20 with the same blocks on every node, every
             LastCommit check one RLC program and every vote window one
             (or K1 + K14 for a window of one vote), launches exact; a
             tampered vote's window localized by one K1 + K14 and the
             vote not added; node 0's WAL ending every height; the same
             network at the default knobs (cache on, 256); an
             equivocating validator's evidence committed;
 16. p2p     the p2p stack (SecretConnection, MConnection, the
             transport and the Switch) over TCP on 127.0.0.1: four
             validators and a non-validator, each a full node with the
             consensus, mempool, evidence and blocksync reactors, at
             CometBFT's default timeouts, the cache off and the
             thresholds 1: 200 transactions into one mempool, gossiped
             and committed once each past height 8 with the same blocks
             everywhere; the fifth node catching up by block sync over
             TCP; an equivocating validator's evidence gossiped and
             committed; every LastCommit check, block-sync window and
             vote window one RLC program (K1 + K14 for a window of one
             vote), exactly; bytes by channel, frames, handshake ms;
 17. engines the same entry points under each MSM engine configuration
             (the JAX package's flags, set on the port's modules):
             window_loop (K6), window_loop_blk2048 (K6 under
             COMETBFT_TPU_PALLAS_BLK=2048: 1, 8 and 16 rows per output
             lane at the commit's, the window's and the batch's widths),
             grouped_g4 and grouped_g13 (K5), select_tree (K7 in the
             window scan, no fold kernel) and fold_off (K3, no fold
             kernel) — the commit (accept and the tampered signature),
             the window (accept and the bad height), and for the two
             window_loop configurations and grouped_g4 the clean 8,192
             batch, each verdict the default engine's; each must launch
             exactly its configuration's kernels (and K1 + K14 for each
             localization);
 18. kernels each kernel vs its plain version on the card, at the shapes
             phases 2-4 gave it, and K1-K4 and K14 also at the shapes
             of phase 8's sr25519 packs and phase 15's programs and
             localizations that those lack (the mixed
             commit's and the mixed batch's: N = 64 and 1,024, K14 at 50
             and 1,000 live lanes) (exact integer equality; K1 at the four
             main-path widths and on hostile encodings, K1 and K2 also at
             the ragged widths 1, 7 and 129; K3 also at the commit's two
             sides and on a 32-lane slice, where its Horner chain is all
             the work; K6 and K7 also at blocks of 1,024 and 2,048 lanes,
             8 and 16 rows per output lane, on the batch's sides), K5 and
             K6 also vs K3 (projectively), and K3, K5, K6, K7
             on digits with magnitudes outside 0..16; K4's verdict also
             on partial sets made on the card from the seed: sums of
             identity at 2 to 4,608 partials, each also with one limb
             changed, and two with an 8-torsion component; K9 at the
             hash phase's four widths (128, 5,120, 8,192 and the 4,848
             of the window's localization) and K9 / K10 at their padding
             boundaries, with rows whose block count is 0, and at the
             warp-pair cases (the chain of 32 messages, one pair; 33
             messages, a partial second pair; one message; one group
             of 32 whose counts run 0..B), word for word and against
             hashlib; K10 at the 10,000 validator leaves;
             K11 at K = 4, 128 and 192, at canonical value (it stores
             frozen tables, its plain version weak ones); K12 at the
             commit's, window's and batch's packs, at the commit's with r
             moved into the r + n slot (accepted with rn_valid set,
             rejected without) and at a 16,384-lane pack over 192 keys
             with a third of its lanes corrupted in s, r, a digit or the
             key slot (_wide_pack), and K13 at the hostile batch, at
             the edges of its exact additions (doubling, cancelling,
             infinity, nibbles outside 0..15), at sums with Z = 0 off
             infinity (X = 0 and X != 0; r and r + n = 0, and weak
             zeros) and at a 16,384-lane pack of the same signatures
             with a third of its lanes corrupted (s, r, a nibble, the
             key) and r + n lanes (_wide_ladder), verdict for verdict
             and against the host; K14 at the tampered commit's, the
             bad window's and the hostile batch's packs (their buckets,
             256, 16,384 and 16,384 lanes, and their live widths, 101,
             4,848 and 8,192), at 32 edge lanes in two buckets of 16
             (_persig_edges: decompression failures, the identity key,
             the 8 small-order points as A and as R, torsion in R, s =
             L - 1, nibbles all 0 and all 15) and at 16,384 real
             signatures with a third corrupted (s, R, a nibble of h, the
             key; and its first 4,096 lanes), verdict for verdict and
             accumulator for accumulator (frozen, coordinate for
             coordinate), and against ed25519_ref;
 19. timing  each kernel's median time over runs of 10 launches back to
             back and each plain version's time for one call (CUDA
             events; the kernels phase's comparison warmed it), with
             the bound the card could reach for the same
             work; for K9-K13 also their time launched through the C
             function into preallocated outputs (raw_ms, no wrapper;
             K14 too, at each of its cases, with its bound also at the
             20 x 13-bit price of its design before), K11's
             walk and rows apart (raw_walk_ms, raw_rows_ms), for K9 and
             K10 hashlib's time on the host for the same messages and
             the chain case's raw time and bound (the design's floor
             for one message).
The launch counters are reset before phase 2 and read after phase 4
(the default engine: every one of K1-K4 and K14 must launch there, none
of K5-K8), reset before and read after phase 5's path (its comparisons
with the plain version excluded), and reset before and read after each
configuration of phase 17, reset before and read after phase 6's path
(its host-hash comparisons excluded), reset before and read after
phase 7's path (its host-wait and order checks excluded), reset before
and read after phases 8 and 9 (their oracle checks excluded), and reset
before and read after phase 10 (its serial references and oracles
excluded), reset after phase 11's first pre-warm and read after its
third step, reset before and read after each step of phases 12, 13 and
14, reset before and read after phase 15's first network (the default
knobs' network is counted apart) and phase 16's network.  The
signature-verdict cache is off in every phase but 9, phase 10's cache
step, phases 11 and 13 and the default-knob steps of phases 14 and 15.
Keys and messages come from a fixed seed; the RLC weights are drawn from
`secrets`, as they are in use.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
CHAIN_ID = "chip-smoke-chain"
N_VALS = 150
WINDOW = 48                    # blocksync VERIFY_WINDOW
N_BATCH = 8192
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_LANES_PER_SM_CLK = 64    # Hopper white paper
CSRC = "cometbft_tpu_torch/ops/csrc/"

# kernel -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "ed25519_decompress": ("ed25519_kernels.cu",
                           "cometbft_tpu/ops/pallas_decompress.py:143"),
    "ed25519_table17_neg": ("ed25519_kernels.cu",
                            "cometbft_tpu/ops/pallas_msm.py:417"),
    "ed25519_msm_window_major": ("ed25519_kernels.cu",
                                 "cometbft_tpu/ops/pallas_msm.py:498"),
    "ed25519_fold_verify": ("ed25519_kernels.cu",
                            "cometbft_tpu/ops/pallas_msm.py:730"),
    "ed25519_msm_window_major_grouped": ("ed25519_engines.cu",
                                         "cometbft_tpu/ops/pallas_msm.py:624"),
    "ed25519_msm_window_loop": ("ed25519_engines.cu",
                                "cometbft_tpu/ops/pallas_msm.py:317"),
    "ed25519_select_tree": ("ed25519_engines.cu",
                            "cometbft_tpu/ops/pallas_msm.py:360"),
    "sha512_blocks": ("sha2_kernels.cu", "cometbft_tpu/ops/sha2.py:210"),
    "sha256_blocks": ("sha2_kernels.cu", "cometbft_tpu/ops/sha2.py:78"),
    "secp_q_tables": ("secp256k1_kernels.cu",
                      "cometbft_tpu/ops/secp256k1.py:327"),
    "secp_msm_verify": ("secp256k1_kernels.cu",
                        "cometbft_tpu/ops/secp256k1.py:360"),
    "secp_ladder": ("secp256k1_kernels.cu",
                    "cometbft_tpu/ops/secp256k1.py:186"),
    "ed25519_verify_ladder": ("ed25519_persig.cu",
                              "cometbft_tpu/ops/ed25519.py:238"),
}
DEFAULT_KERNELS = {"ed25519_decompress", "ed25519_table17_neg",
                   "ed25519_msm_window_major", "ed25519_fold_verify",
                   "ed25519_verify_ladder"}
# what one per-signature localization (ops/ed25519.verify_kernel) launches
PERSIG_LAUNCHES = {"ed25519_decompress": 1, "ed25519_verify_ladder": 1}
# K8 runs K1-K4 per shard; its two entry points count their own calls
K8 = ("ed25519_sharded_msm", "ed25519_rlc_verify_sharded")
HASH_KERNELS = {"sha512_blocks", "sha256_blocks"}
SECP_KERNELS = ("secp_q_tables", "secp_msm_verify", "secp_ladder")
SECP_COMMIT_HEIGHT = 7
SECP_BATCH = 4096              # bench.py's bench_secp fixture
SECP_KEYS = 128                # keys of each type, reused as bench.py does
MIXED_ED, MIXED_SECP = 9000, 1000   # bench.py's bench_mixed fixture
# the mixed commit's ed25519 part, one bad signature among 9,000 keys
# the A-table cache has not seen: the whole RLC program (K1 and K2 on
# the A and R sides, K3 on each side, one K4), then the per-signature
# localization's one K1 over A || R and one K14
MIXED_ED_LAUNCHES = {"ed25519_decompress": 3, "ed25519_table17_neg": 2,
                     "ed25519_msm_window_major": 2, "ed25519_fold_verify": 1,
                     "ed25519_verify_ladder": 1}
SECP_ABSENT = N_VALS - (2 * N_VALS // 3 + 1)   # 49 absent of each window commit
# signatures verify_commit_light collects from a 150-validator commit
# (it stops past +2/3): the live width of the commit's localization, and
# WINDOW times it the window's
COMMIT_SIGS = 2 * N_VALS // 3 + 1
WIDE_LANES, WIDE_KEYS = 16384, 192   # K12's corrupted wide pack
SR_COMMIT_HEIGHT = 9
SR_WINDOW_BASE = 3000          # the sr25519 window's first height
SR_MIXED_HEIGHT = 11           # BASELINE's mixed commit
SR_MIXED_KEYS = 50             # keys of each type in the mixed commit
# secp256k1 signatures added to the pipeline's mixed window, so that its
# secp256k1 sub-batch (SR_MIXED_KEYS + this) is over the device crossover
PIPE_SECP_EXTRA = 64
MIXED_SR = 1000                # sr25519 signatures beside bench.py's mixed
# one RLC program on the default engine: the whole program (or the
# A-table build and the cached-A program: the same launches), and the
# cached-A program on an A-table hit
RLC_WHOLE = {"ed25519_decompress": 2, "ed25519_table17_neg": 2,
             "ed25519_msm_window_major": 2, "ed25519_fold_verify": 1}
RLC_HIT = {"ed25519_decompress": 1, "ed25519_table17_neg": 1,
           "ed25519_msm_window_major": 2, "ed25519_fold_verify": 1}
N_VALSET = 10_000              # ValidatorSet.hash(): upstream's largest sets
MESH_SHARDS = (1, 2, 4)
NVLINK_BYTES_PER_S = 450e9     # one direction, H100 SXM data sheet

# the engine flags (ops/ed25519 USE_PALLAS_*, ops/cuda_msm WIN_GROUP, BLK) at
# the JAX package's defaults, and each configuration of phase 17: its
# flags, the kernels it must launch (and no other), whether it also runs
# the 8,192 batch
DEFAULT_ENGINE = {"USE_PALLAS_MSM_MAJOR": True, "USE_PALLAS_MSM_LOOP": True,
                  "USE_PALLAS_TREE": False, "USE_PALLAS_FOLD": True,
                  "WIN_GROUP": 1, "BLK": 512}
# every configuration: K1 and K2 of the RLC program, K14 of each
# localization
_SHARED = {"ed25519_decompress", "ed25519_table17_neg",
           "ed25519_verify_ladder"}
ENGINES = [
    ("window_loop", {"USE_PALLAS_MSM_MAJOR": False},
     _SHARED | {"ed25519_msm_window_loop", "ed25519_fold_verify"}, True),
    ("window_loop_blk2048", {"USE_PALLAS_MSM_MAJOR": False, "BLK": 2048},
     _SHARED | {"ed25519_msm_window_loop", "ed25519_fold_verify"}, True),
    ("grouped_g4", {"WIN_GROUP": 4},
     _SHARED | {"ed25519_msm_window_major_grouped", "ed25519_fold_verify"},
     True),
    ("grouped_g13", {"WIN_GROUP": 13},
     _SHARED | {"ed25519_msm_window_major_grouped", "ed25519_fold_verify"},
     False),
    ("select_tree", {"USE_PALLAS_MSM_MAJOR": False,
                     "USE_PALLAS_MSM_LOOP": False, "USE_PALLAS_TREE": True},
     _SHARED | {"ed25519_select_tree"}, False),
    ("fold_off", {"USE_PALLAS_FOLD": False},
     _SHARED | {"ed25519_msm_window_major"}, False),
]

# field products per kernel step, as int32 multiply-adds (mul 400,
# squaring 210); used for the operation bound
MUL, SQR = 400, 210
DBL_T, DBL = 4 * MUL + 4 * SQR, 3 * MUL + 4 * SQR
ADD = MUL + 8 * MUL                  # to_cached + add_cached
DECOMPRESS = 255 * SQR + 19 * MUL    # y^2, v^2, v3^2, 251 in pow_p58, r^2
TABLE = MUL + 15 * 8 * MUL
# The fewest 32-bit operations a block of K9 and K10 needs on sm_90:
# any 3-input logic function (ch, maj, a 3-way xor) is one LOP3 per
# 32-bit half, a 64-bit rotation two funnel shifts, a 64-bit shift two
# shifts, and a sum of three 64-bit terms one IADD3 pair (two carry
# predicates), so a 64-bit add of k terms is 2 * ceil((k - 1) / 2).
# SHA-512 round 28: Sigma1 and Sigma0 8 each (6 shifts + 2 LOP3),
# ch 2, maj 2, t1 = h + Sigma1 + ch + K + W 4, a = t1 + Sigma0 + maj 2,
# e = d + t1 2.  Schedule step 20: sigma0 and sigma1 8 each (4 shifts +
# 2 shifts + 2 LOP3), W = sigma1 + W7 + sigma0 + W16 4.  Final adds 16.
# SHA-256 is the same on one 32-bit word: round 14 (4 + 4 + 1 + 1 + 2 +
# 1 + 1), schedule step 10 (4 + 4 + 2), final adds 8.
SHA512_BLOCK_OPS = 80 * 28 + 64 * 20 + 8 * 2        # 3,536
SHA256_BLOCK_OPS = 64 * 14 + 48 * 10 + 8            # 1,384
# secp256k1 (K11-K13): field products only, each priced at the cheapest
# 256-bit product on sm_90, an 8 x 8 schoolbook of 32-bit limbs with
# IMAD.WIDE.U32 (64 multiply-adds; a squaring 36: 8 squares and 28 cross
# products, doubled by a shift), plus the fold of the high half through
# 2^256 = 2^32 + 977 (8 multiply-adds by 977, 2 for the carry word's
# second fold).  Not the 22 x 22 = 484 of the kernels' 12-bit layout.
M256, S256 = 64 + 10, 36 + 10
JDBL = 2 * M256 + 5 * S256           # dbl-2009-l (a = 0)
JADD = 11 * M256 + 5 * S256          # add-2007-bl
JMADD = 7 * M256 + 4 * S256          # madd-2007-bl (Z2 = 1)
# per key: 52 windows of 5 doublings, then a doubling and 15 adds each
K11_KEY = 52 * 5 * JDBL + 52 * (JDBL + 15 * JADD)
# per signature: 32 mixed adds from the G table and the 2^256 G
# correction, 52 adds from the key's table and the 2^260 Q and -S
# corrections, the epilogue's Z^2, r Z^2 and (r + n) Z^2
K12_SIG = 33 * JMADD + 54 * JADD + S256 + 2 * M256
# K14 per signature, in Ed25519 field products and squarings: the -A
# table (its cached form, 14 cached adds, 14 row conversions; row 0 is
# constant), 64 windows of 3 doublings without T, one with T and 2 cached
# adds, then to_cached(-R), a cached add and 3 cofactor doublings:
# 2,001 and 1,036.  Priced on the native field K14 runs on (an 8 x 8
# schoolbook and the fold, M256 and S256: 195,730 a signature) and, as
# the yardstick of its 20 x 13-bit design before, at MUL and SQR
# (1,017,960)
PERSIG_MULS = 1 + 14 * 8 + 14 + 64 * (3 * 3 + 4 + 16) + 1 + 8 + 3 * 3
PERSIG_SQRS = 64 * (3 * 4 + 4) + 3 * 4
PERSIG_SIG = PERSIG_MULS * M256 + PERSIG_SQRS * S256
PERSIG_SIG_13 = PERSIG_MULS * MUL + PERSIG_SQRS * SQR
# per signature: the 16-row Q table (a doubling, 13 adds), 64 windows of
# 4 doublings and 2 adds, the epilogue's Z^2, r Z^2 and (r + n) Z^2 (no
# inversion: X == r Z^2, as K12 decides it)
K13_SIG = JDBL + 13 * JADD + 64 * (4 * JDBL + 2 * JADD) + S256 + 2 * M256


# -- host fixtures (pure Python, several processes) --------------------------

def _pubkeys(seeds):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    return [ref.pubkey_from_seed(s) for s in seeds]


def _sign(jobs):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    return [ref.sign(seed, msg) for seed, msg in jobs]


def _verify(jobs):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    return [ref.verify(pk, msg, sig) for pk, msg, sig in jobs]


def _chunks(xs, n):
    k = max(1, -(-len(xs) // n))
    return [xs[i:i + k] for i in range(0, len(xs), k)]


def _pool_map(pool, fn, items):
    out = []
    for part in pool.map(fn, _chunks(items, 4 * (os.cpu_count() or 1))):
        out.extend(part)
    return out


def _seed(*parts) -> bytes:
    return hashlib.sha256(repr((SEED,) + parts).encode()).digest()


# -- output -------------------------------------------------------------------

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(Exception):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "cometbft_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: the cometbft_tpu_torch package is not next to "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import multiprocessing as mp

    from cometbft_tpu_torch.crypto import sigcache

    # every phase but `sigcache` runs its programs with the verdict cache
    # off: a cached triple would skip the launches each phase checks
    sigcache.set_enabled(False)
    torch.cuda.set_device(0)
    state = {}
    phases = [phase_build, phase_fixtures, phase_commit, phase_window,
              phase_batch, phase_mesh, phase_hash, phase_secp, phase_sr25519,
              phase_sigcache, phase_pipeline, phase_votes, phase_light,
              phase_blocksync, phase_lightserve, phase_consensus, phase_p2p,
              phase_engines, phase_kernels, phase_timing]
    ctx = mp.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 1) as pool:
        state["pool"] = pool
        for ph in phases:
            name = ph.__name__[len("phase_"):]
            t0 = time.perf_counter()
            try:
                rec = ph(state, torch) or {}
            except Exception as e:                      # noqa: BLE001
                traceback.print_exc()
                emit({"phase": name, "ok": False,
                      "error": f"{type(e).__name__}: {e}"})
                return 1
            emit({"phase": name, "ok": True,
                  "seconds": time.perf_counter() - t0, **rec})
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit({"kernels": state["kernel_rows"]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# -- phase 1 -----------------------------------------------------------------

def phase_build(state, torch):
    from cometbft_tpu_torch.ops import _build

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build(sources)
    build_s = time.perf_counter() - t0
    load_ms = {}
    for name in sources:
        t1 = time.perf_counter()
        _build.load(name)
        load_ms[name] = (time.perf_counter() - t1) * 1e3
    ptxas = {}
    for name in sources:
        ptxas.update(_ptxas(_build.build_info[name]["log"]))
    clock = nvidia_smi("clocks.max.sm").split()[0]
    state["sm_clock_hz"] = float(clock) * 1e6
    state["card"] = card
    state["ptxas"] = ptxas
    # K9-K14 keep their operands in registers: no spill, no stack (K11
    # has two entry functions, K12 two and its out-of-line products)
    for kernel, entries in (("secp_q_tables", 2), ("secp_msm_verify", 2),
                            ("secp_ladder", 1), ("ed25519_verify_ladder", 1),
                            ("sha512_blocks", 1), ("sha256_blocks", 1)):
        found = _ptxas_of(state, kernel)
        check(len(found) >= entries and all(
            v.get(k, 0) == 0 for v in found.values()
            for k in ("stack_frame", "spill_stores", "spill_loads")),
            f"{kernel}: ptxas reports a stack or spills: {found}")
    return {"card": card, "build_seconds": build_s,
            "build_seconds_by_source": {
                n: _build.build_info[n]["seconds"] for n in sources},
            "load_ms": load_ms, "sources": sources,
            "max_sm_clock_mhz": float(clock),
            "k14_ptxas": _ptxas_of(state, "ed25519_verify_ladder"),
            "k9_k10_ptxas": {name: _ptxas_of(state, name)
                             for name in sorted(HASH_KERNELS)},
            "ptxas": ptxas}


def _ptxas(log: str) -> dict:
    """{kernel or device function: {"registers", "smem_bytes",
    "stack_frame", "spill_stores", "spill_loads"}} from nvcc -Xptxas -v
    output (a kernel's name led by its identifier, a device function's
    mangled name as it is)."""
    import re

    def name(mangled):
        m = re.match(r"_Z(\d+)", mangled)
        if not m:
            return mangled
        ident = mangled[m.end():m.end() + int(m.group(1))]
        return f"{ident} ({mangled})"

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            out[cur].update(stack_frame=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            if m:
                out[cur]["smem_bytes"] = int(m.group(1))
    return {name(k): v for k, v in out.items()}


# -- fixtures ------------------------------------------------------------------

def phase_fixtures(state, torch):
    """Keys and signatures for phases 2-4, signed in several processes;
    the seconds spent here are reported apart from every verify rate."""
    import numpy as np
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.types import block, canonical
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    pool = state["pool"]
    t0 = time.perf_counter()
    val_seeds = [_seed("validator", i) for i in range(N_VALS)]
    val_pubs = _pool_map(pool, _pubkeys, val_seeds)
    vals = ValidatorSet([Validator(ed.PubKey(p), 10) for p in val_pubs])
    seed_of = {ed.PubKey(p).address(): s
               for p, s in zip(val_pubs, val_seeds)}

    def commit_jobs(height):
        bid = block.BlockID(_seed("block", height), block.PartSetHeader(
            1, _seed("parts", height)))
        rows = []
        for i, v in enumerate(vals.validators):
            ts = Timestamp(1_700_000_000 + height, 1000 * i + 7)
            sb = canonical.vote_sign_bytes(CHAIN_ID, canonical.PRECOMMIT,
                                           height, 0, bid, ts)
            rows.append((v.address, ts, seed_of[v.address], sb))
        return bid, rows

    heights = [1000 + h for h in range(WINDOW)] + [5]
    built = {h: commit_jobs(h) for h in heights}
    jobs = [(seed, sb) for h in heights for (_, _, seed, sb) in built[h][1]]
    sigs = iter(_pool_map(pool, _sign, jobs))
    commits = {}
    for h in heights:
        bid, rows = built[h]
        cs = [block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, addr, ts, next(sigs))
              for addr, ts, _, _ in rows]
        commits[h] = (bid, block.Commit(h, 0, bid, cs))

    rng = np.random.default_rng(SEED)
    b_seeds = [_seed("batch", i) for i in range(N_BATCH)]
    b_msgs = [rng.bytes(110) for _ in range(N_BATCH)]
    b_pubs = _pool_map(pool, _pubkeys, b_seeds)
    b_sigs = _pool_map(pool, _sign, list(zip(b_seeds, b_msgs)))
    sign_s = time.perf_counter() - t0
    state.update(vals=vals, commits=commits, heights=heights[:WINDOW],
                 batch=(b_pubs, b_msgs, b_sigs), ref=ref, seed_of=seed_of)
    return {"validators": N_VALS, "commits": len(commits),
            "commit_signatures": len(jobs), "batch_signatures": N_BATCH,
            "signing_seconds": sign_s}


# -- main path: launch accounting ---------------------------------------------

def _kernels():
    from cometbft_tpu_torch.ops import cuda_decompress, cuda_msm, msm_shard
    from cometbft_tpu_torch.ops import cuda_persig, cuda_secp, sha2
    return {"secp_q_tables": cuda_secp.q_msm_tables,
            "secp_msm_verify": cuda_secp.msm_verify,
            "secp_ladder": cuda_secp.verify_ladder,
            "sha512_blocks": sha2.sha512_blocks,
            "sha256_blocks": sha2.sha256_blocks,
            "ed25519_sharded_msm": msm_shard.sharded_msm,
            "ed25519_rlc_verify_sharded": msm_shard.rlc_verify_sharded,
            "ed25519_decompress": cuda_decompress.decompress,
            "ed25519_table17_neg": cuda_msm.table17_neg,
            "ed25519_msm_window_major": cuda_msm.msm_window_major,
            "ed25519_fold_verify": cuda_msm.fold_verify,
            "ed25519_msm_window_major_grouped":
                cuda_msm.msm_window_major_grouped,
            "ed25519_msm_window_loop": cuda_msm.msm_window_loop,
            "ed25519_select_tree": cuda_msm.select_tree,
            "ed25519_verify_ladder": cuda_persig.verify_ladder}


def _counts():
    return {k: fn.launches for k, fn in _kernels().items()}


def _zero_counts():
    for fn in _kernels().values():
        fn.launches = 0


def _set_engine(flags):
    """Set the port's engine flags: DEFAULT_ENGINE updated by flags."""
    from cometbft_tpu_torch.ops import cuda_msm
    from cometbft_tpu_torch.ops import ed25519 as dev

    for name, value in {**DEFAULT_ENGINE, **flags}.items():
        setattr(cuda_msm if name in ("WIN_GROUP", "BLK") else dev, name,
                value)


class _Timed:
    """Wraps a module function to record its calls' wall seconds (each
    call ends in a host sync: a verdict read back), each call's seconds
    and lane width (its first argument's last axis, where it is a
    tensor) and the kernels each call launched."""

    def __init__(self, mod, attr, torch, split=()):
        self.mod, self.attr, self.fn = mod, attr, getattr(mod, attr)
        self.torch, self.calls, self.seconds = torch, 0, 0.0
        self.launched, self.widths, self.each = [], [], []
        # (module, attribute, stand-in) of what the first call times one
        # by one (_Stopwatch, _CatStopwatch), with its arguments kept
        self.split, self.parts, self.first_args = split, {}, None

    def __enter__(self):
        def wrapped(*a, **k):
            before = _counts()
            watches = []
            if self.split and self.calls == 0:
                self.first_args = a
                watches = [(m, n, make(getattr(m, n), self.torch))
                           for m, n, make in self.split]
                for m, n, w in watches:
                    setattr(m, n, w)
            t0 = time.perf_counter()
            try:
                out = self.fn(*a, **k)
                if DEVICE == "cuda":
                    self.torch.cuda.synchronize()
            finally:
                for m, n, w in watches:
                    setattr(m, n, w.fn)
                    self.parts[n] = w.ms
            dt = time.perf_counter() - t0
            self.seconds += dt
            self.each.append(dt)
            self.calls += 1
            shape = getattr(a[0], "shape", None) if a else None
            self.widths.append(None if shape is None else int(shape[-1]))
            self.launched.append(_launched(before, _counts()))
            return out
        setattr(self.mod, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)


class _Stopwatch:
    """Stands in for a kernel wrapper: times each call on the host clock
    between two synchronizations (a first call's one-time costs included)
    and passes the wrapper's launch count through."""

    def __init__(self, fn, torch, ms=None):
        self.fn, self.torch, self.ms = fn, torch, [] if ms is None else ms

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, *a, **k):
        if DEVICE == "cuda":
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        if DEVICE == "cuda":
            self.torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class _Widths(_Stopwatch):
    """_Stopwatch that also keeps each call's lane width (its first
    argument's last axis)."""

    def __init__(self, fn, torch):
        super().__init__(fn, torch)
        self.widths = []

    def __call__(self, *a, **k):
        self.widths.append(int(a[0].shape[-1]))
        return super().__call__(*a, **k)


class _CatStopwatch(_Stopwatch):
    """Stands in for a module's `torch`: times torch.cat as _Stopwatch
    does, everything else passes through."""

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def cat(self, *a, **k):
        return _Stopwatch.__call__(_Stopwatch(self.fn.cat, self.torch,
                                              self.ms), *a, **k)


def _persig(torch, split=False):
    """_Timed on ops/ed25519.verify_kernel, the per-signature
    localization; with split, its first call also times its three steps
    one by one: the torch.cat of A and R, K1's and K14's wrappers."""
    from cometbft_tpu_torch.ops import cuda_decompress, cuda_persig
    from cometbft_tpu_torch.ops import ed25519 as dev
    return _Timed(dev, "verify_kernel", torch,
                  ((dev, "torch", _CatStopwatch),
                   (cuda_decompress, "decompress", _Stopwatch),
                   (cuda_persig, "verify_ladder", _Stopwatch))
                  if split else ())


def _first_localization(persig, torch):
    """The process's first localization (the commit reject's), apart
    from the others: its wall ms and its three steps' (the torch.cat of
    A and R, K1's and K14's wrapper calls), and the same localization
    run again on the same inputs (outside the count).  The difference,
    `once_ms`, is what a process pays once: the first launch of each
    CUDA kernel loads its module (lazily), and the first allocations of
    its sizes; the libraries' build and load are the build phase's."""
    saved = _counts()
    again = _persig(torch, split=True)
    with again:
        again.mod.verify_kernel(*persig.first_args)
    for name, fn in _kernels().items():
        fn.launches = saved[name]
    def steps(t):
        return {"ms": t.each[0] * 1e3, "width": t.widths[0],
                "cat_ms": t.parts["torch"], "k1_ms": t.parts["decompress"],
                "k14_ms": t.parts["verify_ladder"]}

    rec = {"first": steps(persig), "again": steps(again),
           "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING")}
    rec["once_ms"] = {k: (rec["first"][k] - rec["again"][k]) if k == "ms"
                      else sum(rec["first"][k]) - sum(rec["again"][k])
                      for k in ("ms", "cat_ms", "k1_ms", "k14_ms")}
    return rec


def _check_persig(persig, label, width, calls=1, want=None):
    """`calls` localizations, each launching exactly `want` (one K1 and
    one K14) over `width` lanes: the live signatures, on one device."""
    want = PERSIG_LAUNCHES if want is None else want
    check(persig.calls == calls and all(x == want for x in persig.launched),
          f"{label}: {persig.calls} localizations launching "
          f"{persig.launched}, not {calls} launching {want} each")
    check(persig.widths == [width] * calls, f"{label}: localizations over "
          f"{persig.widths} lanes, not {width}")


def _keep_pack(packs, pubkeys, parsed, packed, ok):
    """Keep an RLC program's pack in `packs` once per (A, R) width, when
    the program accepted it: the kernels phase holds K1-K4 against their
    plain versions at each width a main path gave them."""
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed

    n = len(pubkeys)
    if ok and n >= 2:
        p = packed if packed is not cb._NO_PACK else ed.pack_rlc(
            pubkeys, [b""] * n, [b""] * n, parsed=parsed)
        if p is not None:
            packs.setdefault((int(p[0].shape[-1]), int(p[1].shape[-1])), p)


@contextlib.contextmanager
def _kept_packs(packs):
    """crypto/batch._device_verify, keeping each accepted program's pack
    in `packs` (_keep_pack)."""
    from cometbft_tpu_torch.crypto import batch as cb

    real = cb._device_verify

    def kept(pubkeys, parsed, device, packed=cb._NO_PACK):
        ok, verdicts = real(pubkeys, parsed, device, packed=packed)
        _keep_pack(packs, pubkeys, parsed, packed, ok)
        return ok, verdicts
    cb._device_verify = kept
    try:
        yield packs
    finally:
        cb._device_verify = real


@contextlib.contextmanager
def _kept_windows(pipe):
    """pipe.submit, keeping each window's (items, handle)."""
    real, windows = pipe.submit, []

    def submit(items, **kw):
        items = list(items)
        h = real(items, **kw)
        windows.append((items, h))
        return h
    pipe.submit = submit
    try:
        yield windows
    finally:
        pipe.submit = real


def _keep_localized(state, key, windows, widths, label):
    """The items of each window in `windows` ((items, handle), resolved)
    that K1 + K14 localized (one signature, or a rejected program), once
    per live width in state[key], for the kernels phase; the widths the
    localizations ran at (`widths`, from _persig) must be theirs."""
    kept = state.setdefault(key, {})
    mine = set()
    for items, h in windows:
        ok, verdicts = h.result(timeout=0)
        if len(items) == 1 or not all(verdicts):
            mine.add(len(items))
            # a DeferredSigBatch window carries PubKey objects, the vote
            # stream's carry key bytes
            kept.setdefault(len(items), tuple(zip(*[
                (pk if isinstance(pk, bytes) else pk.bytes(), m, sig)
                for pk, m, sig in items])))
    check(set(widths) == mine, f"{label}: localizations over "
          f"{sorted(set(widths))} lanes, windows localized at {sorted(mine)}")


def _with_sig(commit, idx, byte, bit):
    """commit with signature idx's byte flipped at bit: (commit, sig)."""
    sigs = list(commit.signatures)
    s = bytearray(sigs[idx].signature)
    s[byte] ^= bit
    sigs[idx] = type(sigs[idx])(sigs[idx].block_id_flag,
                                sigs[idx].validator_address,
                                sigs[idx].timestamp, bytes(s))
    return type(commit)(commit.height, commit.round, commit.block_id,
                        sigs), bytes(s)


def _commit_accept_reject(state, val):
    """The 150-validator commit: accept, then one tampered signature
    whose error names its index, localized by one K1 and one K14.
    (accept seconds, reject seconds)."""
    import torch

    vals = state["vals"]
    bid, commit = state["commits"][5]
    t0 = time.perf_counter()
    val.verify_commit_light(CHAIN_ID, vals, bid, 5, commit, device=DEVICE)
    accept_s = time.perf_counter() - t0
    bad_idx = N_VALS // 4
    tampered, s = _with_sig(commit, bad_idx, 11, 0x40)
    first = "first_localization" not in state
    t0 = time.perf_counter()
    with _persig(torch, split=first) as persig:
        try:
            val.verify_commit_light(CHAIN_ID, vals, bid, 5, tampered,
                                    device=DEVICE)
            raise PhaseError("tampered commit accepted")
        except val.ErrInvalidSignature as e:
            check(str(e).startswith(f"wrong signature (#{bad_idx}): "
                                    f"{s.hex()}"), f"wrong message {e}")
    reject_s = time.perf_counter() - t0
    _check_persig(persig, "commit reject", COMMIT_SIGS)
    if first:
        state["first_localization"] = _first_localization(persig, torch)
    return accept_s, reject_s


def phase_commit(state, torch):
    from cometbft_tpu_torch.types import validation as val

    _set_engine({})
    _zero_counts()                      # main path starts here
    state["main_t0"] = time.perf_counter()
    vals = state["vals"]
    bid, commit = state["commits"][5]
    before = _counts()
    accept_s, _ = _commit_accept_reject(state, val)

    from cometbft_tpu_torch.types import block
    needed = 10 * N_VALS * 2 // 3
    few = [cs if i < needed // 10 else block.CommitSig.absent()
           for i, cs in enumerate(commit.signatures)]
    try:
        val.verify_commit_light(CHAIN_ID, vals, bid, 5,
                                type(commit)(5, 0, bid, few), device=DEVICE)
        raise PhaseError("commit below +2/3 accepted")
    except val.ErrNotEnoughVotingPowerSigned as e:
        check(str(e) == "invalid commit -- insufficient voting power: got "
              f"{needed // 10 * 10}, needed more than {needed}",
              f"wrong message {e}")
    after = _counts()
    return {"accept_seconds": accept_s,
            "launches": {k: after[k] - before[k] for k in after},
            "first_localization": state["first_localization"]}


def _run_window(state, val, commits, vals=None):
    """`commits` through DeferredSigBatch over `vals` (the ed25519 set by
    default): the signatures verified."""
    batch = val.DeferredSigBatch()
    for h, (bid, commit) in commits:
        val.verify_commit_light(CHAIN_ID, state["vals"] if vals is None
                                else vals, bid, h, commit, defer_to=batch,
                                device=DEVICE)
    n = batch.count()
    batch.verify(device=DEVICE)
    return n


def _window_reject(state, val, commits):
    """The window with one bad signature at a known height: the error
    must name the height, after one localization (one K1 and one K14).
    (seconds, the bad window's commits, the bad height, the
    localization's seconds)."""
    import torch

    bad_h = state["heights"][len(state["heights"]) // 3]
    bid, commit = state["commits"][bad_h]
    bad_commit, s = _with_sig(commit, 5, 40, 0x01)
    bad = [(h, (b, bad_commit if h == bad_h else c))
           for h, (b, c) in commits]
    t0 = time.perf_counter()
    with _persig(torch) as persig:
        try:
            _run_window(state, val, bad)
            raise PhaseError("bad window accepted")
        except val.ErrInvalidSignature as e:
            check(getattr(e, "failed_ctx", None) == bad_h,
                  f"blamed {getattr(e, 'failed_ctx', None)}, not {bad_h}")
            check(str(e) == f"wrong signature in commit at height {bad_h}: "
                  f"{s.hex()}", f"wrong message {e}")
    seconds = time.perf_counter() - t0
    _check_persig(persig, "window reject", WINDOW * COMMIT_SIGS)
    return seconds, bad, bad_h, persig.seconds


def phase_window(state, torch):
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import validation as val

    commits = [(h, state["commits"][h]) for h in state["heights"]]
    start = _counts()
    ed._A_TABLE_CACHE = ed.ATableCache()
    cache = ed._A_TABLE_CACHE
    runs = []
    for _ in range(3):
        before = _counts()
        hits, misses = cache.hits, cache.misses
        with _Timed(ed, "rlc_verify", torch) as rlc:
            t0 = time.perf_counter()
            n = _run_window(state, val, commits)
            wall = time.perf_counter() - t0
        after = _counts()
        program = "cached_a" if (cache.hits + cache.misses
                                 > hits + misses) else "whole"
        runs.append({"signatures": n, "seconds": wall,
                     "sigs_per_s": n / wall,
                     "rlc_verify_seconds": rlc.seconds,
                     "program": program,
                     "cache_hit": cache.hits > hits,
                     "launches": {k: after[k] - before[k] for k in after}})
    check([r["program"] for r in runs] == ["whole", "cached_a", "cached_a"],
          f"programs {[r['program'] for r in runs]}")
    check(runs[2]["cache_hit"], "third window missed the ATableCache")

    reject_s, bad, bad_h, persig_s = _window_reject(state, val, commits)
    state["window_bad"] = (bad, bad_h)
    state["window_packed_bad"] = ed.pack_rlc(*_window_items(state, bad))
    state["window_packed"] = ed.pack_rlc(*_window_items(state, commits))
    state["commit_packed"] = ed.pack_rlc(*_window_items(
        state, [(5, state["commits"][5])]))
    end = _counts()
    return {"runs": runs, "bad_height": bad_h, "reject_seconds": reject_s,
            "launches": {k: end[k] - start[k] for k in end},
            "persig_seconds": persig_s}


def _light_entries(vals, commits):
    """The (key, sign bytes, sig) triples verify_commit_light collects
    from `commits`, in order."""
    from cometbft_tpu_torch.types import validation as val

    batch = val.DeferredSigBatch()
    for h, (bid, commit) in commits:
        val.verify_commit_light(CHAIN_ID, vals, bid, h, commit, defer_to=batch,
                                device=DEVICE)
    return [(e[2], e[3], e[4]) for e in batch._entries]


def _window_items(state, commits, vals=None):
    """(pubkeys, msgs, sigs) of `commits` as DeferredSigBatch collects
    them, over `vals` (the ed25519 set by default)."""
    ents = _light_entries(state["vals"] if vals is None else vals, commits)
    return ([p.bytes() for p, _, _ in ents], [m for _, m, _ in ents],
            [sg for _, _, sg in ents])


def _clean_batch(state, torch):
    """The 8,192 distinct-key batch, clean: (seconds, rlc seconds)."""
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed

    bv = cb.create_batch_verifier("ed25519", n_hint=N_BATCH, device=DEVICE)
    for p, m, s in zip(*state["batch"]):
        bv.add(p, m, s)
    with _Timed(ed, "rlc_verify", torch) as rlc:
        t0 = time.perf_counter()
        ok, verdicts = bv.verify()
        seconds = time.perf_counter() - t0
    check(ok and all(verdicts) and len(verdicts) == N_BATCH,
          "clean batch rejected")
    return seconds, rlc.seconds


def phase_batch(state, torch):
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed

    ref = state["ref"]
    before = _counts()
    clean_s, clean_rlc_s = _clean_batch(state, torch)

    # hostile entries: s >= L, a key with y = p + 3 under a junk
    # signature, a tampered signature, and a VALID signature under the
    # non-canonical encoding y = p + 1 of the identity (R = sB)
    pubs, msgs, sigs = (list(x) for x in state["batch"])
    i1, i2, i3, i4 = (N_BATCH // 8 * k for k in (1, 2, 3, 4))
    sigs[i1] = sigs[i1][:32] + (ref.L + 7).to_bytes(32, "little")
    pubs[i2] = (ref.P + 3).to_bytes(32, "little")
    t = bytearray(sigs[i3])
    t[50] ^= 0x08
    sigs[i3] = bytes(t)
    k = 987654321
    pubs[i4] = (ref.P + 1).to_bytes(32, "little")
    sigs[i4] = ref.point_compress(ref.point_mul(k, ref.B)) + \
        k.to_bytes(32, "little")
    bv = cb.create_batch_verifier("ed25519", n_hint=N_BATCH, device=DEVICE)
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    with _persig(torch) as persig:
        t0 = time.perf_counter()
        ok, verdicts = bv.verify()
        hostile_s = time.perf_counter() - t0
    _check_persig(persig, "hostile batch", N_BATCH)
    t0 = time.perf_counter()
    want = _pool_map(state["pool"], _verify, list(zip(pubs, msgs, sigs)))
    oracle_s = time.perf_counter() - t0
    check(verdicts == want, "verdicts differ from ed25519_ref.verify at "
          f"{[i for i, (a, b) in enumerate(zip(verdicts, want)) if a != b][:8]}")
    check(not ok and [i for i, v in enumerate(want) if not v]
          == [i1, i2, i3], "unexpected reject set")
    check(want[i4], "identity-key signature rejected")
    state["oracle"] = dict(zip(zip(pubs, msgs, sigs), want))
    state["main_s"] = time.perf_counter() - state["main_t0"]
    state["main_launches"] = _counts()
    launched = {k for k, v in state["main_launches"].items() if v}
    check(launched == DEFAULT_KERNELS, "the default engine launched "
          f"{sorted(launched)}, not {sorted(DEFAULT_KERNELS)}: "
          f"{state['main_launches']}")
    state["batch_items"] = (pubs, msgs, sigs)
    state["batch_packed"] = ed.pack_rlc(*state["batch"])
    return {"clean_seconds": clean_s, "clean_sigs_per_s": N_BATCH / clean_s,
            "clean_rlc_verify_seconds": clean_rlc_s,
            "hostile_seconds": hostile_s, "persig_seconds": persig.seconds,
            "oracle_seconds": oracle_s,
            "launches": {k: state["main_launches"][k] - before[k]
                         for k in before},
            "main_path_launches": state["main_launches"]}


# -- phase 5: the multi-device path ---------------------------------------------

def _mesh_devices(torch, n):
    """n logical shards: cuda:(i % cards), or "cpu" n times when the
    script runs the plain versions."""
    if DEVICE == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _launched(before, after):
    """The counts that moved between two readings."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _k8_bound(state, torch, devices, sides, tables):
    """Least time of one K8 call: per card, the bounds of the kernels
    its shards run in turn (K1 and K2 when `tables`, then K3, on each
    side of `sides` = [(width, windows)]), the cards in parallel; then
    the gathered partials' bytes once at the copy rate (HBM on one
    card, NVLink across cards) and the epilogue on devices[0]: K4 over
    both sides' partials, or the tree fold of one side's.  Returns
    (ms, "operations" or "bytes")."""
    from cometbft_tpu_torch.ops import cuda_msm as cm

    def meta(*shape):
        return torch.empty(shape, device="meta")

    def bound(name, *args):
        return _bound(state, *_work(name, {"args": args}))[0]

    n = len(devices)
    per_card, parts = {}, []
    for w, nwin in sides:
        ws = w // n
        t = bound("ed25519_msm_window_major", None, meta(nwin, ws), None)
        if tables:
            t += (bound("ed25519_decompress", meta(8, ws))
                  + bound("ed25519_table17_neg", meta(4, 20, ws)))
        for d in devices:
            per_card[d] = per_card.get(d, 0.0) + t
        parts.append(n * cm.msm_geometry(ws, nwin)[2])
    rate = NVLINK_BYTES_PER_S if len(set(devices)) > 1 else HBM_BYTES_PER_S
    t_gather = sum(parts) * 320 / rate * 1e3
    if tables:
        t_tail = bound("ed25519_fold_verify", meta(4, 20, parts[0]),
                       meta(4, 20, parts[1]))
    else:
        t_tail = _bound(state, (parts[0] - 1) * ADD, 0)[0]
    t_ops = max(per_card.values()) + t_tail
    return t_ops + t_gather, "operations" if t_ops >= t_gather else "bytes"


def _k8_calls(state, torch, packs):
    """rlc_verify_sharded on each packed input at each shard count, three
    calls each: every verdict equals the unsharded whole program's, and
    every call launches 2n K1, 2n K2, 2n K3, one K4 and nothing else."""
    import statistics

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import msm_shard

    rows = []
    for label, (clean, tampered) in packs.items():
        for tag, packed in (("clean", clean), ("tampered", tampered)):
            unsharded = ed.rlc_verify(packed, use_cache=False, device=DEVICE)
            check(unsharded is (tag == "clean"),
                  f"unsharded {label} {tag}: {unsharded}")
            args = convert.packed_from_numpy(packed, DEVICE)
            k, w = (int(a.shape[-1]) for a in args[:2])
            for n in MESH_SHARDS:
                devs = _mesh_devices(torch, n)
                want = {"ed25519_decompress": 2 * n,
                        "ed25519_table17_neg": 2 * n,
                        "ed25519_msm_window_major": 2 * n,
                        "ed25519_fold_verify": 1,
                        "ed25519_rlc_verify_sharded": 1}
                times = []
                for _ in range(3):
                    before = _counts()
                    t0 = time.perf_counter()
                    got = bool(msm_shard.rlc_verify_sharded(*args,
                                                            devices=devs))
                    times.append((time.perf_counter() - t0) * 1e3)
                    launched = _launched(before, _counts())
                    check(got is unsharded, f"K8 {label} {tag} n={n}: "
                          f"{got}, unsharded {unsharded}")
                    check(launched == want, f"K8 {label} {tag} n={n} "
                          f"launched {launched}, not {want}")
                bound_ms, bound_by = _k8_bound(
                    state, torch, devs, [(k, 52), (w, 26)], tables=True)
                rows.append({"packed": label, "signatures": tag,
                             "shards": n, "shape": [k, w], "verdict": got,
                             "ms": statistics.median(times),
                             "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def _split_window(state, torch):
    """The 4,848-signature window split over 2 and 4 devices, clean (3
    calls each) and with the bad signature (only its chunk rejects),
    each call's launches exact given its A-table cache hits; then the
    bad window localized over the same devices."""
    import statistics

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import mesh

    clean = _window_items(state, [(h, state["commits"][h])
                                  for h in state["heights"]])
    bad = _window_items(state, state["window_bad"][0])
    bad_i = next(i for i, (a, b) in enumerate(zip(clean[2], bad[2]))
                 if a != b)
    rows = []
    for tag, items in (("clean", clean), ("bad", bad)):
        parsed = ed.parse_and_hash(*items)
        for n in MESH_SHARDS[1:]:
            devs = _mesh_devices(torch, n)
            spans = mesh.split_spans(len(items[0]), n)
            want = [tag == "clean" or not a <= bad_i < b for a, b in spans]
            times = []
            for _ in range(3 if tag == "clean" else 1):
                before, hits = _counts(), ed._A_TABLE_CACHE.hits
                t0 = time.perf_counter()
                got = mesh.split_rlc_verify(items[0], parsed, devs)
                times.append((time.perf_counter() - t0) * 1e3)
                hit = ed._A_TABLE_CACHE.hits - hits
                launched = _launched(before, _counts())
                check(got == want, f"split {tag} n={n}: {got}, not {want}")
                need = {"ed25519_decompress": 2 * n - hit,
                        "ed25519_table17_neg": 2 * n - hit,
                        "ed25519_msm_window_major": 2 * n,
                        "ed25519_fold_verify": n}
                check(launched == need, f"split {tag} n={n} launched "
                      f"{launched}, not {need}")
            rec = {"signatures": tag, "shards": n, "chunks": got,
                   "ms": statistics.median(times), "cache_hits": hit}
            if tag == "bad":
                before = _counts()
                t0 = time.perf_counter()
                verdicts = mesh.verify_batch_mesh(items[0], parsed, devs)
                rec["localize_ms"] = (time.perf_counter() - t0) * 1e3
                launched = _launched(before, _counts())
                check([i for i, v in enumerate(verdicts) if not v] == [bad_i],
                      f"localized over {n}: not exactly index {bad_i}")
                check(launched == {"ed25519_decompress": n,
                                   "ed25519_verify_ladder": n},
                      f"localization over {n} launched {launched}")
            rows.append(rec)
    return rows, bad_i


def _hostile_split(state, torch):
    """The hostile 8,192 batch's per-signature program split over 2 and
    4 devices: verdicts equal the unsharded program's."""
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import mesh
    from cometbft_tpu_torch.ops import ed25519 as dev

    pubs = state["batch_items"][0]
    parsed = ed.parse_and_hash(*state["batch_items"])
    n = len(pubs)
    a, r, s, h, valid = ed.pack_batch(pubs, [b""] * n, [b""] * n,
                                      dev.bucket_size(n), parsed=parsed)
    want = (dev.verify_kernel(*convert.batch_from_numpy(a, r, s, h, DEVICE))
            .cpu().numpy() & valid)[:n].tolist()
    rows = []
    for shards in MESH_SHARDS[1:]:
        before = _counts()
        t0 = time.perf_counter()
        got = mesh.verify_batch_mesh(pubs, parsed,
                                     _mesh_devices(torch, shards))
        launched = _launched(before, _counts())
        check(got == want, f"hostile batch over {shards} differs from the "
              "unsharded per-signature program")
        check(launched == {"ed25519_decompress": shards,
                           "ed25519_verify_ladder": shards},
              f"hostile batch over {shards} launched {launched}")
        rows.append({"shards": shards, "ms": (time.perf_counter() - t0) * 1e3,
                     "rejected": [i for i, v in enumerate(got) if not v]})
    return rows


def _k8_vs_plain(state, torch):
    """K8 on the window's R side at n = 4: the gathered partials on the
    card equal the same function's over four "cpu" shards (the plain
    versions) limb for limb, and the reduced point equals the
    single-program K3 + _tree_reduce point projectively."""
    import functools

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.ops import fe, msm_shard

    t = convert.packed_from_numpy(state["window_packed"], DEVICE)
    mags, negs = t[4], t[5]
    tab = cm.table17_neg(cd.decompress(t[1])[0])
    devs = _mesh_devices(torch, MESH_SHARDS[-1])
    parts = msm_shard.sharded_partials(tab, mags, negs, devices=devs)
    host = [x.cpu() for x in (tab, mags, negs)]
    t0 = time.perf_counter()
    plain_parts = msm_shard.sharded_partials(
        *host, devices=[torch.device("cpu")] * len(devs))
    plain_point = dev._tree_reduce(plain_parts, 1)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _exact(parts.cpu(), plain_parts)
    point = msm_shard.sharded_msm(tab, mags, negs, devices=devs)
    single = dev._tree_reduce(cm.msm_window_major(tab, mags, negs, group=1), 1)
    proj = max(_proj_err(torch, fe, point, single),
               _proj_err(torch, fe, point.cpu(), plain_point))
    check(err == 0 and proj == 0, f"K8 partials differ from plain by {err}, "
          f"its point from the single program's by {proj}")
    nwin, w = (int(d) for d in mags.shape)
    ms = (_time(torch, functools.partial(msm_shard.sharded_msm, devices=devs),
                (tab, mags, negs), 7, inner=3) if DEVICE == "cuda" else None)
    bound_ms, bound_by = _k8_bound(state, torch, devs, [(w, nwin)],
                                   tables=False)
    return {"shape": [nwin, w], "shards": len(devs),
            "partials": int(parts.shape[-1]), "max_abs_err": err,
            "projective_err": proj, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_mesh(state, torch):
    """The multi-device path on logical shards, with the counts set to 0
    just before it and read just after: K8 whole programs, the split
    window and its localization, the hostile batch split, the placed
    cached-A program.  Then K8 against its plain version (comparison
    launches do not count)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed

    pubs, msgs, sigs = (list(x) for x in state["batch"])
    i3 = N_BATCH // 8 * 3                 # phase 4's tampered signature
    t = bytearray(sigs[i3])
    t[50] ^= 0x08
    sigs[i3] = bytes(t)
    packs = {"window": (state["window_packed"], state["window_packed_bad"]),
             "batch": (state["batch_packed"], ed.pack_rlc(pubs, msgs, sigs))}
    ed._A_TABLE_CACHE = cache = ed.ATableCache()
    _zero_counts()                        # the mesh path starts here
    t0 = time.perf_counter()
    k8 = _k8_calls(state, torch, packs)
    split, bad_i = _split_window(state, torch)
    hostile = _hostile_split(state, torch)
    last = _mesh_devices(torch, MESH_SHARDS[-1])[-1]
    ed._A_TABLE_CACHE = cache = ed.ATableCache()
    hits = []
    for _ in range(2):
        h0 = cache.hits
        check(ed.rlc_verify(state["window_packed"], use_cache=True,
                            device=last), f"placed cached-A on {last} rejected")
        hits.append(cache.hits - h0)
    key = (state["window_packed"][0].tobytes(), str(last))
    check(hits == [0, 1] and key in cache._entries,
          f"placed cached-A on {last}: hits {hits}")
    path_s = time.perf_counter() - t0
    state["mesh_launches"] = _counts()
    vs_plain = _k8_vs_plain(state, torch)
    for name, fn in _kernels().items():  # comparison launches do not count
        fn.launches = state["mesh_launches"][name]
    launches = {k: state["mesh_launches"][k] for k in K8}
    state["k8_row"] = {
        "name": "ed25519_sharded_msm", "route": "cuda",
        "source": "cometbft_tpu_torch/ops/msm_shard.py",
        "replaces": "cometbft_tpu/ops/msm_shard.py:42",
        "launches": sum(launches.values()), "launches_by_function": launches,
        "max_abs_err": vs_plain["max_abs_err"], "ms": vs_plain["ms"],
        "plain_ms": vs_plain["plain_ms"], "bound_ms": vs_plain["bound_ms"],
        "bound_by": vs_plain["bound_by"], "library_ms": None,
        "matches_plain": True, "shape": vs_plain["shape"],
        "shards": vs_plain["shards"], "rlc_verify_sharded": k8}
    return {"card": state["card"], "devices": [str(d) for d in
                                               _mesh_devices(torch, 4)],
            "path_seconds": path_s, "k8": k8, "split_window": split,
            "bad_index": bad_i, "hostile_batch": hostile,
            "placed_cached_a": {"device": str(last), "hits": hits},
            "k8_vs_plain": vs_plain, "launches": state["mesh_launches"]}


# -- phase 6: the device-hash path -------------------------------------------

def _oracle(state, items):
    """ed25519_ref.verify of each (pubkey, msg, sig), in the pool, each
    triple computed once per run."""
    known = state.setdefault("oracle", {})
    todo = sorted({t for t in zip(*items) if t not in known})
    known.update(zip(todo, _pool_map(state["pool"], _verify, todo)))
    return [known[t] for t in zip(*items)]


def _hash_cases(state):
    """{label: ((pubkeys, msgs, sigs), the bad index or None)}: the
    commit's and the window's signatures as DeferredSigBatch collects
    them (clean, and the window with its bad signature), the batch clean
    and with phase 4's hostile entries."""
    commit = _window_items(state, [(5, state["commits"][5])])
    window = _window_items(state, [(h, state["commits"][h])
                                   for h in state["heights"]])
    bad = _window_items(state, state["window_bad"][0])
    bad_i = next(i for i, (a, b) in enumerate(zip(window[2], bad[2]))
                 if a != b)
    return {"commit": (commit, None), "window": (window, None),
            "window_bad": (bad, bad_i),
            "batch": (tuple(list(x) for x in state["batch"]), None),
            "batch_hostile": (state["batch_items"], None)}


def _rlc_launches(torch, packed):
    """The kernels one host-hash whole RLC program launches on `packed`
    (no A-table cache), and its verdict."""
    from cometbft_tpu_torch.crypto import ed25519 as ed

    before = _counts()
    ok = ed.rlc_verify(packed, use_cache=False, device=DEVICE)
    return _launched(before, _counts()), ok


def _tool(name):
    """The module of cometbft_tpu_torch/tools/<name>.py (a script
    directory, not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "cometbft_tpu_torch" / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _program_syncs(torch, packed, packed_h):
    """Host waits inside the device-hash RLC program and the host-hash
    one, each on its batch's inputs copied to the card beforehand: a
    program that makes none can be launched on every chunk of a split
    before any verdict is read.  The control, one copy of a numpy array
    to the card, must count 1."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import ed25519 as dev

    count_waits = _tool("host_syncs").count_waits
    card = torch.device(DEVICE)
    n_copy, _ = count_waits(torch, lambda: torch.as_tensor(
        np.arange(4), device=card))
    n_hash, ok = count_waits(torch, dev.rlc_verify_hash_kernel,
                             *convert.rlc_hash_from_numpy(packed, card))
    n_host, ok_h = count_waits(torch, dev.rlc_verify_kernel,
                               *convert.packed_from_numpy(packed_h, card))
    return {"device_hash_program": n_hash, "host_hash_program": n_host,
            "control_one_copy": n_copy, "verdicts": [bool(ok), bool(ok_h)]}


def _merge(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _hash_breakdown(torch, packed):
    """Where one device-hash RLC program's time goes, on `packed`: host
    wall with a sync after each stage (single samples) of K9 alone, h =
    SHA512 mod L, the whole hash-to-scalar (h, z*h, the per-key sums,
    the recode) and the whole program; and the torch operators the
    hash-to-scalar dispatches (each one launch or more on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.ops import sha2

    class _Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _Ops.n += 1
            return func(*args, **(kwargs or {}))

    (a, r, base, z, gids, bh, bl, nb, r_mag, r_neg) = \
        convert.rlc_hash_from_numpy(packed, DEVICE)

    def to_scalars():
        h = dev._h_scalars(bh, bl, nb)
        seg = dev._segment_sum_mod_l(dev._zh_mod_l(z, h), gids, a.shape[-1])
        return dev._recode_w5_device(dev._add_mod_l(base, seg))

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"k9_ms": ms(lambda: sha2.sha512_blocks(bh, bl, nb)),
           "h_scalars_ms": ms(lambda: dev._h_scalars(bh, bl, nb)),
           "hash_to_scalar_ms": ms(to_scalars),
           "program_ms": ms(lambda: bool(dev.rlc_verify_hash_kernel(
               a, r, base, z, gids, bh, bl, nb, r_mag, r_neg)))}
    with _Ops():
        to_scalars()
    out["hash_to_scalar_torch_ops"] = _Ops.n
    return out


def _valset_stages(torch, valset):
    """ValidatorSet.hash()'s steps one by one, host wall with a sync
    after each (single samples): the leaf encoding (SimpleValidator
    bytes and the 0x00 prefix), the padding, the copy to the card, K10,
    the copy back into 32-byte digests and the host's inner tree.
    Returns ({stage: ms}, the root)."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.ops import sha2

    card = torch.device(DEVICE)
    ms, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        if card.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t0) * 1e3
        t0 = now

    leaves = [merkle.LEAF_PREFIX + v.bytes() for v in valset.validators]
    stage("leaf_encoding")
    blocks, nb = sha2.pad_sha256(leaves)
    stage("padding")
    args = (convert.words_from_numpy(blocks, card),
            torch.from_numpy(nb).to(card))
    stage("copy_to_card")
    digests = sha2.sha256_blocks(*args)
    stage("k10")
    raw = digests.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    hashes = [raw[32 * i:32 * i + 32] for i in range(len(leaves))]
    stage("copy_back")
    root = merkle._root_from_leaf_hashes(hashes)
    stage("inner_tree")
    ms["total"] = sum(ms.values())
    return ms, root


def phase_hash(state, torch):
    """The device-hash path, with the counts set to 0 just before it and
    read just after: each case through parse_batch and
    _device_verify_hash on the card (seconds: both), its launches exact;
    the oversized message; ValidatorSet.hash() of N_VALSET validators and
    sum_sha256_many below its threshold.  A warm-up call on the commit
    comes first, outside the count: the first call pays torch's loading
    of the CUDA modules of the hash-to-scalar ops.  Then, outside the
    count, the host-hash route on the same cases (parse_and_hash and
    _device_verify, the A-table cache off so that both routes run the
    whole program), its verdicts, the host packing time of each
    route's packer, and, on the window and the batch, the times each
    route's RLC program makes the host wait for the card (none allowed
    for the device-hash one)."""
    import numpy as np

    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import hash as chash
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    cases = _hash_cases(state)
    rng = np.random.default_rng(SEED)
    valset = ValidatorSet([Validator(ed.PubKey(rng.bytes(32)),
                                     int(rng.integers(1, 1 << 40)))
                           for _ in range(N_VALSET)])
    leaves = [v.bytes() for v in valset.validators]
    rows, verdict_of, k9_inputs = {}, {}, []
    pks, msgs, sigs = cases["commit"][0]
    t0 = time.perf_counter()
    cb._device_verify_hash(pks, msgs, ed.parse_batch(pks, sigs),
                           device=DEVICE)
    warm_s = time.perf_counter() - t0
    _zero_counts()                        # the device-hash path starts here
    t_path = time.perf_counter()
    for label, ((pks, msgs, sigs), bad_i) in cases.items():
        n = len(pks)
        before = _counts()
        with _Timed(ed, "rlc_verify_hash", torch) as rlc, \
                _Timed(dev, "verify_hash_kernel", torch) as persig:
            t0 = time.perf_counter()
            parsed = ed.parse_batch(pks, sigs)
            ok, verdicts = cb._device_verify_hash(pks, msgs, parsed,
                                                  device=DEVICE)
            seconds = time.perf_counter() - t0
        rows[label] = {"signatures": n, "ok": ok, "seconds": seconds,
                       "rlc_verify_hash_seconds": rlc.seconds,
                       "rlc_calls": rlc.calls,
                       "localize_seconds": persig.seconds,
                       "localize_calls": persig.calls,
                       "launches": _launched(before, _counts()),
                       "rejected": [i for i, v in enumerate(verdicts)
                                    if not v]}
        verdict_of[label] = (ok, verdicts)
        structural = any(p is None for p in parsed)
        check(rlc.calls == (0 if structural else 1) and
              persig.calls == (0 if ok else 1),
              f"hash {label}: {rlc.calls} RLC calls, {persig.calls} "
              "localizations")
        if bad_i is not None:
            check(rows[label]["rejected"] == [bad_i], f"hash {label}: "
                  f"rejected {rows[label]['rejected'][:8]}, not [{bad_i}]")
        check(persig.widths == [n] * persig.calls, f"hash {label}: "
              f"localizations over {persig.widths} lanes, not {n}")
    oversized = cases["commit"][0]
    long = [b"\x00" * (128 * ed.DEVICE_HASH_MAX_BLOCKS)] + oversized[1][1:]
    before = _counts()
    try:
        cb._device_verify_hash(oversized[0], long,
                               ed.parse_batch(oversized[0], oversized[2]),
                               device=DEVICE)
        raise PhaseError("an oversized message was accepted")
    except ValueError as e:
        check(str(e) == "message exceeds max_blocks", f"wrong error {e}")
    check(not _launched(before, _counts()), "the oversized message launched")
    before = _counts()
    t0 = time.perf_counter()
    root = valset.hash(device=DEVICE)
    valset_s = time.perf_counter() - t0
    valset_launches = _launched(before, _counts())
    before = _counts()
    below = chash.sum_sha256_many(leaves[:chash.DEVICE_HASH_THRESHOLD - 1],
                                  device=DEVICE)
    below_launches = _launched(before, _counts())
    path_s = time.perf_counter() - t_path
    state["hash_launches"] = _counts()

    # outside the count: the host-hash route, the oracle, the packers
    host_root = merkle.hash_from_byte_slices(leaves)
    check(root == host_root, "ValidatorSet.hash() differs from the host "
          "Merkle root")
    valset_stages, staged_root = _valset_stages(torch, valset)
    check(staged_root == host_root, "ValidatorSet.hash() by stages differs "
          "from the host Merkle root")
    check(valset_launches == {"sha256_blocks": 1},
          f"ValidatorSet.hash() launched {valset_launches}")
    check(not below_launches and below == [hashlib.sha256(x).digest()
                                           for x in leaves[:len(below)]],
          f"sum_sha256_many below the threshold launched {below_launches}")
    for label, ((pks, msgs, sigs), _) in cases.items():
        rec, (ok, verdicts) = rows[label], verdict_of[label]
        n = len(pks)
        ram = [s[:32] + p + m for p, m, s in zip(pks, msgs, sigs)]
        t0 = time.perf_counter()
        parsed_h = ed.parse_and_hash(pks, msgs, sigs)
        packed_h = ed.pack_rlc(pks, msgs, sigs, parsed=parsed_h)
        rec["host_hash_pack_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = ed.parse_batch(pks, sigs)
        packed = ed.pack_rlc_device_hash(pks, msgs, [b""] * n, parsed=parsed)
        rec["device_hash_pack_seconds"] = time.perf_counter() - t0
        use_a_cache, ed.USE_A_CACHE = ed.USE_A_CACHE, False
        try:
            t0 = time.perf_counter()
            ok_h, verdicts_h = cb._device_verify(
                pks, ed.parse_and_hash(pks, msgs, sigs), torch.device(DEVICE))
            rec["host_hash_route_seconds"] = time.perf_counter() - t0
        finally:
            ed.USE_A_CACHE = use_a_cache
        want = _oracle(state, (pks, msgs, sigs))
        differ = [i for i in range(n)
                  if not verdicts[i] == verdicts_h[i] == want[i]]
        check(not differ and ok == ok_h == all(want), f"hash {label}: "
              "verdicts differ from the host-hash route's or "
              f"ed25519_ref.verify's at {differ[:8]}")
        need = {}
        if packed is not None:
            host_launches, host_ok = _rlc_launches(torch, packed_h)
            dev_ok = ed.rlc_verify_hash(packed, device=DEVICE)
            check(dev_ok == host_ok, f"hash {label}: rlc_verify_hash "
                  f"{dev_ok}, host-hash program {host_ok}")
            need = _merge(host_launches, {"sha512_blocks": 1})
            rec["host_hash_rlc_launches"] = host_launches
            if DEVICE == "cuda" and label in ("window", "batch"):
                rec["breakdown"] = _hash_breakdown(torch, packed)
                rec["host_syncs"] = syncs = _program_syncs(torch, packed,
                                                           packed_h)
                check(syncs["device_hash_program"] == 0
                      and syncs["control_one_copy"] == 1
                      and syncs["verdicts"] == [host_ok, host_ok],
                      f"hash {label}: the device-hash program made the "
                      f"host wait for the card: {syncs}")
            if label != "window_bad":    # the window's width once
                k9_inputs.append((label, packed[5:8], ram))
        if not ok:
            need = _merge(need, {"sha512_blocks": 1, **PERSIG_LAUNCHES})
        check(rec["launches"] == need, f"hash {label} launched "
              f"{rec['launches']}, not {need}")
        if label == "window_bad":
            a, r, s, bh, bl, nb, valid = ed.pack_batch_device_hash(
                pks, msgs, [b""] * n, n, parsed=parsed)
            k9_inputs.append(("window localization", (bh, bl, nb), ram))
    for name, fn in _kernels().items():  # comparison launches do not count
        fn.launches = state["hash_launches"][name]
    state["k9_inputs"] = k9_inputs
    state["valset_leaves"] = leaves
    return {"warm_up_seconds": warm_s, "path_seconds": path_s, "cases": rows,
            "valset": {"validators": N_VALSET, "seconds": valset_s,
                       "launches": valset_launches,
                       "stages_ms": valset_stages},
            "below_threshold": {"messages": len(below),
                                "launches": below_launches},
            "launches": state["hash_launches"]}


# -- phase 7: secp256k1 ------------------------------------------------------

def _secp_pubkeys(seeds):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    return [sk.PrivKey.generate(s).pub_key().bytes() for s in seeds]


def _secp_sign(jobs):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    return [sk.PrivKey.generate(seed).sign(msg) for seed, msg in jobs]


def _secp_verify(jobs):
    """The host oracle: crypto/secp256k1._verify_py behind the lower-S
    parse and the key decompression."""
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    return [len(pk) == sk.PUBKEY_SIZE and sk.PubKey(pk).verify_signature(m, s)
            for pk, m, s in jobs]


def _secp_oracle(state, items):
    """_verify_py of each (pubkey, msg, sig), in the pool, once a run."""
    known = state.setdefault("secp_oracle", {})
    todo = sorted({t for t in zip(*items) if t not in known})
    known.update(zip(todo, _pool_map(state["pool"], _secp_verify, todo)))
    return [known[t] for t in zip(*items)]


def _secp_present(h_idx, i):
    """Window height h_idx leaves SECP_ABSENT validators absent, a block
    that moves with the height, so the window's commits cover every key."""
    return (i - h_idx * SECP_ABSENT) % N_VALS >= SECP_ABSENT


def _bench_secp_seed(i, fill):
    """bench.py's secp256k1 key seeds: bytes([i & 0xFF, i >> 8] + [fill] * 30)."""
    return bytes([i & 0xFF, i >> 8] + [fill] * 30)


def _secp_fixtures(state):
    """The secp phase's keys and signatures, signed in the pool: a
    150-validator all-secp256k1 set, its commit (height 7, all present)
    and a window of 48 commits (each with 49 validators absent, the
    absent block moving, so the window covers all 150 keys); bench.py's
    batch (4,096 signatures over 128 keys) and mixed commit (9,000
    ed25519 + 1,000 secp256k1 signatures, 128 keys of each type)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.types import block, canonical
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    pool = state["pool"]
    t0 = time.perf_counter()
    seeds = [_seed("secp validator", i) for i in range(N_VALS)]
    pubs = _pool_map(pool, _secp_pubkeys, seeds)
    vals = ValidatorSet([Validator(sk.PubKey(p), 10) for p in pubs])
    seed_of = {sk.PubKey(p).address(): s for p, s in zip(pubs, seeds)}
    heights = [SECP_COMMIT_HEIGHT] + [2000 + h for h in range(WINDOW)]
    rows, jobs = {}, []
    for h in heights:
        bid = block.BlockID(_seed("secp block", h), block.PartSetHeader(
            1, _seed("secp parts", h)))
        rows[h] = (bid, [])
        for i, v in enumerate(vals.validators):
            if h != SECP_COMMIT_HEIGHT and not _secp_present(h - 2000, i):
                rows[h][1].append(None)
                continue
            ts = Timestamp(1_700_000_000 + h, 1000 * i + 9)
            sb = canonical.vote_sign_bytes(CHAIN_ID, canonical.PRECOMMIT, h, 0,
                                           bid, ts)
            rows[h][1].append((v.address, ts))
            jobs.append((seed_of[v.address], sb))
    batch_seeds = [_bench_secp_seed(i, 11) for i in range(SECP_KEYS)]
    batch_msgs = [i.to_bytes(8, "little") * 8 for i in range(SECP_BATCH)]
    mixed_ed_seeds = [bytes([i + 1]) * 32 for i in range(SECP_KEYS)]
    mixed_sk_seeds = [_bench_secp_seed(i, 7) for i in range(SECP_KEYS)]
    mixed_msgs = [b"mixed-commit-" + i.to_bytes(8, "little") * 4
                  for i in range(MIXED_ED + MIXED_SECP)]
    sk_jobs = jobs + [(batch_seeds[i % SECP_KEYS], m)
                      for i, m in enumerate(batch_msgs)] + \
        [(mixed_sk_seeds[i % SECP_KEYS], mixed_msgs[MIXED_ED + i])
         for i in range(MIXED_SECP)]
    ed_jobs = [(mixed_ed_seeds[i % SECP_KEYS], mixed_msgs[i])
               for i in range(MIXED_ED)]
    sk_sigs = iter(_pool_map(pool, _secp_sign, sk_jobs))
    ed_sigs = _pool_map(pool, _sign, ed_jobs)
    batch_pubs = _pool_map(pool, _secp_pubkeys, batch_seeds)
    mixed_sk_pubs = _pool_map(pool, _secp_pubkeys, mixed_sk_seeds)
    mixed_ed_pubs = _pool_map(pool, _pubkeys, mixed_ed_seeds)
    commits = {}
    for h in heights:
        bid, slots = rows[h]
        cs = [block.CommitSig.absent() if s is None else
              block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, s[0], s[1],
                              next(sk_sigs)) for s in slots]
        commits[h] = (bid, block.Commit(h, 0, bid, cs))
    batch = ([batch_pubs[i % SECP_KEYS] for i in range(SECP_BATCH)],
             batch_msgs, [next(sk_sigs) for _ in range(SECP_BATCH)])
    mixed = [(ed.PubKey(mixed_ed_pubs[i % SECP_KEYS]), mixed_msgs[i],
              ed_sigs[i]) for i in range(MIXED_ED)]
    mixed += [(sk.PubKey(mixed_sk_pubs[i % SECP_KEYS]),
               mixed_msgs[MIXED_ED + i], next(sk_sigs))
              for i in range(MIXED_SECP)]
    state["secp"] = {"vals": vals, "commits": commits,
                     "heights": heights[1:], "batch": batch, "mixed": mixed}
    return {"secp_signatures": len(sk_jobs), "ed25519_signatures":
            len(ed_jobs), "signing_seconds": time.perf_counter() - t0}


def _secp_hostile(batch):
    """The 4,096 batch with one signature of each hostile class, all past
    the first 128 lanes so that the key set keeps its order: r = 0, s >= n,
    the high-s twin of a valid signature, a key that fails to decompress
    (x >= p), a tampered message, and r + n < p (r = 5: rn_valid set, the
    verdict false)."""
    from cometbft_tpu_torch.crypto import secp256k1 as sk

    pubs, msgs, sigs = (list(x) for x in batch)
    i = [SECP_BATCH // 8 * k + 1 for k in range(1, 7)]
    sigs[i[0]] = b"\x00" * 32 + sigs[i[0]][32:]
    sigs[i[1]] = sigs[i[1]][:32] + (sk.N + 3).to_bytes(32, "big")
    s = int.from_bytes(sigs[i[2]][32:], "big")
    sigs[i[2]] = sigs[i[2]][:32] + (sk.N - s).to_bytes(32, "big")
    pubs[i[3]] = b"\x03" + (sk.P + 2).to_bytes(33, "big")[1:]
    msgs[i[4]] = msgs[i[4]] + b"?"
    sigs[i[5]] = (5).to_bytes(32, "big") + sigs[i[5]][32:]
    check(5 + sk.N < sk.P, "r + n < p case")
    return (pubs, msgs, sigs), i


def _secp_verifier(state, items, n_hint=None):
    """create_batch_verifier("secp256k1") on the card over `items`: (ok,
    verdicts, seconds)."""
    from cometbft_tpu_torch.crypto import batch as cb

    bv = cb.create_batch_verifier("secp256k1", n_hint=n_hint or len(items[0]),
                                  device=DEVICE)
    for p, m, s in zip(*items):
        bv.add(p, m, s)
    t0 = time.perf_counter()
    ok, verdicts = bv.verify()
    return ok, verdicts, time.perf_counter() - t0


def _secp_split_order(torch, items, devices):
    """crypto/mesh.split_secp_verify over `devices` under torch's sync
    debug mode: the host waits counted before each chunk's launch (all
    0: every chunk launched before the first read) and in the whole call
    (one read per chunk)."""
    import warnings

    from cometbft_tpu_torch.crypto import mesh
    from cometbft_tpu_torch.crypto import secp256k1 as sk

    sync = _tool("host_syncs").SYNC_WARNING
    real, marks = sk.verify_msm_async, []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def spy(*a, **k):
            marks.append(sum(sync in str(w.message) for w in caught))
            return real(*a, **k)
        sk.verify_msm_async = spy
        torch.cuda.set_sync_debug_mode("warn")
        try:
            verdicts = mesh.split_secp_verify(*items, devices)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            sk.verify_msm_async = real
    torch.cuda.synchronize()
    return marks, sum(sync in str(w.message) for w in caught), verdicts


def phase_secp(state, torch):
    """The secp256k1 path on the card, with the counts set to 0 just
    before it and read just after (a warm-up call on a small batch comes
    first, outside the count: the first call builds the static G table
    on the host).  Each step's launches are exact: the MSM program is
    one K12 a call plus K11 on a key-table miss, the ladder one K13.
    Steps: the 150-validator commit (accept, one bad signature named by
    index); the window twice (the second a QTableCache hit) and with one
    bad signature named by height; the 4,096 batch clean and hostile on
    the MSM program and on the ladder (COMETBFT_TPU_SECP_MSM=0); the mixed
    commit (9,000 ed25519 + 1,000 secp256k1, one bad signature of each)
    through MixedBatchVerifier; the split over two devices.  Every verdict
    is held against _verify_py (ed25519: ed25519_ref.verify).  Then,
    outside the count: the host waits inside verify_msm_async (none
    allowed), the split's launch order, and the host packing time."""
    import numpy as np

    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.types import validation as val

    fixtures = _secp_fixtures(state)
    sp = state["secp"]
    vals = sp["vals"]
    warm = tuple(x[:SECP_KEYS] for x in sp["batch"])
    t0 = time.perf_counter()
    check(all(sk.verify_msm_batch(*warm, device=DEVICE)), "warm-up rejected")
    warm_s = time.perf_counter() - t0
    sk._Q_CACHE = cache = sk.QTableCache()
    _zero_counts()                          # the secp path starts here
    t_path = time.perf_counter()
    steps = []

    def step(label, fn, want):
        before, h0, m0 = _counts(), cache.hits, cache.misses
        t0 = time.perf_counter()
        out = fn()
        rec = {"step": label, "seconds": time.perf_counter() - t0,
               "launches": _launched(before, _counts()),
               "table_hits": cache.hits - h0,
               "table_misses": cache.misses - m0}
        check(rec["launches"] == want(rec), f"secp {label} launched "
              f"{rec['launches']}, not {want(rec)}")
        steps.append(rec)
        return out

    def msm(rec):
        return {"secp_msm_verify": 1,
                **({"secp_q_tables": rec["table_misses"]}
                   if rec["table_misses"] else {})}

    # commit: 101 signatures (K = 128) at the device threshold of 96
    bid, commit = sp["commits"][SECP_COMMIT_HEIGHT]
    step("commit accept", lambda: val.verify_commit_light(
        CHAIN_ID, vals, bid, SECP_COMMIT_HEIGHT, commit, device=DEVICE), msm)
    bad_idx = N_VALS // 5
    tampered, s = _with_sig(commit, bad_idx, 11, 0x40)

    def commit_reject():
        try:
            val.verify_commit_light(CHAIN_ID, vals, bid, SECP_COMMIT_HEIGHT,
                                    tampered, device=DEVICE)
            raise PhaseError("tampered secp256k1 commit accepted")
        except val.ErrInvalidSignature as e:
            check(str(e) == f"wrong signature (#{bad_idx}): {s.hex()}",
                  f"wrong message {e}")
    step("commit reject", commit_reject, msm)

    # window: 48 x 101 signatures over all 150 keys (K = 192)
    commits = [(h, sp["commits"][h]) for h in sp["heights"]]

    def window(cs):
        batch = val.DeferredSigBatch()
        for h, (b, c) in cs:
            val.verify_commit_light(CHAIN_ID, vals, b, h, c, defer_to=batch,
                                    device=DEVICE)
        n = batch.count()
        batch.verify(device=DEVICE)
        return n
    n_window = step("window", lambda: window(commits), msm)
    step("window again", lambda: window(commits), msm)
    check([r["table_misses"] for r in steps[-2:]] == [1, 0] and
          steps[-1]["table_hits"] == 1, "the second window missed the "
          f"QTableCache: {steps[-2:]}")
    bad_h = sp["heights"][len(sp["heights"]) // 2]
    bad_v = [i for i in range(N_VALS) if _secp_present(bad_h - 2000, i)][4]
    bad_commit, s_bad = _with_sig(sp["commits"][bad_h][1], bad_v, 12, 0x01)
    bad = [(h, (b, bad_commit if h == bad_h else c)) for h, (b, c) in commits]

    def window_reject():
        try:
            window(bad)
            raise PhaseError("bad secp256k1 window accepted")
        except val.ErrInvalidSignature as e:
            check(getattr(e, "failed_ctx", None) == bad_h and str(e) ==
                  f"wrong signature in commit at height {bad_h}: "
                  f"{s_bad.hex()}", f"blamed {getattr(e, 'failed_ctx', None)}:"
                  f" {e}")
    step("window reject", window_reject, msm)

    # the 4,096 batch on both programs
    hostile, bad_i = _secp_hostile(sp["batch"])
    want_clean = _secp_oracle(state, sp["batch"])
    want_hostile = _secp_oracle(state, hostile)
    check(all(want_clean) and [i for i, v in enumerate(want_hostile)
                               if not v] == bad_i, "secp oracle")
    routes = {}
    for program, env in (("msm", "1"), ("ladder", "0")):
        old = os.environ.get("COMETBFT_TPU_SECP_MSM")
        os.environ["COMETBFT_TPU_SECP_MSM"] = env
        want = msm if program == "msm" else (
            lambda rec: {"secp_ladder": 1})
        try:
            for label, items, oracle in (("clean", sp["batch"], want_clean),
                                         ("hostile", hostile, want_hostile)):
                ok, verdicts, secs = step(
                    f"batch {label} {program}",
                    lambda items=items: _secp_verifier(state, items), want)
                differ = [i for i, (a, b) in enumerate(zip(verdicts, oracle))
                          if a != b]
                check(not differ and ok == all(oracle), f"secp batch {label} "
                      f"{program}: verdicts differ from _verify_py at "
                      f"{differ[:8]}")
                routes[f"{label}_{program}"] = {
                    "seconds": secs, "sigs_per_s": SECP_BATCH / secs,
                    "rejected": [i for i, v in enumerate(verdicts) if not v]}
        finally:
            if old is None:
                os.environ.pop("COMETBFT_TPU_SECP_MSM", None)
            else:
                os.environ["COMETBFT_TPU_SECP_MSM"] = old

    # mixed: 9,000 ed25519 + 1,000 secp256k1, one bad of each
    items = list(sp["mixed"])
    bad_m = (MIXED_ED // 3, MIXED_ED + MIXED_SECP // 2)
    for i in bad_m:
        pk, m, s = items[i]
        items[i] = (pk, m + b"!", s)

    def mixed():
        mv = cb.MixedBatchVerifier(device=DEVICE)
        for it in items:
            mv.add(*it)
        return mv.verify()
    with _persig(torch) as persig:
        ok, verdicts = step("mixed", mixed,
                            lambda rec: {**msm(rec), **MIXED_ED_LAUNCHES})
    _check_persig(persig, "mixed commit", MIXED_ED)
    want_ed = _oracle(state, tuple(zip(*[(p.bytes(), m, s)
                                         for p, m, s in items[:MIXED_ED]])))
    want_sk = _secp_oracle(state, tuple(zip(*[(p.bytes(), m, s)
                                              for p, m, s in
                                              items[MIXED_ED:]])))
    check(verdicts == want_ed + want_sk and not ok and
          [i for i, v in enumerate(verdicts) if not v] == list(bad_m),
          "mixed verdicts differ from the oracles")

    # the split over two devices: every chunk's verdicts, in order
    devices = _mesh_devices(torch, 2)
    split_items = hostile
    from cometbft_tpu_torch.crypto import mesh
    split = step("split", lambda: mesh.split_secp_verify(*split_items,
                                                         devices), lambda rec: {
        "secp_msm_verify": 2,
        **({"secp_q_tables": rec["table_misses"]}
           if rec["table_misses"] else {})})
    check(split == want_hostile, "split verdicts differ from _verify_py")
    path_s = time.perf_counter() - t_path
    state["secp_launches"] = _counts()
    for name in SECP_KERNELS:
        check(state["secp_launches"][name] > 0, f"the secp path launched no "
              f"{name}")

    # outside the count: host waits, the split's order, host packing
    syncs = {}
    if DEVICE == "cuda":
        count_waits = _tool("host_syncs").count_waits
        card = torch.device(DEVICE)
        n_copy, _ = count_waits(torch, lambda: torch.as_tensor(
            np.arange(4), device=card))
        n_async, (verdict, valid, n) = count_waits(
            torch, sk.verify_msm_async, *hostile)
        check(n_async == 0 and n_copy == 1 and
              (verdict.cpu().numpy() & valid)[:n].tolist() == want_hostile,
              f"verify_msm_async made the host wait {n_async} times "
              f"(control {n_copy})")
        marks, reads, verdicts = _secp_split_order(torch, hostile, devices)
        check(marks == [0] * len(devices) and reads == len(devices) and
              verdicts == want_hostile, "the split read a verdict before "
              f"its last launch: waits before each launch {marks}, {reads} "
              "in all")
        syncs = {"verify_msm_async": n_async, "control_one_copy": n_copy,
                 "split_waits_before_each_launch": marks,
                 "split_reads": reads}
    t0 = time.perf_counter()
    sk.pack_msm_batch(*sp["batch"], SECP_BATCH)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk.pack_batch(*sp["batch"], SECP_BATCH)
    ladder_pack_s = time.perf_counter() - t0
    for name, fn in _kernels().items():  # the checks' launches do not count
        fn.launches = state["secp_launches"][name]
    return {"fixtures": fixtures, "warm_up_seconds": warm_s,
            "path_seconds": path_s, "window_signatures": n_window,
            "steps": steps, "batch": routes,
            "host_syncs": syncs,
            "host_pack_seconds": {"pack_msm_batch": pack_s,
                                  "pack_batch": ladder_pack_s},
            "launches": state["secp_launches"]}


# -- phase 8: sr25519 ---------------------------------------------------------

def _sr_pubkeys(seeds):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import sr25519 as sr
    return [sr.PrivKey.generate(s).pub_key().bytes() for s in seeds]


def _sr_sign(jobs):
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import sr25519 as sr
    return [sr.PrivKey.generate(seed).sign(msg) for seed, msg in jobs]


def _sr_verify(jobs):
    """The host oracle: the port's CpuSr25519BatchVerifier (schnorrkel's
    cofactorless equation on ristretto points, in pure Python)."""
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import sigcache

    sigcache.set_enabled(False)
    bv = cb.CpuSr25519BatchVerifier()
    for pk, m, s in jobs:
        bv.add(pk, m, s)
    return bv.verify()[1] if jobs else []


def _sr_oracle(state, items):
    """CpuSr25519BatchVerifier's verdict on each (pubkey, msg, sig), in
    the pool, once a run."""
    known = state.setdefault("sr_oracle", {})
    todo = sorted({t for t in zip(*items) if t not in known})
    known.update(zip(todo, _pool_map(state["pool"], _sr_verify, todo)))
    return [known[t] for t in zip(*items)]


def _typed_oracle(state, triples):
    """The host oracle of each (key object, msg, sig) by its key type:
    ed25519_ref.verify, _verify_py or CpuSr25519BatchVerifier."""
    by_type = {"ed25519": _oracle, "secp256k1": _secp_oracle,
               "sr25519": _sr_oracle}
    slots, groups = [], {}
    for pk, m, s in triples:
        g = groups.setdefault(pk.type(), [])
        slots.append((pk.type(), len(g)))
        g.append((pk.bytes(), m, s))
    got = {kt: by_type[kt](state, tuple(zip(*g))) for kt, g in groups.items()}
    return [got[kt][i] for kt, i in slots]


def _sr_fixtures(state):
    """The sr25519 phase's keys and signatures, signed in the pool: a
    150-validator sr25519 set, its commit (all present) and a window of 48
    commits; the BASELINE mixed set (50 ed25519, 50 secp256k1 and 50
    sr25519 keys) and its commit; 1,000 sr25519 signatures over 128 keys
    for MixedBatchVerifier."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.crypto import sr25519 as sr
    from cometbft_tpu_torch.types import block, canonical
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    pool = state["pool"]
    t0 = time.perf_counter()
    seeds = [_seed("sr25519 validator", i) for i in range(N_VALS)]
    m_seeds = {kt: [_seed(f"mixed {kt}", i) for i in range(SR_MIXED_KEYS)]
               for kt in ("ed25519", "secp256k1", "sr25519")}
    b_seeds = [_seed("sr25519 batch", i) for i in range(SECP_KEYS)]
    sr_pubs = _pool_map(pool, _sr_pubkeys, seeds + m_seeds["sr25519"]
                        + b_seeds)
    pubs = sr_pubs[:N_VALS]
    m_pubs = {"sr25519": sr_pubs[N_VALS:N_VALS + SR_MIXED_KEYS],
              "ed25519": _pool_map(pool, _pubkeys, m_seeds["ed25519"]),
              "secp256k1": _pool_map(pool, _secp_pubkeys,
                                     m_seeds["secp256k1"])}
    b_pubs = sr_pubs[N_VALS + SR_MIXED_KEYS:]
    key_cls = {"ed25519": ed.PubKey, "secp256k1": sk.PubKey,
               "sr25519": sr.PubKey}
    vals = ValidatorSet([Validator(sr.PubKey(p), 10) for p in pubs])
    mvals = ValidatorSet([Validator(key_cls[kt](p), 10)
                          for kt, ps in m_pubs.items() for p in ps])
    seed_of = {sr.PubKey(p).address(): ("sr25519", s)
               for p, s in zip(pubs, seeds)}
    for kt, ps in m_pubs.items():
        seed_of.update({key_cls[kt](p).address(): (kt, s)
                        for p, s in zip(ps, m_seeds[kt])})

    heights = [SR_COMMIT_HEIGHT] + [SR_WINDOW_BASE + h for h in range(WINDOW)]
    rows, jobs = {}, {"ed25519": [], "secp256k1": [], "sr25519": []}
    for h, vs in [(h, vals) for h in heights] + [(SR_MIXED_HEIGHT, mvals)]:
        bid = block.BlockID(_seed("sr25519 block", h), block.PartSetHeader(
            1, _seed("sr25519 parts", h)))
        rows[h] = (bid, [])
        for i, v in enumerate(vs.validators):
            ts = Timestamp(1_700_000_000 + h, 1000 * i + 11)
            sb = canonical.vote_sign_bytes(CHAIN_ID, canonical.PRECOMMIT, h, 0,
                                           bid, ts)
            kt, seed = seed_of[v.address]
            rows[h][1].append((v.address, ts, kt, len(jobs[kt])))
            jobs[kt].append((seed, sb))
    b_msgs = [b"mixed-commit-sr25519-" + i.to_bytes(8, "little") * 4
              for i in range(MIXED_SR)]
    b_first = len(jobs["sr25519"])
    jobs["sr25519"] += [(b_seeds[i % SECP_KEYS], m)
                        for i, m in enumerate(b_msgs)]
    sigs = {"sr25519": _pool_map(pool, _sr_sign, jobs["sr25519"]),
            "ed25519": _pool_map(pool, _sign, jobs["ed25519"]),
            "secp256k1": _pool_map(pool, _secp_sign, jobs["secp256k1"])}
    commits = {}
    for h, (bid, slots) in rows.items():
        cs = [block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, addr, ts,
                              sigs[kt][j]) for addr, ts, kt, j in slots]
        commits[h] = (bid, block.Commit(h, 0, bid, cs))
    batch = [(sr.PubKey(b_pubs[i % SECP_KEYS]), m,
              sigs["sr25519"][b_first + i]) for i, m in enumerate(b_msgs)]
    state["sr25519"] = {"vals": vals, "mvals": mvals, "commits": commits,
                        "heights": heights[1:], "batch": batch}
    return {"sr25519_signatures": len(jobs["sr25519"]),
            "ed25519_signatures": len(jobs["ed25519"]),
            "secp256k1_signatures": len(jobs["secp256k1"]),
            "signing_seconds": time.perf_counter() - t0}


class _Accum:
    """Stands in for a module function: adds up its calls' host
    seconds."""

    def __init__(self, mod, attr):
        self.mod, self.attr, self.fn = mod, attr, getattr(mod, attr)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        setattr(self.mod, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


class _SrPacks:
    """Keeps the pack_rlc and pack_batch results that the sr25519
    verifier makes (CudaSr25519BatchVerifier only, in whichever thread),
    for the kernels phase to hold K1-K4 and K14 against their plain
    versions at the sr25519 path's shapes."""

    def __init__(self, state):
        import threading

        self.state, self.tls = state, threading.local()

    def __enter__(self):
        from cometbft_tpu_torch.crypto import batch as cb
        from cometbft_tpu_torch.crypto import ed25519 as ed

        self.saved = [(cb.CudaSr25519BatchVerifier, "_verify_items",
                       cb.CudaSr25519BatchVerifier._verify_items),
                      (ed, "pack_rlc", ed.pack_rlc),
                      (ed, "pack_batch", ed.pack_batch)]
        tls, packs = self.tls, self.state.setdefault("sr_packs", {})
        verify, pack_rlc, pack_batch = (s[2] for s in self.saved)

        def mark(bv):
            tls.items = bv._items
            try:
                return verify(bv)
            finally:
                tls.items = None

        def keep(kind, fn):
            def run(*a, **k):
                out = fn(*a, **k)
                items = getattr(tls, "items", None)
                if items is not None and out is not None:
                    packs.setdefault((kind, int(out[1].shape[-1])),
                                     (out, list(items)))
                return out
            return run
        cb.CudaSr25519BatchVerifier._verify_items = mark
        ed.pack_rlc = keep("rlc", pack_rlc)
        ed.pack_batch = keep("persig", pack_batch)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def _sr_window_stages(state, torch, commits):
    """The window once more with each host stage of its sr25519 path
    timed (summed over its calls): collecting the 48 commits
    (verify_commit_light with defer_to), ristretto decode, the Merlin
    challenge, the Edwards compression (the three inside
    to_edwards_inputs), pack_rlc, and the device program (rlc_verify, its
    verdict read back).  (signatures, ms by stage, calls by stage)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.crypto import ristretto as rst
    from cometbft_tpu_torch.crypto import sr25519 as sr
    from cometbft_tpu_torch.types import validation as val

    with _Accum(rst, "decode") as dec, \
            _Accum(sr, "challenge_scalar") as chal, \
            _Accum(ref, "point_compress") as comp, \
            _Accum(sr, "to_edwards_inputs") as conv, \
            _Accum(ed, "pack_rlc") as pack, \
            _Timed(ed, "rlc_verify", torch) as rlc:
        t0 = time.perf_counter()
        batch = val.DeferredSigBatch()
        for h, (bid, commit) in commits:
            val.verify_commit_light(CHAIN_ID, state["sr25519"]["vals"], bid,
                                    h, commit, defer_to=batch, device=DEVICE)
        n = batch.count()
        t1 = time.perf_counter()
        batch.verify(device=DEVICE)
        t2 = time.perf_counter()
    ms = {"collect": t1 - t0, "ristretto_decode": dec.seconds,
          "merlin_challenge": chal.seconds, "edwards_compress": comp.seconds,
          "to_edwards_inputs": conv.seconds, "pack_rlc": pack.seconds,
          "rlc_verify": rlc.seconds, "verify": t2 - t1, "window": t2 - t0}
    return n, {k: v * 1e3 for k, v in ms.items()}, {
        "ristretto_decode": dec.calls, "merlin_challenge": chal.calls,
        "edwards_compress": comp.calls, "to_edwards_inputs": conv.calls,
        "rlc_verify": rlc.calls}


def _expect_raise(fn, label, message, ctx=None):
    from cometbft_tpu_torch.types import validation as val

    try:
        fn()
    except val.ErrInvalidSignature as e:
        check(str(e) == message, f"{label}: wrong message {e}")
        check(ctx is None or getattr(e, "failed_ctx", None) == ctx,
              f"{label}: blamed {getattr(e, 'failed_ctx', None)}, not {ctx}")
        return str(e)
    raise PhaseError(f"{label} accepted")


def phase_sr25519(state, torch):
    """The sr25519 path on the card (crypto/sr25519 on the Edwards
    kernels K1-K4, K14 for each localization), with the verdict cache
    off and the counts set to 0 just before it and read just after.
    A fresh A-table cache, so each step's RLC program is known: the whole
    program at a key set's first sighting, the table built at its second
    (the same launches), the cached-A program (RLC_HIT) after.  Steps:
    the 150-validator commit (101 signatures, K = N = 128) accepted; the
    48-commit window (4,848 signatures over 101 keys, K = 128, N = 5,120)
    as its table is built and on its table hit, the second run with its
    host stages timed; the commit with one signature's s flipped (one
    RLC program and one more K1 and K14, over its 101); the window with
    one bad signature (its height named, one localization over 4,848);
    BASELINE's mixed commit (50 keys of each type, through verify_commit:
    accepted, then one bad signature of each type, the first in commit
    order named); MixedBatchVerifier over the secp phase's mixed items
    and 1,000 sr25519 signatures over 128 keys, one bad of each type,
    launching exactly its three sub-batches' kernels.  Every verdict is
    the host oracle's (CpuSr25519BatchVerifier, ed25519_ref.verify,
    _verify_py)."""
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.types import validation as val

    check(not sigcache.enabled(), "the verdict cache is on")
    fixtures = _sr_fixtures(state)
    s = state["sr25519"]
    vals, mvals = s["vals"], s["mvals"]
    commits = [(h, s["commits"][h]) for h in s["heights"]]
    ed._A_TABLE_CACHE = cache = ed.ATableCache()
    qcache = sk.q_table_cache()
    _zero_counts()                          # the sr25519 path starts here
    t_path = time.perf_counter()
    steps = []

    def step(label, fn, widths=(), programs=None):
        before, h0, m0 = _counts(), cache.hits, cache.misses
        q0 = qcache.misses
        with _Timed(ed, "rlc_verify", torch) as rlc, \
                _persig(torch) as persig, \
                _Timed(sk, "verify_msm_batch", torch) as msm:
            t0 = time.perf_counter()
            out = fn()
            secs = time.perf_counter() - t0
        rec = {"step": label, "seconds": secs,
               "launches": _launched(before, _counts()),
               "rlc_programs": len(rlc.each), "table_hits": cache.hits - h0,
               "table_builds": cache.misses - m0,
               "localization_widths": sorted(persig.widths)}
        # the calls are counted by list appends: the mixed steps run their
        # sub-batches in threads
        want = _merge(*([RLC_HIT] * rec["table_hits"]
                        + [RLC_WHOLE] * (len(rlc.each) - rec["table_hits"])
                        + [PERSIG_LAUNCHES] * len(persig.each)
                        + [{"secp_msm_verify": len(msm.each),
                            "secp_q_tables": qcache.misses - q0}]))
        want = {k: v for k, v in want.items() if v}
        check(rec["launches"] == want, f"sr25519 {label} launched "
              f"{rec['launches']}, not {want}")
        check(rec["localization_widths"] == sorted(widths), f"sr25519 {label}"
              f": localizations over {rec['localization_widths']} lanes, not "
              f"{sorted(widths)}")
        if programs is not None:
            got = (len(rlc.each), rec["table_builds"], rec["table_hits"])
            check(got == programs, f"sr25519 {label}: (RLC programs, table "
                  f"builds, table hits) {got}, not {programs}")
        steps.append(rec)
        return out

    bid, commit = s["commits"][SR_COMMIT_HEIGHT]
    with _SrPacks(state):
        step("commit accept", lambda: val.verify_commit_light(
            CHAIN_ID, vals, bid, SR_COMMIT_HEIGHT, commit, device=DEVICE),
            programs=(1, 0, 0))
        check(steps[-1]["launches"] == RLC_WHOLE, "the sr25519 commit's "
              "accept is not phase_commit's whole RLC program")
        n = step("window, table built", lambda: _run_window(
            state, val, commits, vals), programs=(1, 1, 0))
        n_hit, stage_ms, stage_calls = step(
            "window, table hit, stages timed",
            lambda: _sr_window_stages(state, torch, commits),
            programs=(1, 0, 1))
        check(n == n_hit == WINDOW * COMMIT_SIGS, f"windows of {n} and "
              f"{n_hit} signatures")
        runs = [{"step": st["step"], "signatures": n,
                 "sigs_per_s": n / st["seconds"]} for st in steps[-2:]]

        bad_idx = N_VALS // 3
        tampered, sig = _with_sig(commit, bad_idx, 40, 0x20)
        step("commit reject", lambda: _expect_raise(
            lambda: val.verify_commit_light(CHAIN_ID, vals, bid,
                                            SR_COMMIT_HEIGHT, tampered,
                                            device=DEVICE),
            "sr25519 commit reject", f"wrong signature (#{bad_idx}): "
            f"{sig.hex()}"), widths=[COMMIT_SIGS], programs=(1, 0, 1))
        bad_h = s["heights"][len(s["heights"]) // 4]
        bad_commit, bad_sig = _with_sig(s["commits"][bad_h][1], 5, 40, 0x20)
        bad = [(h, (b, bad_commit if h == bad_h else c)) for h, (b, c)
               in commits]
        step("window reject", lambda: _expect_raise(
            lambda: _run_window(state, val, bad, vals),
            "sr25519 window reject",
            f"wrong signature in commit at height {bad_h}: {bad_sig.hex()}",
            bad_h), widths=[WINDOW * COMMIT_SIGS], programs=(1, 0, 1))

        # BASELINE: Ed25519 + secp256k1 + sr25519 in one commit
        mbid, mcommit = s["commits"][SR_MIXED_HEIGHT]
        step("mixed commit accept", lambda: val.verify_commit(
            CHAIN_ID, mvals, mbid, SR_MIXED_HEIGHT, mcommit, device=DEVICE),
            programs=(2, 0, 0))
        kinds = [v.pub_key.type() for v in mvals.validators]
        bad_m = sorted(i for kt in ("ed25519", "secp256k1", "sr25519")
                       for i in [[j for j, k in enumerate(kinds)
                                  if k == kt][SR_MIXED_KEYS // 5]])
        mbad = mcommit
        for i in bad_m:
            mbad, _ = _with_sig(mbad, i, 40, 0x20)
        step("mixed commit reject", lambda: _expect_raise(
            lambda: val.verify_commit(CHAIN_ID, mvals, mbid, SR_MIXED_HEIGHT,
                                      mbad, device=DEVICE),
            "mixed commit reject", f"wrong signature (#{bad_m[0]}): "
            f"{mbad.signatures[bad_m[0]].signature.hex()}"),
            widths=[SR_MIXED_KEYS, SR_MIXED_KEYS], programs=(2, 2, 0))

        # MixedBatchVerifier: the secp phase's 9,000 + 1,000 and 1,000 sr25519
        items = list(state["secp"]["mixed"]) + list(s["batch"])
        bad_b = (MIXED_ED // 3, MIXED_ED + MIXED_SECP // 2,
                 MIXED_ED + MIXED_SECP + MIXED_SR // 2)
        for i in bad_b:
            pk, m, sg = items[i]
            items[i] = (pk, m + b"!", sg)

        def mixed():
            mv = cb.MixedBatchVerifier(device=DEVICE)
            for it in items:
                mv.add(*it)
            return mv.verify()
        ok, verdicts = step("mixed batch", mixed,
                            widths=[MIXED_ED, MIXED_SR], programs=(2, 0, 0))
    path_s = time.perf_counter() - t_path
    state["sr25519_launches"] = _counts()
    launched = {k for k, v in state["sr25519_launches"].items() if v}
    check(launched == DEFAULT_KERNELS | {"secp_msm_verify"} or
          launched == DEFAULT_KERNELS | {"secp_msm_verify", "secp_q_tables"},
          f"the sr25519 path launched {sorted(launched)}")

    # verdicts against the host oracles (outside the count)
    t0 = time.perf_counter()
    want = _typed_oracle(state, items)
    differ = [i for i, (a, b) in enumerate(zip(verdicts, want)) if a != b]
    check(not differ and not ok and
          [i for i, v in enumerate(want) if not v] == list(bad_b),
          f"mixed batch verdicts differ from the host oracles at {differ[:8]}")
    for label, triples, bad_at in (
            ("commit", _light_entries(vals, [(SR_COMMIT_HEIGHT,
                                              (bid, commit))]), []),
            ("commit reject", _light_entries(vals, [(SR_COMMIT_HEIGHT,
                                                     (bid, tampered))]),
             [bad_idx]),
            ("window", _light_entries(vals, commits), []),
            ("window reject", _light_entries(vals, bad),
             [bad_h]),
            ("mixed commit", [(v.pub_key, sb, cs.signature) for v, sb, cs in
                              zip(mvals.validators,
                                  mcommit.vote_sign_bytes_all(CHAIN_ID),
                                  mcommit.signatures)], []),
            ("mixed commit reject",
             [(v.pub_key, sb, cs.signature) for v, sb, cs in
              zip(mvals.validators, mbad.vote_sign_bytes_all(CHAIN_ID),
                  mbad.signatures)], bad_m)):
        got = _typed_oracle(state, triples)
        rejected = [i for i, v in enumerate(got) if not v]
        if label == "window reject":
            rejected = [s["heights"][i // COMMIT_SIGS] for i in rejected]
        check(rejected == bad_at, f"sr25519 {label}: the oracle rejects "
              f"{rejected[:8]}, not {bad_at}")
    oracle_s = time.perf_counter() - t0
    for name, fn in _kernels().items():  # the checks' launches do not count
        fn.launches = state["sr25519_launches"][name]
    return {"fixtures": fixtures, "path_seconds": path_s, "window_runs": runs,
            "window_stage_ms": stage_ms, "window_stage_calls": stage_calls,
            "steps": steps, "oracle_seconds": oracle_s,
            "launches": state["sr25519_launches"]}


# -- phase 9: the signature-verdict cache -------------------------------------

def phase_sigcache(state, torch):
    """The verdict cache on (set_enabled(True), reset()), with the counts
    set to 0 just before and read just after: the ed25519 and sr25519
    150-validator commits each verified twice (the first launches one RLC
    program, the second nothing); the tampered ed25519 commit verified
    twice on an empty cache (the first one RLC program and one
    localization, the second the same error and no launch); a 48-commit
    window whose first 24 commits were verified before (only the 2,424
    misses reach the card: K1's widths and the launches show it); the
    4,848-signature window re-verified with every triple a hit, its
    signatures per second through DeferredSigBatch and through
    sigcache.partition alone (bench.py's bench_commit_reverify).  The
    cache is off again at the end, and empty."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.ops import cuda_decompress
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.types import validation as val

    cache = ed._A_TABLE_CACHE
    sigcache.set_enabled(True)
    sigcache.reset()
    _zero_counts()                          # the cached path starts here
    steps = []
    try:
        def step(label, fn, hits_only=False):
            before, h0 = _counts(), cache.hits
            st0 = sigcache.cache().stats()
            k1 = _Widths(cuda_decompress.decompress, torch)
            cuda_decompress.decompress = k1
            try:
                with _Timed(ed, "rlc_verify", torch) as rlc, \
                        _persig(torch) as persig:
                    t0 = time.perf_counter()
                    out = fn()
                    secs = time.perf_counter() - t0
            finally:
                cuda_decompress.decompress = k1.fn
            st1 = sigcache.cache().stats()
            rec = {"step": label, "ms": secs * 1e3,
                   "launches": _launched(before, _counts()),
                   "rlc_programs": rlc.calls,
                   "localizations": persig.calls,
                   "k1_widths": k1.widths,
                   **{k: st1[k] - st0[k] for k in ("hits", "negative_hits",
                                                   "misses", "insertions")}}
            hits = cache.hits - h0
            want = _merge(*([RLC_HIT] * hits + [RLC_WHOLE] * (rlc.calls - hits)
                            + [PERSIG_LAUNCHES] * persig.calls))
            check(rec["launches"] == {k: v for k, v in want.items() if v},
                  f"sigcache {label} launched {rec['launches']}")
            if hits_only:
                check(rec["launches"] == {} and rec["misses"] == 0,
                      f"sigcache {label}: {rec['misses']} misses, launches "
                      f"{rec['launches']}")
            steps.append(rec)
            return out

        s = state["sr25519"]
        for label, vals, (bid, commit), h in (
                ("ed25519 commit", state["vals"], state["commits"][5], 5),
                ("sr25519 commit", s["vals"],
                 s["commits"][SR_COMMIT_HEIGHT], SR_COMMIT_HEIGHT)):
            for run, hits_only in (("first", False), ("again", True)):
                step(f"{label} {run}", lambda: val.verify_commit_light(
                    CHAIN_ID, vals, bid, h, commit, device=DEVICE), hits_only)
            check(steps[-2]["rlc_programs"] == 1 and
                  steps[-2]["misses"] == COMMIT_SIGS, f"{label}: first run "
                  f"{steps[-2]}")

        sigcache.reset()
        bid, commit = state["commits"][5]
        bad_idx = N_VALS // 4
        tampered, sig = _with_sig(commit, bad_idx, 11, 0x40)
        message = f"wrong signature (#{bad_idx}): {sig.hex()}"
        for run, hits_only in (("first", False), ("again", True)):
            step(f"ed25519 commit reject {run}", lambda: _expect_raise(
                lambda: val.verify_commit_light(
                    CHAIN_ID, state["vals"], bid, 5, tampered, device=DEVICE),
                "cached reject", message), hits_only)
        check(steps[-2]["localizations"] == 1 and
              steps[-1]["negative_hits"] >= 1, f"reject runs {steps[-2:]}")

        sigcache.reset()
        commits = [(h, state["commits"][h]) for h in state["heights"]]
        half = len(commits) // 2
        step("window, first 24 commits", lambda: _run_window(
            state, val, commits[:half]))
        n = step("window, 48 commits, 24 cached",
                 lambda: _run_window(state, val, commits))
        rec = steps[-1]
        misses = (len(commits) - half) * COMMIT_SIGS
        check(rec["hits"] == half * COMMIT_SIGS and rec["misses"] == misses
              and rec["rlc_programs"] == 1, f"partial window {rec}")
        check(max(rec["k1_widths"]) == max(steps[-2]["k1_widths"]) ==
              dev.pad_width(misses), f"K1 widths {rec['k1_widths']}: not "
              f"the {misses} misses' {dev.pad_width(misses)}")
        t0 = time.perf_counter()
        step("window re-verified, all hits",
             lambda: _run_window(state, val, commits), hits_only=True)
        reverify_s = time.perf_counter() - t0
        triples = _light_entries(state["vals"], commits)
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            verdicts, miss = sigcache.partition(triples, label="bench")
            check(not miss and all(verdicts), "partition missed")
        partition_s = time.perf_counter() - t0
        stats = sigcache.cache().stats()
    finally:
        sigcache.set_enabled(False)
        sigcache.reset()
    state["sigcache_launches"] = _counts()
    _zero_counts()
    return {"steps": steps, "window_signatures": n,
            "reverify_sigs_per_s": n / reverify_s,
            "partition_sigs_per_s": len(triples) * iters / partition_s,
            "cache_stats": stats, "launches": state["sigcache_launches"]}



# -- phase 10: the overlapped verify pipeline ---------------------------------

PIPE_WINDOWS = 8               # blocksync windows in a row, serial and piped
PIPE_BAD = 4                   # the fifth window carries the bad signature
PIPE_QOS_BULK = 6              # blocksync windows queued ahead of consensus
PIPE_DEADLINE_S = 1.0          # the hang step's watchdog deadline
PIPE_MESH = 4                  # windows over the two logical shards


def _collect(state, val, commits, vals=None):
    """`commits` collected into a DeferredSigBatch, as _run_window does,
    without verifying it."""
    batch = val.DeferredSigBatch()
    for h, (bid, commit) in commits:
        val.verify_commit_light(CHAIN_ID, state["vals"] if vals is None
                                else vals, bid, h, commit, defer_to=batch,
                                device=DEVICE)
    return batch


def _uncounted(fn):
    """Run a comparison (a serial reference, an oracle) with its launches
    taken back out of the counts.  No pipeline may be running."""
    saved = _counts()
    try:
        return fn()
    finally:
        for name, k in _kernels().items():
            k.launches = saved[name]


def _clean_pipe(pipe, label):
    """Outside the steps that inject a fault, no window of `pipe` may
    leave the device: no fault, host window, staging fallback or drain."""
    check(pipe.faults == pipe.host_windows == pipe.staging_fallbacks ==
          pipe.drained_windows == 0,
          f"{label}: {pipe.faults} faults, {pipe.host_windows} host windows, "
          f"{pipe.staging_fallbacks} staging fallbacks, "
          f"{pipe.drained_windows} drained")


def _rlc_want(hits, calls):
    """The launches of `calls` RLC programs of which `hits` ran on a
    cached A table (a table built on the spot launches as the whole
    program does)."""
    return _merge(*([RLC_HIT] * hits + [RLC_WHOLE] * (calls - hits)))


def _want_launches(got, want, label):
    want = {k: v for k, v in want.items() if v}
    check(got == want, f"{label}: launched {got}, not {want}")


def _real_dispatch(torch):
    """The pipeline's own device dispatch of an ed25519 window (or a
    probe window), for dispatch_fn wrappers that inject faults around
    it."""
    from cometbft_tpu_torch.crypto import batch as cb

    dev = torch.device(DEVICE)
    return lambda win: cb._device_verify(win.pks, win.parsed, dev,
                                         packed=win.packed)


def _pipe_items(state, heights):
    """The (pubkey bytes, msg, sig) triples DeferredSigBatch collects from
    the commits at `heights`, as one list, and their columns."""
    cols = _window_items(state, [(h, state["commits"][h]) for h in heights])
    return list(zip(*cols)), cols


def phase_pipeline(state, torch):
    """crypto/dispatch.VerifyPipeline on the card, its kernels launched
    from its dispatch threads (the verdict cache off but in step 7):
    1. eight blocksync windows (the window phase's 48 commits) through
       DeferredSigBatch.verify one after another, then through
       verify_async on VerifyPipeline(depth=2) with the machine's host
       pool: sigs/s both ways, each window's latency from the latency
       ledger, devprof's busy share and idle causes; exactly eight times
       a serial window's K1-K4, no K14, every path "device";
    2. the eight again with the fifth carrying the window phase's bad
       signature: its wait() raises as the serial call does, naming that
       height, with one more K1 and one K14 over the live lanes;
    3. two windows (clean, bad) under COMETBFT_TPU_DEVICE_HASH=1: the
       launches of the same two calls of crypto/batch._device_verify_hash
       (K9 among them) and the host-hash route's verdicts;
    4. the sr25519 phase's three-type commit (50 ed25519, 50 secp256k1
       and 50 sr25519 keys) and 64 more secp256k1 signatures of the secp
       phase's mixed batch (so that the secp256k1 sub-batch, 114 keys, is
       over the device crossover of 96) as one window, through
       MixedBatchVerifier, one bad sr25519 and one bad secp256k1
       signature: the host oracle's verdicts, twice, on the MSM program
       (K11, K12) and on the ladder (K13), every launch inside the
       dispatch thread's call;
    5. six blocksync windows queued, then one consensus window: it
       dispatches ahead of queued blocksync windows (EV_SCHED_PREEMPT,
       the scheduler's snapshot, the ledger's dispatch stamps), and each
       lane resolves in its submission order;
    6. dispatch_fn wrappers around the real dispatch: one raises once
       (its window and those behind it drain with the host's verdicts,
       the device goes SUSPECT and stays in rotation); one sleeps past a
       1 s deadline (the window resolves on the host, the device is
       QUARANTINED) until the probe, run on the card (K1-K4, then K1 +
       K14 for its corrupted lane), returns it to HEALTHY;
    7. a window submitted twice with the verdict cache on: the second
       resolves at submit, path "cache", with no launch;
    8. devices=["cuda:0", "cuda:0"] (logical shards) at depth 4: windows
       publish in submission order, each window's launches exact, each
       dispatch under its device's context.
    The counts are set to 0 before step 1 and read after step 8;
    comparisons run outside the count."""
    import threading

    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import devhealth
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.libs import devprof, flightrec, latledger
    from cometbft_tpu_torch.types import validation as val

    commits = [(h, state["commits"][h]) for h in state["heights"]]
    bad, bad_h = state["window_bad"]
    cache = ed._A_TABLE_CACHE
    out = {}
    # the window's A table on the card, so that every window below runs
    # the cached-A program on a table hit
    for _ in range(2):
        _collect(state, val, commits).verify(device=DEVICE)
    _zero_counts()                      # the pipeline path starts here

    # 1. serial against pipelined
    sigs = WINDOW * COMMIT_SIGS * PIPE_WINDOWS
    before, h0 = _counts(), cache.hits
    per = []
    t0 = time.perf_counter()
    for _ in range(PIPE_WINDOWS):
        b0 = _counts()
        _collect(state, val, commits).verify(device=DEVICE)
        per.append(_launched(b0, _counts()))
    serial_s = time.perf_counter() - t0
    check(cache.hits - h0 == PIPE_WINDOWS and all(p == per[0] for p in per),
          f"serial windows launched {per}")
    _want_launches(_launched(before, _counts()), _rlc_want(PIPE_WINDOWS,
                                                  PIPE_WINDOWS), "serial")
    prof, ledger = devprof.DevprofRecorder(), latledger.LatLedgerRecorder()
    devprof.set_recorder(prof)
    latledger.set_recorder(ledger)
    before = _counts()
    try:
        with vd.VerifyPipeline(depth=2, device=DEVICE) as pipe:
            t0 = time.perf_counter()
            waits = [_collect(state, val, commits).verify_async(
                pipe, subsystem="blocksync") for _ in range(PIPE_WINDOWS)]
            for w in waits:
                w.wait(timeout=600)
            piped_s = time.perf_counter() - t0
            workers = pipe.host_workers
        _clean_pipe(pipe, "pipelined windows")
    finally:
        devprof.set_recorder(None)
        latledger.set_recorder(None)
    paths = [w.handle.path for w in waits]
    check(paths == ["device"] * PIPE_WINDOWS, f"paths {paths}")
    _want_launches(_launched(before, _counts()), _merge(*[per[0]] * PIPE_WINDOWS),
           "pipelined windows")
    rows = ledger.rows()
    check(len(rows) == PIPE_WINDOWS and all(r["path"] == "device"
                                            for r in rows),
          f"latency ledger rows {[(r['path'], r['n']) for r in rows]}")
    occ = devprof.occupancy_summary(prof.snapshot())
    out["windows"] = {
        "windows": PIPE_WINDOWS, "signatures": sigs, "host_workers": workers,
        "serial_seconds": serial_s, "serial_sigs_per_s": sigs / serial_s,
        "pipelined_seconds": piped_s, "pipelined_sigs_per_s": sigs / piped_s,
        "window_latency_ms": [r["wall"] * 1e3 for r in rows],
        "window_segments_ms": [{k: v * 1e3 for k, v in r["segs"].items()}
                               for r in rows],
        "busy_share": occ["device_occupancy_fraction"],
        "staging_share": occ["host_bound_fraction"],
        "idle_seconds": occ["idle_cause_seconds"],
        "busy_seconds": occ["busy_seconds"],
        "accounted_seconds": occ["wall_seconds"],
        "launches_per_window": per[0]}

    # 2. the reject, fifth of the eight
    before = _counts()
    with _persig(torch) as persig, \
            vd.VerifyPipeline(depth=2, device=DEVICE) as pipe:
        waits = [_collect(state, val, bad if i == PIPE_BAD else commits)
                 .verify_async(pipe, subsystem="blocksync")
                 for i in range(PIPE_WINDOWS)]
        raised = []
        for i, w in enumerate(waits):
            try:
                w.wait(timeout=600)
            except val.ErrInvalidSignature as e:
                raised.append((i, getattr(e, "failed_ctx", None), str(e)))
    _clean_pipe(pipe, "reject windows")
    check([(i, c) for i, c, _ in raised] == [(PIPE_BAD, bad_h)],
          f"pipelined reject raised {raised}")
    _want_launches(_launched(before, _counts()),
           _merge(*[per[0]] * PIPE_WINDOWS, PERSIG_LAUNCHES),
           "pipelined reject")
    _check_persig(persig, "pipelined reject", WINDOW * COMMIT_SIGS)
    paths = [w.handle.path for w in waits]
    check(paths == ["device"] * PIPE_WINDOWS, f"reject paths {paths}")
    _uncounted(lambda: _expect_raise(
        lambda: _run_window(state, val, bad), "serial reject", raised[0][2],
        bad_h))
    out["reject"] = {"window": PIPE_BAD, "failed_ctx": bad_h,
                     "localization_width": persig.widths}

    # 3. the device-hash route
    cases = [_window_items(state, c) for c in (commits, bad)]
    prev = os.environ.get("COMETBFT_TPU_DEVICE_HASH")
    os.environ["COMETBFT_TPU_DEVICE_HASH"] = "1"
    before = _counts()
    try:
        with vd.VerifyPipeline(depth=2, device=DEVICE) as pipe:
            hs = [pipe.submit(list(zip(*c)), subsystem="blocksync",
                              device_threshold=val.DeferredSigBatch
                              .DEVICE_THRESHOLD) for c in cases]
            got = [h.result(timeout=600) for h in hs]
        _clean_pipe(pipe, "device-hash windows")
    finally:
        if prev is None:
            os.environ.pop("COMETBFT_TPU_DEVICE_HASH")
        else:
            os.environ["COMETBFT_TPU_DEVICE_HASH"] = prev
    launched = _launched(before, _counts())
    check([h.path for h in hs] == ["device"] * 2,
          f"device-hash paths {[h.path for h in hs]}")

    def hash_reference():
        dev = torch.device(DEVICE)
        b0 = _counts()
        hashed = [cb._device_verify_hash(p, m, ed.parse_batch(p, s),
                                         device=dev) for p, m, s in cases]
        ref = _launched(b0, _counts())
        host = [cb._device_verify(p, ed.parse_and_hash(p, m, s), dev)
                for p, m, s in cases]
        return hashed, ref, host
    hashed, ref, host = _uncounted(hash_reference)
    check(got == hashed == host and not got[1][0] and
          got[1][1].count(False) == 1, "device-hash verdicts differ from "
          "the host-hash route's")
    _want_launches(launched, ref, "device-hash windows")
    check(launched.get("sha512_blocks") == 3, f"device-hash K9 {launched}")
    out["device_hash"] = {"launches": launched}

    # 4. the three-type commit as one window, its secp256k1 sub-batch
    #    brought over the device crossover (SECP_DEVICE_THRESHOLD) with
    #    the secp phase's mixed keys, so that K11-K13 run on the card:
    #    once on the MSM program (K11, K12), once on the ladder (K13)
    from cometbft_tpu_torch.crypto import secp256k1 as sk

    s = state["sr25519"]
    mbid, mcommit = s["commits"][SR_MIXED_HEIGHT]
    mvals = s["mvals"]
    triples = [(v.pub_key, sb, cs.signature) for v, sb, cs in zip(
        mvals.validators, mcommit.vote_sign_bytes_all(CHAIN_ID),
        mcommit.signatures)]
    triples += list(state["secp"]["mixed"][MIXED_ED:MIXED_ED +
                                            PIPE_SECP_EXTRA])
    kinds = [pk.type() for pk, _, _ in triples]
    n_secp = kinds.count("secp256k1")
    check(n_secp >= cb._device_threshold("secp256k1"),
          f"mixed window: {n_secp} secp256k1 keys, under the crossover")
    bad_m = sorted([kinds.index("sr25519"),
                    len(triples) - PIPE_SECP_EXTRA // 2])
    for i in bad_m:
        pk, m, sg = triples[i]
        triples[i] = (pk, m + b"!", sg)
    want = _uncounted(lambda: _typed_oracle(state, triples))
    check([i for i, v in enumerate(want) if not v] == bad_m,
          "mixed window: the oracle's rejects")
    out["mixed"] = {"signatures": len(triples), "bad_index": bad_m,
                    "secp256k1": n_secp, "key_types": sorted(set(kinds))}
    for program, env in (("msm", "1"), ("ladder", "0")):
        old = os.environ.get("COMETBFT_TPU_SECP_MSM")
        os.environ["COMETBFT_TPU_SECP_MSM"] = env
        before, h0 = _counts(), cache.hits
        m0 = sk.q_table_cache().misses
        inside = []
        try:
            with vd.VerifyPipeline(depth=2, device=DEVICE) as pipe:
                real = pipe._device_dispatch

                def traced(win, device=None, real=real):
                    # the launches made inside the dispatch thread's call
                    # (MixedBatchVerifier's one thread a key type included)
                    b = _counts()
                    r = real(win, device=device)
                    inside.append((threading.current_thread().name,
                                   _launched(b, _counts())))
                    return r
                pipe._device_dispatch = traced
                t0 = time.perf_counter()
                h = pipe.submit(triples, subsystem="blocksync")
                ok, verdicts = h.result(timeout=600)
                secs = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("COMETBFT_TPU_SECP_MSM", None)
            else:
                os.environ["COMETBFT_TPU_SECP_MSM"] = old
        _clean_pipe(pipe, f"mixed window ({program})")
        check(h.path == "device" and verdicts == want and not ok,
              f"mixed window ({program}): path {h.path}, verdicts differ "
              f"from the oracle at "
              f"{[i for i, (a, b) in enumerate(zip(verdicts, want)) if a != b]}")
        misses = sk.q_table_cache().misses - m0
        secp = ({"secp_msm_verify": 1, "secp_q_tables": misses}
                if program == "msm" else {"secp_ladder": 1})
        got = _launched(before, _counts())
        _want_launches(got, _merge(_rlc_want(cache.hits - h0, 2),
                                   PERSIG_LAUNCHES, secp),
                       f"mixed window ({program})")
        check(inside == [(f"{pipe._name}-device", got)],
              f"mixed window ({program}): launches outside the dispatch "
              f"thread's call: {inside} against {got}")
        out["mixed"][program] = {"launches": got, "table_misses": misses,
                                 "seconds": secs}

    # 5. QoS: a consensus window behind six queued blocksync windows
    rec = flightrec.FlightRecorder()
    flightrec.set_recorder(rec)
    ledger = latledger.LatLedgerRecorder()
    latledger.set_recorder(ledger)
    small, _ = _pipe_items(state, [5])
    try:
        batches = [_collect(state, val, commits)
                   for _ in range(PIPE_QOS_BULK)]
        with vd.VerifyPipeline(depth=PIPE_QOS_BULK + 2,
                               device=DEVICE) as pipe:
            waits = [b.verify_async(pipe, subsystem="blocksync")
                     for b in batches]
            urgent = pipe.submit(small, subsystem="consensus")
            urgent.result(timeout=600)
            for w in waits:
                w.wait(timeout=600)
            snap = pipe.scheduler_snapshot()
        _clean_pipe(pipe, "QoS windows")
    finally:
        flightrec.set_recorder(None)
        latledger.set_recorder(None)
    handles = [w.handle for w in waits]
    check(all(x.path == "device" for x in handles + [urgent]),
          "QoS paths " + str([x.path for x in handles + [urgent]]))
    done_at = [x.resolved_at for x in handles]
    check(done_at == sorted(done_at), "blocksync resolved out of order")
    pre = [e for e in rec.events() if e["kind"] == flightrec.EV_SCHED_PREEMPT]
    dispatched = sorted((x.lat[0].stamps["dispatch"], x.subsystem, i)
                        for i, x in enumerate(handles + [urgent]))
    order = [sub if sub == "consensus" else i for _, sub, i in dispatched]
    overtook = PIPE_QOS_BULK - order.index("consensus")
    check(any(e["lane"] == "consensus" and e["overtook"] >= 1 for e in pre)
          and snap["consensus"]["preemptions"] == 1 and overtook >= 1,
          f"the consensus window overtook nothing: order {order}, {pre}")
    out["qos"] = {"dispatch_order": order, "overtook": overtook,
                  "preempt_events": pre, "snapshot": snap}

    # 6. faults and health, with windows of one commit (host verdicts)
    real = _real_dispatch(torch)
    items = [_pipe_items(state, [h])[0] for h in state["heights"][:3]]
    j = len(items[1]) // 2
    items[1][j] = (items[1][j][0], items[1][j][1] + b"!", items[1][j][2])
    want = _uncounted(lambda: [_oracle(state, tuple(zip(*w))) for w in items])
    armed = [True]

    def raise_once(win):
        if armed[0]:
            armed[0] = False
            raise RuntimeError("injected device fault")
        return real(win)

    health = devhealth.HealthRegistry()
    with vd.VerifyPipeline(depth=3, device=DEVICE, health=health,
                           dispatch_fn=raise_once) as pipe:
        hs = [pipe.submit(w, subsystem="blocksync") for w in items]
        got = [x.result(timeout=600)[1] for x in hs]
        state_after = health.state("0")
        again = pipe.submit(items[0], subsystem="blocksync")
        again.result(timeout=600)
        fault = {"paths": [x.path for x in hs], "faults": pipe.faults,
                 "drained": pipe.drained_windows, "state": state_after,
                 "again": again.path}
    check(got == want and fault["paths"][0] == "drain" and
          fault["faults"] == 1 and fault["drained"] ==
          fault["paths"].count("drain") and state_after == "suspect" and
          health.usable("0") and again.path == "device",
          f"fault step: {fault}")

    release = threading.Event()
    hung = [False]
    calls = []

    def hang_once(win):
        if not hung[0]:
            hung[0] = True
            release.wait(timeout=4 * PIPE_DEADLINE_S)
            raise RuntimeError("released after the watchdog")
        b0, c0 = _counts(), cache.hits
        r = real(win)
        calls.append((win.handle.subsystem, _launched(b0, _counts()),
                      cache.hits - c0, r[1]))
        return r

    rec = flightrec.FlightRecorder()
    flightrec.set_recorder(rec)
    health = devhealth.HealthRegistry(probe_backoff_s=0.5)
    try:
        with vd.VerifyPipeline(depth=2, device=DEVICE, health=health,
                               dispatch_fn=hang_once,
                               dispatch_deadline_s=PIPE_DEADLINE_S) as pipe:
            t0 = time.perf_counter()
            hh = pipe.submit(items[1], subsystem="blocksync")
            got = hh.result(timeout=600)[1]
            hang_s = time.perf_counter() - t0
            release.set()
            deadline = time.monotonic() + 60
            while not health.usable("0") and time.monotonic() < deadline:
                time.sleep(0.01)
            recovered = health.state("0")
            after = pipe.submit(items[2], subsystem="blocksync")
            after.result(timeout=600)
            hang = {"path": hh.path, "resolved_s": hang_s,
                    "faults": pipe.faults, "drained": pipe.drained_windows,
                    "after": after.path}
    finally:
        release.set()
        flightrec.set_recorder(None)
    events = [(e["kind"], e.get("reason") or e.get("result"))
              for e in rec.events() if e["kind"] in (
                  flightrec.EV_WATCHDOG_TIMEOUT,
                  flightrec.EV_DEVICE_QUARANTINE, flightrec.EV_DEVICE_PROBE)]
    check(got == want[1] and hh.path == "drain" and
          events == [(flightrec.EV_DEVICE_QUARANTINE, "hang"),
                     (flightrec.EV_WATCHDOG_TIMEOUT, None),
                     (flightrec.EV_DEVICE_PROBE, "ok")] and
          recovered == "healthy" and after.path == "device" and
          health.quarantines("0") == 1 and
          len(health.recovery_seconds("0")) == 1,
          f"hang step: {hang}, state {recovered}, events {events}")
    probe = [c for c in calls if c[0] == "probe"]
    check(len(probe) == 1 and probe[0][3] == devhealth.probe_expected(),
          f"probe calls {probe}")
    _want_launches(probe[0][1], _merge(_rlc_want(probe[0][2], 1), PERSIG_LAUNCHES),
           "probe")
    hang.update(recovery_seconds=health.recovery_seconds("0")[0],
                events=events, probe_launches=probe[0][1])
    out["faults"] = {"raise_once": fault, "hang": hang}

    # 7. the verdict cache
    sigcache.set_enabled(True)
    sigcache.reset()
    try:
        before, h0 = _counts(), cache.hits
        with vd.VerifyPipeline(depth=2, device=DEVICE) as pipe:
            first = _collect(state, val, commits).verify_async(
                pipe, subsystem="blocksync")
            first.wait(timeout=600)
            mid = _counts()
            again = _collect(state, val, commits).verify_async(
                pipe, subsystem="blocksync")
            at_submit = again.done()
            again.wait(timeout=600)
        _clean_pipe(pipe, "cached windows")
    finally:
        sigcache.set_enabled(False)
        sigcache.reset()
    check(first.handle.path == "device" and again.handle.path == "cache"
          and at_submit and _launched(mid, _counts()) == {},
          f"cache step: paths {first.handle.path} / {again.handle.path}, "
          f"resolved at submit {at_submit}")
    _want_launches(_launched(before, mid), _rlc_want(cache.hits - h0, 1),
           "cached window, first")

    # 8. the mesh rotation on logical shards of the card
    devices = [f"cuda:{i % torch.cuda.device_count()}" if DEVICE == "cuda"
               else "cpu" for i in range(2)]
    lock = threading.Lock()
    seen = {}

    def placed(win):
        dev = torch.device(devices[win.device_index])
        with lock:
            b0, c0 = _counts(), cache.hits
            current = torch.cuda.current_device() if dev.type == "cuda" \
                else None
            r = cb._device_verify(win.pks, win.parsed, dev,
                                  packed=win.packed)
            seen[win.handle.ctx] = (win.device_index, current,
                                    threading.current_thread().name,
                                    _launched(b0, _counts()),
                                    cache.hits - c0)
        return r

    order = []
    with vd.VerifyPipeline(depth=PIPE_MESH, device=DEVICE, devices=devices,
                           dispatch_fn=placed) as pipe:
        hs = []
        for i in range(PIPE_MESH):
            x = pipe.submit(_pipe_items(state, [state["heights"][i]])[0],
                            subsystem="blocksync", ctx=i)
            x.add_done_callback(lambda y: order.append(y.ctx))
            hs.append(x)
        for x in hs:
            x.result(timeout=600)
    _clean_pipe(pipe, "mesh windows")
    check(order == list(range(PIPE_MESH)) and
          all(x.path == "device" for x in hs), f"mesh published {order}")
    for i in range(PIPE_MESH):
        idx, current, thread, got, hits = seen[i]
        check(idx == i % 2 and thread.endswith(f"-device-{idx}") and
              current in (None, torch.device(devices[idx]).index),
              f"mesh window {i} on slot {idx}, thread {thread}, "
              f"current device {current}")
        _want_launches(got, _rlc_want(hits, 1), f"mesh window {i}")
    out["mesh"] = {"devices": devices, "windows": {
        i: {"slot": v[0], "thread": v[2], "launches": v[3]}
        for i, v in seen.items()}}

    state["pipeline_launches"] = _counts()
    launched = {k for k, v in state["pipeline_launches"].items() if v}
    check(launched == DEFAULT_KERNELS | {"sha512_blocks", "secp_q_tables",
                                         "secp_msm_verify", "secp_ladder"},
          f"the pipeline path launched {sorted(launched)}")
    _zero_counts()
    out["launches"] = state["pipeline_launches"]
    return out


# -- phase 11: the consensus vote path -----------------------------------------

VOTE_HEIGHT = 2000             # the flood's height H
VOTE_PEERS = 4                 # peers gossiping every vote
VOTE_TAMPERED = 7              # validator whose precommit is tampered
VOTE_EQUIVOCATOR = 3           # validator that signs a second prevote
VOTE_FLOOD_FLUSH_S = 1.0       # step 1: the flood forms one window
VOTE_QOS_FLUSH_S = 0.8         # step 3's flush interval
VOTE_QOS_SUBMIT_S = 0.4        # step 3: the window's submit after its first vote
VOTE_QOS_DEPTH = 16            # step 3's pipeline: six bulk windows and the votes'
VOTE_PACE_S = 0.2              # step 4: each peer's 300 votes over 200 ms
VOTE_CROSS_SIZES = (1, 2, 4, 8, 32, 64, 150, 256, 300)
VOTE_CROSS_REPS = 5
VOTE_HOST_SAMPLES = 32


def _vote_fixtures(state):
    """The flood's 300 votes (a prevote and a precommit of each of the
    150 validators for one block at VOTE_HEIGHT, round 0), signed in the
    pool, with VOTE_TAMPERED's precommit tampered, and VOTE_EQUIVOCATOR's
    second prevote for another block."""
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import (PRECOMMIT_TYPE, PREVOTE_TYPE,
                                               Vote)

    vals, seed_of = state["vals"], state["seed_of"]
    bid = block.BlockID(_seed("vote-block", VOTE_HEIGHT), block.PartSetHeader(
        1, _seed("vote-parts", VOTE_HEIGHT)))
    other = block.BlockID(_seed("vote-other", VOTE_HEIGHT),
                          block.PartSetHeader(1, _seed("vote-other-parts",
                                                       VOTE_HEIGHT)))
    votes = []
    for t in (PREVOTE_TYPE, PRECOMMIT_TYPE):
        for i, v in enumerate(vals.validators):
            votes.append(Vote(type=t, height=VOTE_HEIGHT, round=0,
                              block_id=bid, timestamp=Timestamp(
                                  1_700_100_000 + t, 1000 * i + 7),
                              validator_address=v.address, validator_index=i))
    eq_val = vals.validators[VOTE_EQUIVOCATOR]
    twin = Vote(type=PREVOTE_TYPE, height=VOTE_HEIGHT, round=0,
                block_id=other, timestamp=Timestamp(1_700_100_050, 3),
                validator_address=eq_val.address,
                validator_index=VOTE_EQUIVOCATOR)
    sbs = [v.sign_bytes(CHAIN_ID) for v in votes + [twin]]
    sigs = _pool_map(state["pool"], _sign, [
        (seed_of[v.validator_address], sb)
        for v, sb in zip(votes + [twin], sbs)])
    for v, sig in zip(votes + [twin], sigs):
        v.signature = sig
    pks = [vals.validators[v.validator_index].pub_key.bytes() for v in votes]
    clean = list(zip(pks, sbs[:-1], sigs[:-1]))
    bad = N_VALS + VOTE_TAMPERED
    s = votes[bad].signature
    votes[bad].signature = s[:6] + bytes([s[6] ^ 1]) + s[7:]
    flood = [(pk, sb, v.signature) for pk, sb, v in zip(pks, sbs, votes)]
    want = _oracle(state, tuple(zip(*flood)))
    check([i for i, w in enumerate(want) if not w] == [bad],
          f"vote fixtures: the oracle rejects {want.count(False)} votes")
    return {"bid": bid, "votes": votes, "twin": twin, "flood": flood,
            "clean": clean, "want": want, "bad": bad}


def _gossip(stream, fx, peers, order_seed, pace_s=0.0):
    """Each peer thread gossips every vote in its own seeded order, as a
    consensus reactor's receive routine does (the JAX package's
    consensus/reactor.py _preverify_vote without its p2p and state
    locks): submit the triple, attach the Preverified.  Returns each
    peer's received votes, the submit times and the seconds until every
    vote future resolved."""
    import dataclasses
    import random
    import threading

    from cometbft_tpu_torch.crypto.votestream import Preverified

    n = len(fx["votes"])
    orders = [random.Random(f"{order_seed}-{p}").sample(range(n), n)
              for p in range(peers)]
    received = [[] for _ in range(peers)]
    stamps = []
    barrier = threading.Barrier(peers)

    def peer(p):
        barrier.wait()
        for k, idx in enumerate(orders[p]):
            v = dataclasses.replace(fx["votes"][idx])
            pk, sb, sig = fx["flood"][idx]
            stamps.append(time.perf_counter())
            fut = stream.submit(pk, sb, sig)
            v.preverified = Preverified(pk, sb, sig, fut)
            received[p].append((idx, v, fut))
            if pace_s:
                time.sleep(pace_s / n)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=peer, args=(p,))
               for p in range(peers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for rec in received:
        for _, _, fut in rec:
            fut.result(timeout=600)
    return received, min(stamps), time.perf_counter() - t0


def _consensus_state(fx, received, vals):
    """The consensus state thread, after the verifier: every received
    vote into its round's VoteSet.  Returns the two sets, each vote's
    first outcome and the number of signature verifies that add_vote
    made itself (crypto/batch.safe_verify calls)."""
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.types import vote_set as vs_mod
    from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE

    sets = {t: vs_mod.VoteSet(CHAIN_ID, VOTE_HEIGHT, 0, t, vals)
            for t in (PREVOTE_TYPE, PRECOMMIT_TYPE)}
    first = {}
    real, inline = cb.safe_verify, []
    cb.safe_verify = lambda *a: inline.append(a) or real(*a)
    try:
        for rec in received:
            for idx, v, _ in rec:
                try:
                    out = sets[v.type].add_vote(v)
                except vs_mod.VoteSetError as e:
                    out = type(e).__name__
                first.setdefault(idx, out)
    finally:
        cb.safe_verify = real
    return sets, [first[i] for i in range(len(fx["votes"]))], len(inline)


def _check_verdicts(fx, received, label):
    for rec in received:
        for idx, _, fut in rec:
            check(fut.result(timeout=0) == fx["want"][idx],
                  f"{label}: vote {idx} verdict {fut.result(timeout=0)}, "
                  f"the oracle's {fx['want'][idx]}")


def _check_outcomes(fx, sets, outcomes, label):
    from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE

    want = ["ErrVoteInvalidSignature" if i == fx["bad"] else True
            for i in range(len(outcomes))]
    check(outcomes == want, f"{label}: add_vote outcomes "
          f"{[(i, o) for i, (o, w) in enumerate(zip(outcomes, want)) if o != w]}")
    com = sets[PRECOMMIT_TYPE]
    check(com.has_two_thirds_majority() and
          com.bit_array().num_true() == N_VALS - 1,
          f"{label}: {com.bit_array().num_true()} precommits, +2/3 "
          f"{com.has_two_thirds_majority()}")


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def _lat_split(rows):
    """Per consumer: rows, p50 and p99 of the wall in ms."""
    out = {}
    for c in sorted({r["consumer"] for r in rows}):
        w = [r["wall"] * 1e3 for r in rows if r["consumer"] == c]
        out[c] = {"rows": len(w), "p50_ms": _pct(w, 50), "p99_ms": _pct(w, 99)}
    return out


def phase_votes(state, torch):
    """The consensus vote path on the card: crypto/votestream's
    StreamingVerifier feeding VerifyPipeline's consensus lane, what it
    verifies consumed by types/vote_set.VoteSet (the exact-triple
    Preverified contract), the commit it makes checked at the next
    height, and duplicate-vote evidence, with the verdict cache on
    (reset between steps; off again after the phase):
    1. flood: four peer threads gossip all 300 votes of height H (a
       prevote and a precommit of each of the 150 validators, one
       precommit tampered): 1,200 submissions to a stream with a 1 s
       flush interval and the default device threshold (256) form one
       window; its launches are one RLC program and one K1 + K14 over
       its 300 live lanes; 900 submissions coalesce or hit the cache;
       every verdict is ed25519_ref.verify's; add_vote rejects the
       tampered precommit and accepts the other 299 with no verify of
       its own; the 149 precommits reach +2/3;
    2. commit: make_commit(); verify_commit_light of it at H + 1
       launches nothing (every signature a cache hit); a second prevote
       of one validator for another block makes add_vote raise
       ErrVoteConflictingVotes (after verifying it inline), and
       verify_duplicate_vote of the DuplicateVoteEvidence passes with no
       launch and no verify (both votes cache hits);
    3. qos: six of the window phase's 4,848-signature blocksync windows
       queued on a pipeline of depth 16, then one peer's 300 votes
       through a stream with a 0.8 s flush interval and device
       threshold 1 (a sealed flush of any size goes to the card): the
       seal advisory submits its first window within 0.4 s of its first
       vote, each consensus window dispatches ahead of blocksync
       windows queued before it (EV_SCHED_PREEMPT), the launches are
       exact, and the latency ledger's consensus and blocksync p50 /
       p99 are reported;
    4. defaults: the 300 votes paced over 200 ms from four peers
       through default_verifier(device) at the default knobs (2 ms,
       256): verdicts checked; flushes and votes by path, wall time
       and per-vote p50 / p99 reported;
    5. crossover: the host verify's time a vote (median of 32) and the
       wall time of one device window through the default pipeline at
       1 to 300 votes (median of 5, cache off).
    The counts are set to 0 after the first stream's pre-warm (its
    seconds and launches reported apart) and read after step 3; steps
    4-5 are measurements outside the count.  Steps 1-3 fail on a host,
    drain or error path, a device fallback, a KernelBuildError or a
    vote future that raises."""
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.crypto import votestream as vs_mod
    from cometbft_tpu_torch.evidence.verify import verify_duplicate_vote
    from cometbft_tpu_torch.libs import flightrec, latledger
    from cometbft_tpu_torch.types import validation as val
    from cometbft_tpu_torch.types import vote_set as vset_mod
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE

    vals = state["vals"]
    cache = ed._A_TABLE_CACHE
    fx = _vote_fixtures(state)
    n_votes = len(fx["votes"])
    out = {"votes": n_votes, "validators": N_VALS}

    def clean_stream(sv, label):
        check(sv.device_fallbacks == sv.build_errors == 0 and
              sv.warm_error is None and sv.path_flushes["host"] == 0 and
              set(sv.window_paths) <= {"device"},
              f"{label}: fallbacks {sv.device_fallbacks}, build errors "
              f"{sv.build_errors}, warm error {sv.warm_error!r}, flushes "
              f"{dict(sv.path_flushes)}, windows {dict(sv.window_paths)}")

    sigcache.set_enabled(True)
    try:
        # 1. the flood, one window through the default pipeline
        t0 = time.perf_counter()
        w0 = _counts()
        sv = vs_mod.StreamingVerifier(flush_interval=VOTE_FLOOD_FLUSH_S,
                                      device=DEVICE)
        sv.start()
        check(sv.warmed.wait(timeout=900), "the pre-warm did not finish")
        out["prewarm"] = {"seconds": time.perf_counter() - t0,
                          "launches": _launched(w0, _counts()),
                          "error": repr(sv.warm_error)}
        _zero_counts()                  # the vote path starts here
        sigcache.reset()
        before, h0 = _counts(), cache.hits
        try:
            with _persig(torch) as persig:
                received, _, flood_s = _gossip(sv, fx, VOTE_PEERS, "flood")
        finally:
            sv.stop()
        launched = _launched(before, _counts())
        clean_stream(sv, "flood")
        _check_verdicts(fx, received, "flood")
        check(sv.path_flushes == {"device": 1} and
              sv.path_votes["device"] == n_votes,
              f"flood: flushes {dict(sv.path_flushes)}, votes "
              f"{dict(sv.path_votes)}, not one window of {n_votes}")
        check(sv.coalesced + sv.cache_hits == (VOTE_PEERS - 1) * n_votes,
              f"flood: {sv.coalesced} coalesced + {sv.cache_hits} cached")
        _want_launches(launched, _merge(_rlc_want(cache.hits - h0, 1),
                                        PERSIG_LAUNCHES), "flood")
        _check_persig(persig, "flood", n_votes)
        sets, outcomes, inline = _consensus_state(fx, received, vals)
        _check_outcomes(fx, sets, outcomes, "flood")
        check(inline == 0, f"flood: add_vote verified {inline} votes itself")
        out["flood"] = {"submissions": VOTE_PEERS * n_votes,
                        "coalesced": sv.coalesced,
                        "cache_hits": sv.cache_hits, "seconds": flood_s,
                        "launches": launched,
                        "localization_width": persig.widths}

        # 2. the commit at H + 1, and duplicate-vote evidence
        commit = sets[PRECOMMIT_TYPE].make_commit()
        check(sum(c.for_block() for c in commit.signatures) == N_VALS - 1,
              "commit: not 149 commit signatures")
        before, st0 = _counts(), sigcache.cache().stats()
        val.verify_commit_light(CHAIN_ID, vals, fx["bid"], VOTE_HEIGHT,
                                commit, device=DEVICE)
        st1 = sigcache.cache().stats()
        check(_launched(before, _counts()) == {} and
              st1["misses"] == st0["misses"],
              f"commit: launched {_launched(before, _counts())}, "
              f"{st1['misses'] - st0['misses']} cache misses")
        twin = fx["twin"]
        verifies = []
        real_verify = ed.PubKey.verify_signature

        def counted(self, msg, sig):
            verifies.append(msg)
            return real_verify(self, msg, sig)
        ed.PubKey.verify_signature = counted
        try:
            try:
                sets[PREVOTE_TYPE].add_vote(twin)
                raise PhaseError("equivocation: add_vote accepted the twin")
            except vset_mod.ErrVoteConflictingVotes as e:
                conflict = e
            inline = len(verifies)
            ev = DuplicateVoteEvidence.new(
                conflict.vote_a, conflict.vote_b,
                Timestamp(1_700_100_100, 0), vals)
            ev.validate_basic()
            before, st0 = _counts(), sigcache.cache().stats()
            verify_duplicate_vote(ev, CHAIN_ID, vals)
            st1 = sigcache.cache().stats()
        finally:
            ed.PubKey.verify_signature = real_verify
        check(inline == 1 and len(verifies) == 1 and
              _launched(before, _counts()) == {} and
              st1["hits"] - st0["hits"] == 2,
              f"evidence: {inline} inline verifies, {len(verifies)} in all, "
              f"launched {_launched(before, _counts())}, "
              f"{st1['hits'] - st0['hits']} cache hits")
        out["commit"] = {"signatures": len(commit.signatures),
                         "commit_hash": commit.hash().hex(),
                         "evidence_hash": ev.hash().hex(),
                         "evidence_bytes": len(ev.to_proto())}

        # 3. QoS: the votes behind six queued blocksync windows
        sigcache.reset()
        commits = [(h, state["commits"][h]) for h in state["heights"]]
        batches = [_collect(state, val, commits)
                   for _ in range(PIPE_QOS_BULK)]
        # SLO burns stay in the recorder: a sustained burn would dump the
        # whole ring to the log at every later row
        rec = flightrec.FlightRecorder()
        ledger = latledger.LatLedgerRecorder(slo=latledger.SLOTracker(
            on_burn=lambda *a: None))
        flightrec.set_recorder(rec)
        latledger.set_recorder(ledger)
        before, h0 = _counts(), cache.hits
        windows = []
        try:
            with _persig(torch) as persig, \
                    vd.VerifyPipeline(depth=VOTE_QOS_DEPTH,
                                      device=DEVICE) as pipe:
                real_submit = pipe.submit

                def submit(items, **kw):
                    items = list(items)
                    h = real_submit(items, **kw)
                    if kw.get("subsystem") == "consensus":
                        windows.append((time.perf_counter(), items, h))
                    return h
                pipe.submit = submit
                waits = [b.verify_async(pipe, subsystem="blocksync")
                         for b in batches]
                sv = vs_mod.StreamingVerifier(
                    flush_interval=VOTE_QOS_FLUSH_S, device_threshold=1,
                    pipeline=pipe, device=DEVICE, warmup=False)
                sv.start()
                try:
                    received, first_at, qos_s = _gossip(sv, fx, 1, "qos")
                finally:
                    sv.stop()
                for w in waits:
                    w.wait(timeout=600)
                snap = pipe.scheduler_snapshot()
            _clean_pipe(pipe, "qos")
        finally:
            flightrec.set_recorder(None)
            latledger.set_recorder(None)
        launched = _launched(before, _counts())
        clean_stream(sv, "qos")
        _check_verdicts(fx, received, "qos")
        check(windows and windows[0][0] - first_at < VOTE_QOS_SUBMIT_S,
              f"qos: the first vote window was submitted "
              f"{windows[0][0] - first_at if windows else None} s after its "
              f"first vote")
        bulk = [w.handle for w in waits]
        votes_h = [h for _, _, h in windows]
        check(all(x.path == "device" for x in bulk + votes_h),
              f"qos paths {[x.path for x in bulk + votes_h]}")
        dispatched = {id(x): x.lat[0].stamps["dispatch"]
                      for x in bulk + votes_h}
        submitted = {id(x): x.submitted_at for x in bulk + votes_h}
        overtook = [sum(1 for b in bulk if submitted[id(b)] < submitted[id(x)]
                        and dispatched[id(b)] > dispatched[id(x)])
                    for x in votes_h]
        pre = [e for e in rec.events()
               if e["kind"] == flightrec.EV_SCHED_PREEMPT
               and e["lane"] == "consensus"]
        sizes = [len(items) for _, items, _ in windows]
        order = sorted((dispatched[id(x)], "votes" if x in votes_h else "bulk",
                        submitted[id(x)]) for x in bulk + votes_h)
        check(overtook[0] >= 1 and pre, f"qos: the consensus windows "
              f"{sizes} overtook {overtook} queued blocksync windows, "
              f"{len(pre)} preempt events; (dispatch, kind, submit): "
              f"{order}")
        n_rlc = PIPE_QOS_BULK + sum(1 for n in sizes if n >= 2)
        n_persig = sum(1 for n in sizes if n == 1) + sum(
            1 for n, (_, items, _) in zip(sizes, windows)
            if n >= 2 and fx["flood"][fx["bad"]] in items)
        _want_launches(launched, _merge(_rlc_want(cache.hits - h0, n_rlc),
                                        *[PERSIG_LAUNCHES] * n_persig), "qos")
        check(persig.calls == n_persig and sum(sizes) == n_votes,
              f"qos: {persig.calls} localizations, windows {sizes}")
        out["qos"] = {"windows": sizes,
                      "first_window_after_s": windows[0][0] - first_at,
                      "overtook": overtook, "preempt_events": len(pre),
                      "seconds": qos_s, "launches": launched,
                      "latency": _lat_split(ledger.rows()),
                      "snapshot": snap}
        state["votes_launches"] = _counts()

        # 4. the default knobs
        sigcache.reset()
        ledger = latledger.LatLedgerRecorder()
        dv = vs_mod.default_verifier(device=DEVICE)
        check(dv.flush_interval == vs_mod.FLUSH_INTERVAL_S and
              dv.device_threshold == vs_mod.DEVICE_THRESHOLD,
              "the default verifier's knobs")
        t0 = time.perf_counter()
        check(dv.warmed.wait(timeout=900) and dv.warm_error is None,
              f"default pre-warm: {dv.warm_error!r}")
        warm_s = time.perf_counter() - t0
        sigcache.reset()
        latledger.set_recorder(ledger)
        try:
            received, _, paced_s = _gossip(dv, fx, VOTE_PEERS, "paced",
                                           pace_s=VOTE_PACE_S)
        finally:
            latledger.set_recorder(None)
        _check_verdicts(fx, received, "defaults")
        sets, outcomes, _ = _consensus_state(fx, received, vals)
        _check_outcomes(fx, sets, outcomes, "defaults")
        check(dv.device_fallbacks == dv.build_errors == 0,
              "defaults: a device fallback or build error")
        walls = [r["wall"] * 1e3 for r in ledger.rows()
                 if r["consumer"] == "consensus"]
        out["defaults"] = {
            "flush_ms": dv.flush_interval * 1e3,
            "device_threshold": dv.device_threshold,
            "prewarm_seconds": warm_s, "seconds": paced_s,
            "flushes_by_path": dict(dv.path_flushes),
            "votes_by_path": dict(dv.path_votes),
            "windows_by_path": dict(dv.window_paths),
            "coalesced": dv.coalesced, "cache_hits": dv.cache_hits,
            "vote_p50_ms": _pct(walls, 50), "vote_p99_ms": _pct(walls, 99),
            "rows": len(walls)}
        dv.stop()
    finally:
        sigcache.set_enabled(False)
        sigcache.reset()

    # 5. the host / device crossover, cache off
    host_ms = []
    for pk, sb, sig in fx["clean"][:VOTE_HOST_SAMPLES]:
        t0 = time.perf_counter()
        ok = vs_mod._host_verify(pk, sb, sig)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(ok, "crossover: a clean vote rejected on the host")
    pipe = vd.default_pipeline(DEVICE)
    device_ms = {}
    for n in VOTE_CROSS_SIZES:
        ts = []
        for _ in range(VOTE_CROSS_REPS):
            t0 = time.perf_counter()
            h = pipe.submit(fx["clean"][:n], subsystem="consensus",
                            device_threshold=1)
            ok, _ = h.result(timeout=600)
            ts.append((time.perf_counter() - t0) * 1e3)
            check(ok and h.path == "device",
                  f"crossover: window of {n} {h.path} {ok}")
        device_ms[n] = _pct(ts, 50)
    pipe.stop()
    host_vote_ms = _pct(host_ms, 50)
    cross = next((n for n in VOTE_CROSS_SIZES
                  if device_ms[n] < n * host_vote_ms), None)
    out["crossover"] = {"host_ms_per_vote": host_vote_ms,
                        "device_window_ms": device_ms,
                        "device_ms_per_vote": {n: device_ms[n] / n
                                               for n in VOTE_CROSS_SIZES},
                        "first_size_device_wins": cross}
    launched = {k for k, v in state["votes_launches"].items() if v}
    check(launched == DEFAULT_KERNELS,
          f"the vote path launched {sorted(launched)}")
    out["launches"] = state["votes_launches"]
    _zero_counts()
    return out


# -- phase 12: the light client ----------------------------------------------

LIGHT_TOP = 193                # heights 1..193: BASELINE's 10,000 cut to 193
LIGHT_ROTATIONS = ((66, 60), (130, 60))   # (height, root validators replaced)
LIGHT_WINDOW = 48              # sequential_batch_size of step 1
LIGHT_SERIAL_WINDOW = 192      # step 2: the whole range in one window
LIGHT_BAD = 150                # step 5: the height whose commit is tampered
LIGHT_BAD_SIG = 37             # ... at this signature, among the first 101
LIGHT_FORK = 191               # step 6: the witness's fork starts here
LIGHT_BACK = (193, 100)        # step 4: trusted root, target
LIGHT_TRUST_NS = 14 * 24 * 3600 * 10**9
LIGHT_T0 = 1_700_000_000


def _light_sign_height(state, vals, h, bid, base_ts):
    """The commit of height h under `vals`, every validator signing, its
    signatures made in the pool."""
    from cometbft_tpu_torch.types import block, canonical
    from cometbft_tpu_torch.types.timestamp import Timestamp

    rows = []
    for i, v in enumerate(vals.validators):
        ts = Timestamp(base_ts.seconds, 1000 * i + 7)
        rows.append((v.address, ts, canonical.vote_sign_bytes(
            CHAIN_ID, canonical.PRECOMMIT, h, 0, bid, ts)))
    sigs = _pool_map(state["pool"], _sign, [
        (state["light_seed_of"][a], sb) for a, _, sb in rows])
    return block.Commit(h, 0, bid, [
        block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, a, ts, s)
        for (a, ts, _), s in zip(rows, sigs)])


def _light_chain(state, sets, start, top, prev, app_hash):
    """Light blocks start..top over the snapshots `sets` (height -> set),
    chained on `prev` (the block below start, or None), each commit
    signed by its whole set."""
    from cometbft_tpu_torch.light.types import LightBlock, SignedHeader
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.timestamp import Timestamp

    empty = block.Data([]).hash()
    out = {}
    for h in range(start, top + 1):
        vals = sets[h]
        header = block.Header(
            version=block.Consensus(11, 1), chain_id=CHAIN_ID, height=h,
            time=Timestamp(LIGHT_T0 + h, 0),
            last_block_id=(prev.signed_header.commit.block_id if prev
                           else block.BlockID()),
            last_commit_hash=(prev.signed_header.commit.hash() if prev
                              else block.Commit().hash()),
            data_hash=empty, validators_hash=vals.hash(device=DEVICE),
            next_validators_hash=sets[min(h + 1, top)].hash(device=DEVICE),
            consensus_hash=b"\x01" * 32, app_hash=app_hash(h),
            last_results_hash=b"\x02" * 32, evidence_hash=empty,
            proposer_address=vals.get_proposer().address)
        bid = block.BlockID(header.hash(), block.PartSetHeader(
            1, _seed("light-parts", h, header.app_hash)))
        commit = _light_sign_height(state, vals, h, bid, header.time)
        prev = out[h] = LightBlock(SignedHeader(header, commit), vals)
    return out


def _light_fixtures(state):
    """Heights 1..LIGHT_TOP over the fixture phase's 150 validators: at
    each LIGHT_ROTATIONS height that many of the root's validators leave
    (power 0) and as many new ones join through update_with_change_set;
    the proposer walks once a height.  Every validator signs every
    commit.  Also the witness's lunatic fork from LIGHT_FORK on (a forged
    app_hash, signed by the same keys)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)

    t0 = time.perf_counter()
    n_new = sum(k for _, k in LIGHT_ROTATIONS)
    seeds = [_seed("light-validator", i) for i in range(n_new)]
    pubs = _pool_map(state["pool"], _pubkeys, seeds)
    fresh = [Validator(ed.PubKey(p), 10) for p in pubs]
    seed_of = dict(state["seed_of"])
    seed_of.update({v.address: s for v, s in zip(fresh, seeds)})
    state["light_seed_of"] = seed_of
    root = [v.address for v in state["vals"].validators]
    vals = ValidatorSet.from_proto(state["vals"].to_proto())
    sets, left, joined = {}, 0, 0
    rotations = dict(LIGHT_ROTATIONS)
    for h in range(1, LIGHT_TOP + 1):
        if h in rotations:
            k = rotations[h]
            vals.update_with_change_set(
                [Validator(vals.get_by_address(a)[1].pub_key, 0)
                 for a in root[left:left + k]]
                + [v.copy() for v in fresh[joined:joined + k]])
            left, joined = left + k, joined + k
        if h > 1:
            vals.increment_proposer_priority(1)
        sets[h] = ValidatorSet.from_proto(vals.to_proto())
    keys_s = time.perf_counter() - t0
    chain = _light_chain(state, sets, 1, LIGHT_TOP, None,
                         lambda h: h.to_bytes(32, "big"))
    fork = _light_chain(state, sets, LIGHT_FORK, LIGHT_TOP,
                        chain[LIGHT_FORK - 1],
                        lambda h: _seed("light-fork", h))
    return {"chain": chain, "fork": fork, "sets": sets,
            "signing_seconds": time.perf_counter() - t0,
            "key_seconds": keys_s,
            "signatures": sum(len(lb.signed_header.commit.signatures)
                              for lb in list(chain.values())
                              + list(fork.values()))}


def phase_light(state, torch):
    """The light client (light/client.py) on the card, the verdict cache
    off: 150 ed25519 validators, heights 1..193 (BASELINE's 10,000-header
    sync cut to 193), 60 of the root's validators replaced at height 66
    and 60 more at 130 (30 of the root's 150 remain at 193: 20% of the
    power, under the 1/3 trust level), the root at height 1:
    1. sequential sync 1 -> 193, 48 headers a window on a
       VerifyPipeline of depth 2: four windows of 48 x 101 = 4,848
       signatures, one RLC program (K1-K4) each, the latency ledger's
       stages per window, every height stored;
    2. the same sync serial: pipeline_depth 1, one window of 192 headers
       (19,392 signatures), one RLC program;
    3. skipping sync 1 -> 193: the bisection's hops (1 -> 193 refused on
       trust with no launch, then 1 -> 109 and 109 -> 193), each
       verified hop two RLC programs (the trusting check's 51 signatures,
       then the new set's 101);
    4. backwards: a client rooted at 193 verifies 100 by hashes alone,
       no launch;
    5. reject: the primary's height-150 commit with one tampered
       signature (its 38th); step 1's sync raises the error naming
       height 150 and that signature, one K1 + K14 over the window's
       4,848 lanes beside the four RLC programs, and the store holds the
       root alone;
    6. witness attack: a witness serving a lunatic fork from height 191
       (a forged app_hash, signed by the same keys); step 1's sync then
       raises ErrLightClientAttack: common height 190, the 150 validators
       of the common set that signed the primary's commit as byzantine,
       the primary sent the evidence against the witness and the witness
       the evidence against the primary; the witness's chain 190 -> 193
       verified with two RLC programs.
    Each step's counts are set to 0 after its client is made (the root's
    own commit check is set-up) and read after it."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.libs import latledger
    from cometbft_tpu_torch.light import client as lc
    from cometbft_tpu_torch.light import verifier as lv
    from cometbft_tpu_torch.light.provider import MemoryProvider
    from cometbft_tpu_torch.types import validation as val
    from cometbft_tpu_torch.types.timestamp import Timestamp

    fx = _light_fixtures(state)
    chain, fork = fx["chain"], fx["fork"]
    cache = ed._A_TABLE_CACHE
    now = Timestamp(LIGHT_T0 + LIGHT_TOP + 60, 0)
    headers = LIGHT_TOP - 1
    out = {"validators": N_VALS, "heights": LIGHT_TOP,
           "depth_cut": f"{LIGHT_TOP} headers of BASELINE's 10,000",
           "rotations": [list(r) for r in LIGHT_ROTATIONS],
           "root_power_at_top": sum(
               v.voting_power for v in fx["sets"][LIGHT_TOP].validators
               if fx["sets"][1].has_address(v.address)),
           "signing_seconds": fx["signing_seconds"],
           "signatures": fx["signatures"]}

    def provider(blocks):
        return MemoryProvider(CHAIN_ID, dict(blocks))

    def client(primary, root=1, **kw):
        return lc.Client(CHAIN_ID, lc.TrustOptions(
            LIGHT_TRUST_NS, root, chain[root].hash()), primary=primary,
            now_fn=lambda: now, device=DEVICE, **kw)

    seq = dict(verification_mode=lc.SEQUENTIAL,
               sequential_batch_size=LIGHT_WINDOW, pipeline_depth=2)
    windows = -(-headers // LIGHT_WINDOW)
    sigs_per_commit = 2 * N_VALS // 3 + 1

    def run(c, height, label, expect=None):
        """Verify `height` through c; its seconds, launches, A-table
        hits and localizations, or the exception of type `expect`."""
        _zero_counts()
        h0, err = cache.hits, None
        with _persig(torch) as persig:
            t0 = time.perf_counter()
            try:
                c.verify_light_block_at_height(height)
            except Exception as e:              # noqa: BLE001
                if expect is None or not isinstance(e, expect):
                    raise
                err = e
            dt = time.perf_counter() - t0
        if expect is not None:
            check(err is not None, f"{label}: no {expect.__name__} raised")
        got = _counts()
        state["light_launches"] = _merge(state.get("light_launches", {}),
                                         got)
        return dt, got, cache.hits - h0, persig, err

    def counts(got):
        return {k: v for k, v in got.items() if v}

    # 1. sequential, pipelined
    ledger = latledger.LatLedgerRecorder()
    c = client(provider(chain), **seq)
    latledger.set_recorder(ledger)
    try:
        dt, got, hits, persig, _ = run(c, LIGHT_TOP, "sequential")
    finally:
        latledger.set_recorder(None)
    _want_launches(counts(got), _rlc_want(hits, windows), "sequential")
    _check_persig(persig, "sequential", 0, calls=0)
    check(sorted(h for h in range(1, LIGHT_TOP + 1)
                 if c.trusted_light_block(h) is not None)
          == list(range(1, LIGHT_TOP + 1)), "sequential: store incomplete")
    rows = ledger.rows()
    check(len(rows) == windows and all(
        r["path"] == "device" and r["consumer"] == "light" for r in rows),
        f"sequential ledger rows {[(r['path'], r['n']) for r in rows]}")
    check([r["n"] for r in rows] == [LIGHT_WINDOW * sigs_per_commit] * windows,
          f"sequential windows of {[r['n'] for r in rows]} signatures")
    out["sequential"] = {
        "window": LIGHT_WINDOW, "pipeline_depth": 2, "windows": windows,
        "seconds": dt, "headers_per_s": headers / dt,
        "signatures_per_window": [r["n"] for r in rows],
        "window_latency_ms": [r["wall"] * 1e3 for r in rows],
        "window_segments_ms": [{k: v * 1e3 for k, v in r["segs"].items()}
                               for r in rows],
        "a_table_hits": hits, "launches": counts(got)}

    # 2. sequential, serial, one window
    c = client(provider(chain), verification_mode=lc.SEQUENTIAL,
               sequential_batch_size=LIGHT_SERIAL_WINDOW, pipeline_depth=1)
    dt, got, hits, persig, _ = run(c, LIGHT_TOP, "serial")
    _want_launches(counts(got), _rlc_want(hits, 1), "serial")
    _check_persig(persig, "serial", 0, calls=0)
    check(c.store.size() == LIGHT_TOP, "serial: store incomplete")
    out["serial"] = {"window": LIGHT_SERIAL_WINDOW, "pipeline_depth": 1,
                     "seconds": dt, "headers_per_s": headers / dt,
                     "signatures": headers * sigs_per_commit,
                     "launches": counts(got)}

    # 3. skipping
    hops = []
    verify_lb = lv.verify_light_block

    def hop(trusted, untrusted, *a, **k):
        b0, h0, t0 = _counts(), cache.hits, time.perf_counter()
        rec = {"from": trusted.height, "to": untrusted.height}
        try:
            verify_lb(trusted, untrusted, *a, **k)
            rec["verified"] = True
        except lv.ErrNewValSetCantBeTrusted:
            rec["verified"] = False
            raise
        finally:
            rec.update(seconds=time.perf_counter() - t0,
                       launches=_launched(b0, _counts()),
                       a_table_hits=cache.hits - h0)
            hops.append(rec)

    c = client(provider(chain))
    lv.verify_light_block = hop
    try:
        dt, got, hits, persig, _ = run(c, LIGHT_TOP, "skipping")
    finally:
        lv.verify_light_block = verify_lb
    for rec in hops:
        _want_launches(rec["launches"], _rlc_want(
            rec["a_table_hits"], 2 if rec["verified"] else 0),
            f"skipping hop {rec['from']} -> {rec['to']}")
    pivot = 1 + (LIGHT_TOP - 1) * 9 // 16
    check([(r["from"], r["to"], r["verified"]) for r in hops] ==
          [(1, LIGHT_TOP, False), (1, pivot, True), (pivot, LIGHT_TOP, True)],
          f"skipping hops {[(r['from'], r['to']) for r in hops]}")
    check(sorted(h for h in (1, pivot, LIGHT_TOP)
                 if c.trusted_light_block(h)) == [1, pivot, LIGHT_TOP]
          and c.store.size() == 3, "skipping: store")
    out["skipping"] = {"seconds": dt, "headers_per_s": headers / dt,
                       "hops": hops, "launches": counts(got)}

    # 4. backwards
    top, target = LIGHT_BACK
    c = client(provider(chain), root=top)
    dt, got, _, persig, _ = run(c, target, "backwards")
    check(counts(got) == {}, f"backwards launched {counts(got)}")
    check(c.store.size() == 2 and c.trusted_light_block(target) is not None,
          "backwards: store")
    out["backwards"] = {"root": top, "target": target, "seconds": dt,
                        "headers_per_s": (top - target) / dt}

    # 5. reject: one tampered signature at LIGHT_BAD
    bad = dict(chain)
    lb = chain[LIGHT_BAD]
    commit, bad_sig = _with_sig(lb.signed_header.commit, LIGHT_BAD_SIG, 40, 1)
    bad[LIGHT_BAD] = type(lb)(type(lb.signed_header)(lb.header, commit),
                              lb.validator_set)
    c = client(provider(bad), **seq)
    dt, got, hits, persig, err = run(c, LIGHT_TOP, "reject",
                                     val.ErrInvalidSignature)
    check(str(err) == f"wrong signature in commit at height {LIGHT_BAD}: "
          f"{bad_sig.hex()}" and getattr(err, "failed_ctx", None)
          == LIGHT_BAD, f"reject: {err}")
    _want_launches(counts(got), _merge(_rlc_want(hits, windows),
                                       PERSIG_LAUNCHES), "reject")
    _check_persig(persig, "reject", LIGHT_WINDOW * sigs_per_commit)
    check(c.store.size() == 1 and c.trusted_light_block(1) is not None,
          f"reject: the store holds {c.store.size()} blocks")
    out["reject"] = {"height": LIGHT_BAD, "signature": LIGHT_BAD_SIG,
                     "seconds": dt, "localization_width": persig.widths,
                     "launches": counts(got)}

    # 6. a lying witness
    witness = provider({**chain, **fork})
    primary = provider(chain)
    c = client(primary, witnesses=[witness], **seq)
    dt, got, hits, persig, err = run(c, LIGHT_TOP, "attack",
                                     lc.ErrLightClientAttack)
    ev = err.evidence
    common = chain[LIGHT_FORK - 1]
    signers = [cs.validator_address for cs in
               chain[LIGHT_TOP].signed_header.commit.signatures]
    check(ev.common_height == LIGHT_FORK - 1 and
          ev.conflicting_block.hash() == chain[LIGHT_TOP].hash() and
          [v.address for v in ev.byzantine_validators] == signers and
          all(common.validator_set.has_address(a) for a in signers) and
          ev.total_voting_power == common.validator_set.total_voting_power(),
          f"attack evidence: common {ev.common_height}, "
          f"{len(ev.byzantine_validators)} byzantine")
    check(len(primary.reported_evidence) == 1 and
          primary.reported_evidence[0].conflicting_block.hash()
          == fork[LIGHT_TOP].hash() and len(witness.reported_evidence) == 1
          and witness.reported_evidence[0] is ev,
          "attack: the evidence did not reach both providers")
    _want_launches(counts(got), _rlc_want(hits, windows + 2), "attack")
    _check_persig(persig, "attack", 0, calls=0)
    check(c.store.size() == 1, f"attack: the store holds {c.store.size()}")
    out["attack"] = {"fork_from": LIGHT_FORK,
                     "common_height": ev.common_height,
                     "byzantine": len(ev.byzantine_validators),
                     "seconds": dt, "launches": counts(got)}
    launched = {k for k, v in state["light_launches"].items() if v}
    check(launched == DEFAULT_KERNELS,
          f"the light path launched {sorted(launched)}")
    out["launches"] = counts(state["light_launches"])
    _zero_counts()
    return out


# -- phase 13: block sync ----------------------------------------------------

BS_TOP = 193                   # heights 1..193: BASELINE's 100k cut to 193
BS_TXS = 2                     # kvstore transactions a height
BS_VAL_AT = 79                 # the kvstore val: transaction; the set
                               # changes at BS_VAL_AT + 2 = 81
BS_BAD = 16                    # step 3: the liar's tampered commit height
BS_BAD_SIG = 37                # ... at this signature, among the first 101
BS_T0 = 1_700_000_000
BS_TIMEOUT_S = 300.0


class _Reap:
    """The mempool seam of _bs_fixtures: reap returns the height's
    transactions, the rest does nothing."""

    def __init__(self):
        self.txs = []

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs)

    def pre_update(self):
        pass

    def lock(self):
        pass

    def unlock(self):
        pass

    def flush_app_conn(self):
        pass

    def update(self, *a, **k):
        pass


class _LoopPeer:
    """A node's handle on a remote node of a _LoopNet: try_send (and
    send, which never blocks here) hands an Envelope of wire bytes to the
    remote node's reactor for the channel, on the remote node's thread;
    set / get keep per-peer data (the consensus reactor's PeerState)."""

    def __init__(self, local, remote):
        self.id = remote.name
        self.local, self.remote = local, remote
        self.open, self.data = True, {}

    def try_send(self, ch, msg, tctx=None):
        from cometbft_tpu_torch.p2p.base_reactor import Envelope

        back = self.remote.peers.get(self.local.name)
        if not self.open or back is None:     # disconnected meanwhile
            return False
        self.remote.inbox.put(Envelope(src=back, message=bytes(msg),
                                       channel_id=ch, tctx=tctx))
        return True

    def send(self, ch, msg, tctx=None):
        return self.try_send(ch, msg, tctx)

    def set(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)


class _LoopSwitch:
    """What the reactor reads of a switch: peers.get / peers.list,
    try_broadcast and stop_peer_for_error (the peer dropped on both
    sides, the reason recorded)."""

    def __init__(self, node):
        self.node, self.peers, self.stopped = node, self, []

    def get(self, peer_id):
        return self.node.peers.get(peer_id)

    def list(self):
        return list(self.node.peers.values())

    def try_broadcast(self, ch, msg):
        for p in self.list():
            p.try_send(ch, msg)

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))
        self.node.net.disconnect(self.node, peer.remote, reason)


_RELEASE = object()


def _block_height(env):
    """The height of a BlockResponse on the wire, else None."""
    from cometbft_tpu_torch.blocksync import messages as bm
    m = bm.unwrap(env.message)
    return m.block.header.height if isinstance(m, bm.BlockResponse) \
        and m.block is not None else None


class _LoopNode:
    """A node's reactors (the first is `reactor`), each receiving the
    channels it declares, and a delivery thread."""

    def __init__(self, net, name, *reactors):
        import queue
        import threading

        self.net, self.name = net, name
        self.reactor, self.reactors = reactors[0], reactors
        self.by_channel = {d.id: r for r in reactors
                           for d in r.get_channels()}
        self.peers, self.inbox, self.held = {}, queue.Queue(), None
        self.switch = _LoopSwitch(self)
        for r in reactors:
            r.set_switch(self.switch)
        self.thread = threading.Thread(target=self._deliver, daemon=True,
                                       name=f"loop-{name}")
        self.thread.start()

    def _deliver(self):
        while True:
            env = self.inbox.get()
            if env is None:
                return
            if env is _RELEASE:
                held, self.held = self.held, None
                for e in sorted(held, key=lambda e: -_block_height(e)):
                    if e.src.open:
                        self._receive(e)
            elif self.held is not None and _block_height(env) is not None:
                self.held.append(env)
            elif env.src.open:
                self._receive(env)

    def _receive(self, env):
        self.by_channel.get(env.channel_id, self.reactor).receive(env)

    def hold(self):
        """Queue the blocks sent to this node (before it connects)."""
        self.held = []

    def release(self, n_blocks):
        """Once n_blocks blocks are held, deliver them highest first: the
        lowest lands last, so the sync routine's first window sees them
        all at once."""
        _bs_wait(lambda: len(self.held) >= n_blocks,
                 f"{n_blocks} held blocks", self.reactor)
        self.inbox.put(_RELEASE)


class _LoopNet:
    """Reactors joined in one process, every message as wire bytes
    (blocksync/messages.py, consensus/messages.py), a delivery thread a
    node: a test double of the p2p switch, which the port does not have
    yet."""

    def __init__(self):
        self.nodes = {}

    def add(self, name, *reactors):
        self.nodes[name] = _LoopNode(self, name, *reactors)
        return self.nodes[name]

    def connect(self, a, b):
        a, b = self.nodes[a], self.nodes[b]
        a.peers[b.name], b.peers[a.name] = _LoopPeer(a, b), _LoopPeer(b, a)
        for x, y in ((a, b), (b, a)):
            for r in x.reactors:
                r.init_peer(x.peers[y.name])
        for x, y in ((a, b), (b, a)):
            for r in x.reactors:
                r.add_peer(x.peers[y.name])

    def disconnect(self, a, b, reason):
        for x, y in ((a, b), (b, a)):
            p = x.peers.pop(y.name, None)
            if p is not None:
                p.open = False
                for r in x.reactors:
                    r.remove_peer(p, reason)

    def close(self):
        for n in self.nodes.values():
            for r in n.reactors:
                r.stop()
            n.inbox.put(None)
        for n in self.nodes.values():
            n.thread.join(10)


def _bs_wait(cond, what, reactor, timeout=BS_TIMEOUT_S):
    """Poll cond; raise what stopped the syncing reactor, if anything
    did (a kernel that does not build, a device fault)."""
    deadline = time.monotonic() + timeout
    while not cond():
        if reactor.error is not None:
            raise reactor.error
        check(time.monotonic() < deadline, f"blocksync: timed out waiting "
              f"for {what}")
        time.sleep(0.002)


def _bs_node(genesis, device, reap=None):
    """A node's stores (MemDB), its kvstore app after InitChain and its
    BlockExecutor on `device`."""
    import types

    from cometbft_tpu_torch.abci import types as at
    from cometbft_tpu_torch.abci.client import LocalClient
    from cometbft_tpu_torch.apps.kvstore import KVStoreApplication
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import make_genesis_state
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store.blockstore import BlockStore
    from cometbft_tpu_torch.store.kv import MemDB

    n = types.SimpleNamespace(state=make_genesis_state(genesis))
    n.sstore = StateStore(MemDB())
    n.sstore.bootstrap(n.state)
    n.bstore = BlockStore(MemDB())
    n.app = KVStoreApplication()
    n.client = LocalClient(n.app)
    n.client.init_chain(at.InitChainRequest(
        chain_id=genesis.chain_id, initial_height=n.state.initial_height))
    n.exe = BlockExecutor(n.sstore, n.client, reap, device=device)
    return n


def _bs_fixtures(state):
    """Heights 1..BS_TOP of a kvstore chain over the fixture phase's 150
    validators, built as the JAX package's simnet grow_chain builds one:
    proposals from the port's own BlockExecutor.create_proposal_block over
    a reap double (BS_TXS transactions `sim{h}x{t}=v{h}` a height), every
    validator signing the canonical precommit with one timestamp a height
    (in the pool), save_block, then apply_block.  The `val:` transaction
    at BS_VAL_AT adds a 151st validator whose key the script holds."""
    import base64

    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import block, canonical
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.part_set import PartSet
    from cometbft_tpu_torch.types.timestamp import Timestamp

    t0 = time.perf_counter()
    joiner_seed = _seed("blocksync-joiner")
    joiner = ed.PubKey(_pool_map(state["pool"], _pubkeys, [joiner_seed])[0])
    seed_of = dict(state["seed_of"])
    seed_of[joiner.address()] = joiner_seed
    genesis = GenesisDoc(
        chain_id=CHAIN_ID, genesis_time=Timestamp(BS_T0, 0),
        validators=[GenesisValidator(pub_key=v.pub_key, power=10)
                    for v in state["vals"].validators])
    reap = _Reap()
    src = _bs_node(genesis, DEVICE, reap)
    src.blocks, sign_s = [], 0.0
    last_ext = block.ExtendedCommit()
    for h in range(1, BS_TOP + 1):
        reap.txs = [f"sim{h}x{t}=v{h}".encode() for t in range(BS_TXS)]
        if h == BS_VAL_AT:
            reap.txs.append(b"val:" + base64.b64encode(joiner.bytes())
                            + b"!10")
        st = src.state
        blk = src.exe.create_proposal_block(
            h, st, last_ext, st.validators.get_proposer().address)
        parts = PartSet.from_data(blk.to_proto())
        bid = block.BlockID(blk.hash(), parts.header)
        ts = blk.header.time.add_ns(1_000_000_000)
        sb = canonical.vote_sign_bytes(CHAIN_ID, canonical.PRECOMMIT, h, 0,
                                       bid, ts)
        t1 = time.perf_counter()
        sigs = _pool_map(state["pool"], _sign, [
            (seed_of[v.address], sb) for v in st.validators.validators])
        sign_s += time.perf_counter() - t1
        last_ext = block.ExtendedCommit(
            height=h, round=0, block_id=bid, extended_signatures=[
                block.ExtendedCommitSig(block.BLOCK_ID_FLAG_COMMIT,
                                        v.address, ts, s)
                for v, s in zip(st.validators.validators, sigs)])
        src.bstore.save_block(blk, parts, last_ext.to_commit())
        src.state = src.exe.apply_block(st, bid, blk)
        src.blocks.append(blk)
    src.genesis, src.joiner = genesis, joiner
    src.build_seconds = time.perf_counter() - t0
    src.signing_seconds = sign_s
    return src


def _bs_liar_store(src):
    """The liar's store: the chain with one byte of signature BS_BAD_SIG
    flipped in the LastCommit of block BS_BAD + 1 (the commit of BS_BAD;
    the block's own ID changes, the commit's block ID does not)."""
    from cometbft_tpu_torch.store.blockstore import BlockStore
    from cometbft_tpu_torch.store.kv import MemDB
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.part_set import PartSet

    store = BlockStore(MemDB())
    for h in range(1, BS_TOP + 1):
        b = block.Block.from_proto(src.bstore.load_block_bytes(h))
        if h == BS_BAD + 1:
            b.last_commit, bad_sig = _with_sig(b.last_commit, BS_BAD_SIG,
                                               40, 1)
        store.save_block(b, PartSet.from_data(b.to_proto()),
                         src.bstore.load_seen_commit(h))
    return store, bad_sig


def _bs_sync(state, torch, fx, depth, liar_store=None, ledger=None,
             prof=None):
    """A fresh node on DEVICE syncs from two honest serving reactors
    (and, with liar_store, a third serving it, connected alone first).
    The counts are set to 0 just before the blocks are released and read
    when the node has handed off.  Returns the step's record."""
    from cometbft_tpu_torch.blocksync import pool as bpool
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.libs import devprof, latledger, trace
    from cometbft_tpu_torch.types import validation as val

    cache = ed._A_TABLE_CACHE
    src = fx["src"]
    tracer = trace.StageTracer()
    target = BS_TOP - 1
    me = _bs_node(src.genesis, DEVICE)
    me.reactor = br.BlocksyncReactor(me.state, me.exe, me.bstore, True,
                                     device=DEVICE, pipeline_depth=depth)
    serial = depth == 1
    peeks, windows, applies, blamed = {}, [], [], []
    pool = me.reactor.pool
    peek, redo = pool.peek_window, pool.redo_request

    def peek_window(max_blocks, offset=0):
        win, after = peek(max_blocks, offset)
        if win:
            peeks[win[0][0].header.height] = (len(win), after is not None)
        return win, after

    def redo_request(height):
        blamed.append(height)
        return redo(height)

    pool.peek_window, pool.redo_request = peek_window, redo_request
    verify, verify_async = val.DeferredSigBatch.verify, \
        val.DeferredSigBatch.verify_async
    validate = me.exe.validate_block

    def record(batch):
        hs = sorted({e[1] for e in batch._entries})
        return {"first": hs[0], "last": hs[-1], "blocks": len(hs),
                "signatures": batch.count()}

    def w_verify(self, device="cuda"):
        rec = record(self)
        triples = [(e[2], e[3], e[4]) for e in self._entries]
        rec["misses"] = len(sigcache.partition(triples)[1]) \
            if liar_store is not None else rec["signatures"]
        b0, h0, t0 = _counts(), cache.hits, time.perf_counter()
        try:
            verify(self, device=device)
            rec["ok"] = True
        except val.ErrInvalidSignature as e:
            rec.update(ok=False, failed_ctx=e.failed_ctx)
            raise
        finally:
            rec.update(seconds=time.perf_counter() - t0,
                       launches=_launched(b0, _counts()),
                       a_table_hits=cache.hits - h0)
            windows.append(rec)

    def w_verify_async(self, pipeline, subsystem="pipeline", lane=None):
        windows.append(record(self))
        return verify_async(self, pipeline, subsystem=subsystem, lane=lane)

    def w_validate(st, blk):
        b0, h0, t0 = _counts(), cache.hits, time.perf_counter()
        try:
            return validate(st, blk)
        finally:
            applies.append({"height": blk.header.height,
                            "seconds": time.perf_counter() - t0,
                            "launches": _launched(b0, _counts())
                            if serial else None,
                            "a_table_hits": cache.hits - h0})

    me.exe.validate_block = w_validate
    net = _LoopNet()
    sigcache.reset()
    val.DeferredSigBatch.verify = w_verify
    val.DeferredSigBatch.verify_async = w_verify_async
    latledger.set_recorder(ledger)
    devprof.set_recorder(prof)
    trace.set_tracer(tracer)
    try:
        with _persig(torch) as persig:
            net.add("me", me.reactor)
            honest = ("honest-a", "honest-b")
            for name in honest:
                net.add(name, br.BlocksyncReactor(
                    src.state, src.exe, src.bstore, False,
                    device=DEVICE)).reactor.start()
            if liar_store is not None:
                net.add("liar", br.BlocksyncReactor(
                    src.state, src.exe, liar_store, False,
                    device=DEVICE)).reactor.start()
            me.reactor.start()
            mine = net.nodes["me"]
            mine.hold()
            first = ("liar",) if liar_store is not None else honest
            for name in first:
                net.connect("me", name)
            _zero_counts()
            h0 = cache.hits
            t0 = time.perf_counter()
            mine.release(min(BS_TOP, len(first)
                             * bpool.MAX_PENDING_REQUESTS_PER_PEER))
            if liar_store is not None:
                _bs_wait(lambda: mine.switch.stopped, "the liar's stop",
                         me.reactor)
                for name in honest:
                    net.connect("me", name)
            _bs_wait(lambda: me.reactor.state.last_block_height >= target,
                     "the sync", me.reactor)
            seconds = time.perf_counter() - t0
            check(me.reactor.wait_synced(30),
                  "blocksync: timed out waiting for the hand-off")
            got = _counts()
            hits = cache.hits - h0
    finally:
        val.DeferredSigBatch.verify = verify
        val.DeferredSigBatch.verify_async = verify_async
        latledger.set_recorder(None)
        devprof.set_recorder(None)
        trace.set_tracer(None)
        net.close()
    state["blocksync_launches"] = _merge(state.get("blocksync_launches", {}),
                                         got)
    # the synced node against the source
    top = src.blocks[BS_TOP - 1]
    check(me.reactor.state.last_block_height == target and
          me.reactor.state.app_hash == top.header.app_hash and
          me.app.app_hash == top.header.app_hash and
          me.sstore.load().to_proto() == me.reactor.state.to_proto(),
          f"blocksync: the node stopped at height "
          f"{me.reactor.state.last_block_height}, app hash "
          f"{me.reactor.state.app_hash.hex()}, not {top.header.app_hash.hex()}")
    check(me.bstore.base() == 1 and me.bstore.height() == target and all(
        me.bstore.load_block_bytes(h) == src.bstore.load_block_bytes(h)
        and me.bstore.load_block(h).hash() == src.blocks[h - 1].hash()
        for h in range(1, target + 1)), "blocksync: the stored blocks "
          "differ from the source's")
    threshold = val.DeferredSigBatch.DEVICE_THRESHOLD
    device_windows = [w for w in windows
                      if w.get("misses", w["signatures"]) >= threshold]
    programs = [a for a in applies if a["height"] > 1]
    return {"me": me, "seconds": seconds, "got": got, "hits": hits,
            "windows": windows, "device_windows": device_windows,
            "applies": applies, "apply_programs": len(programs),
            "peeks": peeks, "blamed": blamed, "persig": persig,
            "stopped": list(mine.switch.stopped),
            "stages": {k: v for k, v in tracer.snapshot().items()
                       if k.startswith("blocksync.")},
            "blocks_per_s": target / seconds}


def _bs_check_launches(rec, label):
    """A serial step's launches, exactly: a window whose cache misses
    reach DeferredSigBatch's device threshold one RLC program (and one
    K1 + K14 more where it failed), one below it none; each applied
    block's validate_block one RLC program past the first height (its
    LastCommit's signatures the window's light check did not reach)."""
    for w in rec["windows"]:
        want = _rlc_want(w["a_table_hits"], 1) \
            if w in rec["device_windows"] else {}
        if not w["ok"]:
            want = _merge(want, PERSIG_LAUNCHES)
        _want_launches(w["launches"], want,
                       f"{label} window {w['first']}..{w['last']}")
    for a in rec["applies"]:
        _want_launches(a["launches"], _rlc_want(
            a["a_table_hits"], 1 if a["height"] > 1 else 0),
            f"{label} apply at {a['height']}")


def _bs_valset_break(rec):
    """The window that meets the set change: the window holding height
    BS_VAL_AT + 1 (the last under the old set) ends there, the next
    starts at BS_VAL_AT + 2; the peek it was collected from reached past
    it, so the change cut it (reactor.py's validators_hash check)."""
    change = BS_VAL_AT + 2
    wins = rec["windows"]
    i = next(i for i, w in enumerate(wins) if w["first"] <= change - 1
             <= w["last"])
    w, nxt = wins[i], wins[i + 1]
    n, has_after = rec["peeks"].get(w["first"], (0, False))
    usable = n if has_after else n - 1
    while usable & (usable - 1):
        usable &= usable - 1
    return {"window": [w["first"], w["last"]],
            "next": [nxt["first"], nxt["last"]],
            "peeked": n, "quantized": usable,
            "cut": w["last"] == change - 1 and nxt["first"] == change
            and usable > w["blocks"]}


def phase_blocksync(state, torch):
    """Block sync (blocksync/reactor.py) on the card, with the verdict
    cache on, as a node runs (cleared before each step, off after the
    phase): a kvstore chain of 193 heights over the 150 validators (BASELINE's
    100k blocks x 10k validators cut to 193 x 150), 2 transactions a
    height, a `val:` transaction at 79 adding a 151st validator (the set
    changes at 81), built by the port's BlockExecutor and signed in the
    pool; each step a fresh node syncs 192 blocks over the loopback
    double (_LoopNet), its first blocks held and released at once:
    1. serial (pipeline_depth 1) from two honest serving reactors: each
       window one RLC program (K1-K4; VERIFY_WINDOW 48 quantizes to 32
       blocks, 3,232 signatures); each applied block's validate_block
       (verify_commit, every signature: the 49-50 the window's light
       check did not reach are cache misses) one RLC program more;
    2. pipelined (depth 2; windows on the pipeline's blocksync lane):
       the same launches in total, the latency ledger's windows by stage,
       devprof's busy share, pipelined / serial;
    3. a lying peer, alone first: it serves block 17 with signature 37
       of its LastCommit flipped; the first window (1..16, its 20 blocks
       held and released at once) fails its RLC program and is localized
       by one K1 + K14 over its 1,616 live lanes, height 16 is blamed,
       the liar stopped; two honest peers then finish the sync;
    4. the validator-set change: the window holding height 80 ends there
       (cut), the next starts at 81 on the new set.
    Each step: app hash and stored blocks equal the source's; its figures
    on a line of their own (`blocksync_step`), with the card's name and
    power limit."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.libs import devprof, latledger
    from cometbft_tpu_torch.types import validation as val

    fx = {"src": _bs_fixtures(state)}
    src = fx["src"]
    state["bs_src"] = src          # the lightserve phase serves this chain
    out = {"validators": N_VALS, "heights": BS_TOP, "synced": BS_TOP - 1,
           "depth_cut": f"{BS_TOP} blocks x {N_VALS} validators of "
                        f"BASELINE's 100k x 10k",
           "verify_window": br.VERIFY_WINDOW, "card": state["card"],
           "build_seconds": src.build_seconds,
           "signing_seconds": src.signing_seconds,
           "app_hash": src.blocks[BS_TOP - 1].header.app_hash.hex()}

    def summary(rec):
        """The step's figures: windows as [first, last, signatures], the
        applied blocks' validate_block ms (median, sum, max) and, where
        the step is serial, their launches apart from the windows'."""
        ms = sorted(a["seconds"] * 1e3 for a in rec["applies"])
        per = [a["launches"] for a in rec["applies"]
               if a["launches"] is not None]
        return {"seconds": rec["seconds"],
                "blocks_per_s": rec["blocks_per_s"],
                "windows": [[x["first"], x["last"], x["signatures"]]
                            for x in rec["windows"]],
                "launches": {k: v for k, v in rec["got"].items() if v},
                "a_table_hits": rec["hits"],
                "apply_programs": rec["apply_programs"],
                "apply_launches": _merge(*per) if per else None,
                "stages": rec["stages"],
                "validate_ms": {"median": ms[len(ms) // 2], "sum": sum(ms),
                                "max": ms[-1]}}

    sigcache.set_enabled(True)
    try:
        # 1. serial
        rec = _bs_sync(state, torch, fx, 1)
        check(all(w["ok"] for w in rec["windows"]),
              "serial: a window failed")
        _bs_check_launches(rec, "serial")
        _want_launches({k: v for k, v in rec["got"].items() if v}, _rlc_want(
            rec["hits"], len(rec["device_windows"]) + rec["apply_programs"]),
            "serial")
        _check_persig(rec["persig"], "serial", 0, calls=0)
        check(rec["stopped"] == [] and rec["blamed"] == [],
              f"serial: stopped {rec['stopped']}, blamed {rec['blamed']}")
        brk = _bs_valset_break(rec)
        check(brk["cut"], f"serial: the set change did not cut a window: "
              f"{brk}")
        serial = rec
        out["serial"] = summary(rec)
        out["serial"]["window_ms"] = [w["seconds"] * 1e3
                                      for w in rec["windows"]]
        out["serial"]["window_launches"] = [w["launches"]
                                            for w in rec["windows"]]
        emit({"blocksync_step": "serial", "card": state["card"],
              **out["serial"]})

        # 2. pipelined
        ledger = latledger.LatLedgerRecorder()
        prof = devprof.DevprofRecorder()
        rec = _bs_sync(state, torch, fx, 2, ledger=ledger, prof=prof)
        rows = [r for r in ledger.rows() if r["consumer"] == "blocksync"]
        check(len(rows) == len(rec["windows"]) and all(
            r["path"] == ("device" if r["n"] >= val.DeferredSigBatch
                          .DEVICE_THRESHOLD else "host") for r in rows),
              f"pipelined ledger rows {[(r['path'], r['n']) for r in rows]}")
        _want_launches({k: v for k, v in rec["got"].items() if v}, _rlc_want(
            rec["hits"], len(rec["device_windows"]) + rec["apply_programs"]),
            "pipelined")
        _check_persig(rec["persig"], "pipelined", 0, calls=0)
        occ = devprof.occupancy_summary(prof.snapshot())
        out["pipelined"] = summary(rec)
        out["pipelined"].update(
            pipeline_depth=2,
            window_latency_ms=[r["wall"] * 1e3 for r in rows],
            window_segments_ms=[{k: v * 1e3 for k, v in r["segs"].items()}
                                for r in rows],
            busy_share=occ["device_occupancy_fraction"],
            staging_share=occ["host_bound_fraction"],
            idle_seconds=occ["idle_cause_seconds"],
            pipelined_over_serial=serial["seconds"] / rec["seconds"])
        emit({"blocksync_step": "pipelined", "card": state["card"],
              **out["pipelined"]})
        out["valset_change"] = {"serial": brk,
                                "pipelined": _bs_valset_break(rec)}
        emit({"blocksync_step": "valset_change", "card": state["card"],
              **out["valset_change"]})

        # 3. a lying peer
        store, bad_sig = _bs_liar_store(src)
        rec = _bs_sync(state, torch, fx, 1, liar_store=store)
        bad = [w for w in rec["windows"] if not w["ok"]]
        check(len(bad) == 1 and bad[0]["first"] == 1 and
              bad[0]["last"] == BS_BAD and bad[0]["failed_ctx"] == BS_BAD,
              f"lying peer: failed windows {bad}")
        check(rec["blamed"][:1] == [BS_BAD] and
              ("liar", "served invalid block") in rec["stopped"] and
              all(pid == "liar" for pid, _ in rec["stopped"]),
              f"lying peer: blamed {rec['blamed']}, stopped "
              f"{rec['stopped']}")
        _bs_check_launches(rec, "lying peer")
        _check_persig(rec["persig"], "lying peer", bad[0]["signatures"])
        out["lying_peer"] = summary(rec)
        out["lying_peer"].update(
            bad_height=BS_BAD, bad_signature=BS_BAD_SIG,
            bad_sig=bad_sig.hex()[:16], blamed=rec["blamed"],
            stopped=rec["stopped"], localization_width=rec["persig"].widths,
            failed_window_launches=bad[0]["launches"])
        emit({"blocksync_step": "lying_peer", "card": state["card"],
              **out["lying_peer"]})
    finally:
        sigcache.reset()
        sigcache.set_enabled(False)
    launched = {k for k, v in state["blocksync_launches"].items() if v}
    check(launched == DEFAULT_KERNELS,
          f"the blocksync path launched {sorted(launched)}")
    out["launches"] = {k: v for k, v in state["blocksync_launches"].items()
                       if v}
    _zero_counts()
    return out


# -- phase 14: the light-client serving plane ----------------------------------

LS_CLIENTS = 1000              # step 1: the fleet, coalescing off then on
LS_WORKERS = 16
LS_SAMPLE = 0.05               # step 1: clients verifying their bytes
LS_BAD = 100                   # step 2: the height whose commit is forged
LS_BAD_TARGET = 102            # step 2's target: no 9/16 pivot chain to the
                               # tip passes 100; to 102, 76 of 200 do
LS_BAD_SIG = 37                # ... at this signature, among the first 101
LS_BAD_CLIENTS = 200
LS_DEFAULT_CLIENTS = 300       # step 3: the default knobs


class _ReadOnlyStore:
    """A read-only double of a BlockStore: every read is the store's,
    except the commit of `bad`, whose signature `sig` has bit 1 of its
    byte 40 flipped (its s half); nothing can be written through it."""

    def __init__(self, store, bad, sig):
        self._store, self.bad, self.sig = store, bad, sig
        self.forged = None

    def __getattr__(self, name):
        if name.startswith(("save", "prune", "delete")):
            raise AttributeError(f"read-only store: {name}")
        return getattr(self._store, name)

    def _forge(self, commit):
        if self.forged is None:
            self.forged, _ = _with_sig(commit, self.sig, 40, 1)
        return self.forged

    def load_block_commit(self, h):
        c = self._store.load_block_commit(h)
        return self._forge(c) if h == self.bad and c is not None else c

    def load_seen_commit(self, h):
        c = self._store.load_seen_commit(h)
        return self._forge(c) if h == self.bad and c is not None else c


def _ls_lane(rows):
    """The lightserve lane's latency-ledger cuts: rows by path, wall p50
    / p99 (ms) of the device windows and the coalesced claimants, and
    each segment's p50 over the device windows."""
    dev = [r for r in rows if r["path"] == "device"]
    segs = sorted({k for r in dev for k in r["segs"]})
    paths = {}
    for r in rows:
        paths[r["path"]] = paths.get(r["path"], 0) + 1
    co = [r["wall"] * 1e3 for r in rows if r["path"] == "coalesced"]
    return {"rows_by_path": paths,
            "window_wall_ms_p50": _pct([r["wall"] * 1e3 for r in dev], 50),
            "window_wall_ms_p99": _pct([r["wall"] * 1e3 for r in dev], 99),
            "coalesced_wall_ms_p50": _pct(co, 50),
            "coalesced_wall_ms_p99": _pct(co, 99),
            "segments_ms_p50": {k: _pct([r["segs"][k] * 1e3 for r in dev
                                         if k in r["segs"]], 50)
                                for k in segs}}


def _ls_arm_figures(rec):
    return {k: rec[k] for k in ("clients", "wall_s", "clients_per_sec",
                                "p50_ms", "p99_ms", "verify_windows",
                                "verify_sigs", "pipeline_windows",
                                "verified_clients")}


def phase_lightserve(state, torch):
    """The light-client serving plane (lightserve/, simnet/lightfleet.py)
    on the card, over the blocksync phase's source chain (193 heights x
    150 validators, 151 from height 81), read through its stores and
    never written: no second build or signing pass.  The verdict cache
    is off but in step 3.
    1. launch run: DeferredSigBatch.DEVICE_THRESHOLD at 1 (a one-height
       window holds 101 signatures, under the default 128), a seeded
       fleet of 1,000 clients (fleet_mix: 85% within 3 blocks of the
       tip) over 16 workers through fleet_ab, coalescing off then on on
       one VerifyPipeline: every client served, the digests identical,
       the ON arm fewer windows and signatures; every window one RLC
       program and the 5% of clients that verify their bytes
       (verify_payload on the card) one each, K1-K4 exact and no K14;
       per arm clients/s, serve p50 / p99, windows, signatures, and the
       lightserve lane's latency-ledger cuts; ON / OFF;
    2. forged commit: a read-only store double serves height 100's
       commit with signature 37's s flipped; 200 clients to height 102
       (no pivot chain to the tip passes 100) on one coalescing session:
       exactly the clients whose path holds 100 fail with
       ErrInvalidSignature naming it, the rest are served; each window
       that held 100 is one RLC program and one K1 + K14 over its live
       lanes and counts one failed_heights, with one
       EV_LIGHTSERVE_REJECT each;
    3. default knobs: the cache on and both thresholds at their
       defaults, 300 clients coalesced on the default pipeline:
       clients/s and the windows that ran on the card against those on
       the host (the latency ledger's paths).
    Each step on a line of its own (`lightserve_step`) with the card's
    name and power limit."""
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.libs import flightrec, latledger
    from cometbft_tpu_torch.lightserve import LightServeSession, skip_path
    from cometbft_tpu_torch.simnet import lightfleet
    from cometbft_tpu_torch.types import validation as val

    import random

    src = state["bs_src"]
    cache = ed._A_TABLE_CACHE
    packs = state.setdefault("lightserve_packs", {})
    out = {"card": state["card"], "heights": src.bstore.height(),
           "validators": [N_VALS, N_VALS + 1], "chain": "the blocksync "
           "phase's source chain, read only"}
    launches = {}
    real_vc, real_fleet = val.verify_commit, lightfleet.run_fleet
    threshold = val.DeferredSigBatch.DEVICE_THRESHOLD
    sampled = []

    def counted_verify_commit(*a, **k):
        sampled.append(a[3])
        return real_vc(*a, **k)

    # -- 1. launch run ------------------------------------------------------
    ledger = latledger.LatLedgerRecorder(capacity=50_000,
                                         slo=latledger.SLOTracker(
                                             on_burn=lambda *a: None))
    arms = []

    def fleet(session, n, seed, **kw):
        """run_fleet, with the arm's launches, A-table hits, sampled
        verify_commit calls and ledger rows taken around it."""
        b0, h0, s0 = _counts(), cache.hits, ledger.recorded
        v0 = len(sampled)
        rec = real_fleet(session, n, seed, **kw)
        arms.append({"launches": _launched(b0, _counts()),
                     "hits": cache.hits - h0,
                     "sampled": sorted(sampled[v0:]),
                     "rows": (s0, ledger.recorded)})
        return rec

    val.DeferredSigBatch.DEVICE_THRESHOLD = 1
    val.verify_commit, lightfleet.run_fleet = counted_verify_commit, fleet
    latledger.set_recorder(ledger)
    try:
        with vd.VerifyPipeline(device=DEVICE) as pipe, \
                _persig(torch) as persig, _kept_packs(packs):
            _zero_counts()
            t0 = time.perf_counter()
            ab = lightfleet.fleet_ab(src.bstore, src.sstore, CHAIN_ID,
                                     LS_CLIENTS, SEED, workers=LS_WORKERS,
                                     device=DEVICE, sample_verify=LS_SAMPLE,
                                     pipeline=pipe)
            seconds = time.perf_counter() - t0
            got = _counts()
            _clean_pipe(pipe, "lightserve launch run")
    finally:
        val.DeferredSigBatch.DEVICE_THRESHOLD = threshold
        val.verify_commit, lightfleet.run_fleet = real_vc, real_fleet
        latledger.set_recorder(None)
    launches = _merge(launches, got)
    rows = ledger.rows()
    off, on = ab["arms"]["off"], ab["arms"]["on"]
    # the clients run_fleet samples (its seeded mask), and the heights of
    # their paths: one client-side verify_commit each
    tip = src.bstore.height()
    trusts = lightfleet.fleet_mix(LS_CLIENTS, tip, SEED)
    pick = random.Random(SEED + 2)
    mask = [pick.random() < LS_SAMPLE for _ in range(LS_CLIENTS)]
    want_sampled = sorted(h for t, m in zip(trusts, mask) if m
                          for h in skip_path(t, tip))
    figures = {}
    for name, rec, arm in (("off", off, arms[0]), ("on", on, arms[1])):
        check(rec["pipeline_windows"] == rec["verify_windows"],
              f"launch run {name}: {rec['pipeline_windows']} pipeline "
              f"windows for {rec['verify_windows']} session windows")
        check(rec["verified_clients"] == sum(mask) > 0 and
              arm["sampled"] == want_sampled,
              f"launch run {name}: {rec['verified_clients']} clients "
              f"verified {len(arm['sampled'])} heights, not {sum(mask)} "
              f"clients {len(want_sampled)} heights")
        _want_launches({k: v for k, v in arm["launches"].items() if v},
                       _rlc_want(arm["hits"], rec["verify_windows"]
                                 + len(arm["sampled"])),
                       f"launch run {name}")
        lo, hi = arm["rows"]
        figures[name] = {**_ls_arm_figures(rec),
                         "sampled_clients": sum(mask),
                         "client_side_verify_commits": len(arm["sampled"]),
                         "a_table_hits": arm["hits"],
                         "launches": {k: v for k, v in
                                      arm["launches"].items() if v},
                         "lightserve_lane": _ls_lane(
                             [r for r in rows if lo <= r["seq"] < hi
                              and r["consumer"] == "lightserve"])}
    _check_persig(persig, "lightserve launch run", 0, calls=0)
    out["launch_run"] = {
        "clients": LS_CLIENTS, "workers": LS_WORKERS, "seed": SEED,
        "sample_verify": LS_SAMPLE, "device_threshold": 1,
        "seconds": seconds, "digest": ab["digest"],
        "digest_parity": ab["digest_parity"],
        "on_over_off_clients_per_s": ab["coalesce_ratio"],
        "windows_on_over_off": on["verify_windows"] / off["verify_windows"],
        "sigs_on_over_off": on["verify_sigs"] / off["verify_sigs"],
        "light_clients_served_per_sec": ab["light_clients_served_per_sec"],
        "light_serve_p99_ms": ab["light_serve_p99_ms"], **figures}
    emit({"lightserve_step": "launch_run", "card": state["card"],
          **out["launch_run"]})

    # -- 2. a forged commit --------------------------------------------------
    sigcache.set_enabled(False)
    sigcache.reset()
    store = _ReadOnlyStore(src.bstore, LS_BAD, LS_BAD_SIG)
    rec_fr = flightrec.FlightRecorder()
    windows = []
    val.DeferredSigBatch.DEVICE_THRESHOLD = 1
    flightrec.set_recorder(rec_fr)
    try:
        with vd.VerifyPipeline(device=DEVICE) as pipe, \
                _persig(torch) as persig, _kept_packs(packs), \
                _kept_windows(pipe) as pipe_windows:
            session = LightServeSession(store, src.sstore, CHAIN_ID,
                                        coalesce=True, pipeline=pipe,
                                        device=DEVICE)
            verify_heights = session._verify_heights

            def recorded(heights, lane=None):
                b0, h0 = _counts(), cache.hits
                res = verify_heights(heights, lane=lane)
                windows.append({"heights": list(heights),
                                "failed": sorted(h for h, e in res.items()
                                                 if e is not None),
                                "launches": _launched(b0, _counts()),
                                "hits": cache.hits - h0})
                return res
            session._verify_heights = recorded
            session.coalescer._verify = recorded
            _zero_counts()
            try:
                t0 = time.perf_counter()
                bad = real_fleet(session, LS_BAD_CLIENTS, SEED,
                                 target=LS_BAD_TARGET, workers=LS_WORKERS)
                seconds = time.perf_counter() - t0
            finally:
                session.close()
            got = _counts()
            _clean_pipe(pipe, "lightserve forged commit")
    finally:
        val.DeferredSigBatch.DEVICE_THRESHOLD = threshold
        flightrec.set_recorder(None)
    launches = _merge(launches, got)
    _keep_localized(state, "lightserve_persig", pipe_windows, persig.widths,
                    "forged commit")
    trusts = lightfleet.fleet_mix(LS_BAD_CLIENTS, LS_BAD_TARGET, SEED)
    want_bad = {i for i, t in enumerate(trusts)
                if LS_BAD in skip_path(t, LS_BAD_TARGET)}
    failed = {}
    for f in bad["failures"]:
        i = int(f.split()[1])
        failed[i] = f.split(": ", 1)[1]
    msg = f"ErrInvalidSignature: invalid signature in commit at height {LS_BAD}"
    check(set(failed) == want_bad and all(m == msg for m in failed.values()),
          f"forged commit: {len(failed)} clients failed, {len(want_bad)} "
          f"hold height {LS_BAD}; messages {sorted(set(failed.values()))}")
    check(bad["clients"] == LS_BAD_CLIENTS - len(want_bad) > 0,
          f"forged commit: {bad['clients']} clients served")
    held = [w for w in windows if LS_BAD in w["heights"]]
    check(held and all(w["failed"] == [LS_BAD] for w in held) and
          not any(w["failed"] for w in windows if w not in held),
          f"forged commit: windows holding {LS_BAD}: "
          f"{[(w['heights'][:4], w['failed']) for w in held]}")
    for w in windows:
        want = _rlc_want(w["hits"], 1)
        if w in held:
            want = _merge(want, PERSIG_LAUNCHES)
        _want_launches(w["launches"], want,
                       f"forged commit window {w['heights'][:4]}...")
    rejects = [e for e in rec_fr.events()
               if e["kind"] == flightrec.EV_LIGHTSERVE_REJECT]
    check(session.failed_heights == len(held) == persig.calls and
          [e["height"] for e in rejects] == [LS_BAD] * len(held),
          f"forged commit: failed_heights {session.failed_heights}, "
          f"{len(held)} windows held it, {persig.calls} localizations, "
          f"{len(rejects)} EV_LIGHTSERVE_REJECT")
    check(src.bstore.load_block_commit(LS_BAD).signatures[LS_BAD_SIG]
          .signature != store.forged.signatures[LS_BAD_SIG].signature,
          "forged commit: the source store was written")
    out["forged_commit"] = {
        "height": LS_BAD, "signature": LS_BAD_SIG, "target": LS_BAD_TARGET,
        "clients": LS_BAD_CLIENTS, "failed_clients": len(failed),
        "served_clients": bad["clients"], "seconds": seconds,
        "windows": len(windows), "windows_holding_it": len(held),
        "failed_heights": session.failed_heights,
        "localization_widths": persig.widths,
        "ev_lightserve_reject": len(rejects),
        "launches": {k: v for k, v in got.items() if v}}
    emit({"lightserve_step": "forged_commit", "card": state["card"],
          **out["forged_commit"]})

    # -- 3. the default knobs ------------------------------------------------
    ledger = latledger.LatLedgerRecorder(capacity=50_000,
                                         slo=latledger.SLOTracker(
                                             on_burn=lambda *a: None))
    sigcache.set_enabled(True)
    sigcache.reset()
    latledger.set_recorder(ledger)
    small = []
    try:
        with vd.VerifyPipeline(device=DEVICE) as pipe, _kept_packs(packs):
            stage = pipe._stage

            def staged(win):
                """A window under its device threshold goes to the host
                loop by design: count it."""
                if len(win.items) < max(1, win.threshold):
                    small.append(len(win.items))
                return stage(win)
            pipe._stage = staged
            session = LightServeSession(src.bstore, src.sstore, CHAIN_ID,
                                        pipeline=pipe, device=DEVICE)
            _zero_counts()
            h0 = cache.hits
            try:
                t0 = time.perf_counter()
                dflt = real_fleet(session, LS_DEFAULT_CLIENTS, SEED + 1,
                                  workers=LS_WORKERS)
                seconds = time.perf_counter() - t0
            finally:
                session.close()
            got = _counts()
            hits = cache.hits - h0
            stats = sigcache.cache().stats()
            counters = {k: getattr(pipe, k) for k in (
                "submitted", "device_windows", "host_windows", "faults",
                "staging_fallbacks", "drained_windows")}
    finally:
        latledger.set_recorder(None)
        sigcache.reset()
        sigcache.set_enabled(False)
    launches = _merge(launches, got)
    check(not dflt["failures"] and dflt["clients"] == LS_DEFAULT_CLIENTS,
          f"default knobs: {dflt['clients']} served, failures "
          f"{dflt['failures'][:3]}")
    check(counters["faults"] == counters["staging_fallbacks"] ==
          counters["drained_windows"] == 0 and
          counters["host_windows"] == len(small),
          f"default knobs: pipeline {counters}, {len(small)} windows under "
          f"the threshold")
    _want_launches({k: v for k, v in got.items() if v},
                   _rlc_want(hits, counters["device_windows"]),
                   "default knobs")
    rows = [r for r in ledger.rows() if r["consumer"] == "lightserve"]
    by_path = {}
    for r in rows:
        by_path[r["path"]] = by_path.get(r["path"], 0) + 1
    out["default_knobs"] = {
        "clients": LS_DEFAULT_CLIENTS,
        "device_threshold": val.DeferredSigBatch.DEVICE_THRESHOLD,
        "window_ms": session.coalescer.window_s * 1e3,
        "max_batch": session.coalescer.max_batch,
        "clients_per_sec": dflt["clients_per_sec"],
        "p50_ms": dflt["p50_ms"], "p99_ms": dflt["p99_ms"],
        "verify_windows": session.verify_windows,
        "verify_sigs": session.verify_sigs,
        "windows_by_path": by_path, "seconds": seconds,
        "pipeline": counters, "a_table_hits": hits,
        "host_share_of_windows": by_path.get("host", 0) / max(
            1, sum(v for k, v in by_path.items() if k != "coalesced")),
        "cache_hits": stats["hits"], "cache_misses": stats["misses"],
        "launches": {k: v for k, v in got.items() if v}}
    emit({"lightserve_step": "default_knobs", "card": state["card"],
          **out["default_knobs"]})
    state["lightserve_launches"] = launches
    launched = {k for k, v in launches.items() if v}
    check(launched == DEFAULT_KERNELS,
          f"the lightserve path launched {sorted(launched)}")
    out["launches"] = {k: v for k, v in launches.items() if v}
    _zero_counts()
    return out


# -- phase 15: consensus -----------------------------------------------------

# validators of equal power, a node each: 11, not 16.  One interpreter
# carries every node (a state thread, a delivery thread and three gossip
# threads a peer: 341 threads at 11, 736 at 16), and on the H100 host 16
# nodes did not pass height 3 in 45 s at any of the timeouts tried; 11
# keeps every LastCommit at 8 signatures or more (+2/3 of 11 is 8)
CS_NODES = 11
CS_TOP = 20                    # step 1 runs every node past this height
CS_TXS = 2000                  # kvstore transactions in node 0's mempool
CS_DEFAULT_TOP = 8             # step 2 (the default knobs) runs this far
CS_EVIDENCE_AFTER = 2          # step 3 runs this far past the evidence
CS_TAMPER_AT = 6               # step 4's tampered votes from this height
CS_TIMEOUT_S = 300.0


def _cs_config():
    """The consensus timeouts every step runs: CometBFT's defaults
    (ConsensusConfig(): propose 3 s, prevote and precommit 1 s, each
    0.5 s more a round, commit 1 s).  At test_consensus_config's 20-80
    ms the in-process nodes' rounds time out faster than one
    interpreter delivers their gossip, and no height is decided."""
    from cometbft_tpu_torch.consensus import state as cstate
    return cstate.ConsensusConfig()


def _cs_genesis(privs):
    """The genesis of CHAIN_ID with `privs`' keys as validators of equal
    power."""
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)
    from cometbft_tpu_torch.types.timestamp import Timestamp

    return GenesisDoc(
        chain_id=CHAIN_ID, genesis_time=Timestamp(BS_T0, 0),
        validators=[GenesisValidator(pub_key=p.pub_key(), power=10)
                    for p in privs])


def _cs_node(name, genesis, priv, verifier, wal_root=None):
    """One full node on DEVICE from `genesis`: a kvstore app behind a
    LocalClient, a CListMempool, state and block stores on MemDB, an
    EvidencePool, an EventBus, a BlockExecutor, a FilePV on `priv` (None:
    a node that does not sign), a WAL (under wal_root, if given), a
    ConsensusState and a ConsensusReactor on `verifier` (None: the
    process's default_verifier)."""
    import types

    from cometbft_tpu_torch.abci import types as at
    from cometbft_tpu_torch.abci.client import LocalClient
    from cometbft_tpu_torch.apps.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.consensus.state import ConsensusState
    from cometbft_tpu_torch.consensus.wal import WAL
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import make_genesis_state
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store.blockstore import BlockStore
    from cometbft_tpu_torch.store.kv import MemDB
    from cometbft_tpu_torch.types.events import EventBus

    n = types.SimpleNamespace(name=name, priv=priv)
    state = make_genesis_state(genesis)
    n.app = KVStoreApplication()
    n.client = LocalClient(n.app)
    n.client.init_chain(at.InitChainRequest(chain_id=CHAIN_ID,
                                            initial_height=1))
    n.mempool = CListMempool(n.client)
    n.sstore = StateStore(MemDB())
    n.sstore.bootstrap(state)
    n.bstore = BlockStore(MemDB())
    n.evpool = EvidencePool(MemDB(), n.sstore, n.bstore, device=DEVICE)
    n.bus = EventBus()
    n.bus.start()
    n.exe = BlockExecutor(n.sstore, n.client, n.mempool, n.evpool,
                          block_store=n.bstore, event_bus=n.bus,
                          device=DEVICE)
    n.wal = None if wal_root is None else WAL(
        os.path.join(wal_root, name, "wal"))
    n.cs = ConsensusState(_cs_config(), state, n.exe, n.bstore, wal=n.wal,
                          priv_validator=None if priv is None
                          else FilePV(priv),
                          event_bus=n.bus, evidence_pool=n.evpool,
                          mempool=n.mempool, device=DEVICE)
    n.reactor = ConsensusReactor(n.cs, device=DEVICE, verifier=verifier)
    return n


class _Nodes:
    """What the consensus and p2p networks share: waiting on their
    nodes, and reading their chains back."""

    def wait(self, cond, what, nodes=None, timeout=CS_TIMEOUT_S):
        """Poll cond; raise what stopped a node's state machine."""
        nodes = self.nodes if nodes is None else nodes
        deadline = time.monotonic() + timeout
        while not cond():
            for n in nodes:
                if n.cs.crash_error is not None:
                    raise n.cs.crash_error
            check(time.monotonic() < deadline, f"consensus: timed out "
                  f"waiting for {what}; heights "
                  f"{[n.cs.height for n in self.nodes]}")
            time.sleep(0.02)

    def run_past(self, height, nodes=None):
        nodes = self.nodes if nodes is None else nodes
        self.wait(lambda: min(n.cs.height for n in nodes) > height,
                  f"every node past height {height}", nodes)

    def same_blocks(self, label, nodes=None):
        """Every node's blocks up to the lowest store height are one
        chain; returns that height."""
        nodes = self.nodes if nodes is None else nodes
        top = min(n.bstore.height() for n in nodes)
        for h in range(1, top + 1):
            got = {n.bstore.load_block(h).hash() for n in nodes}
            check(len(got) == 1, f"{label}: {len(got)} different blocks "
                  f"at height {h}")
        return top

    def rounds(self, top):
        """The commit round of each height 1..top, from node 0."""
        return [self.nodes[0].bstore.load_seen_commit(h).round
                for h in range(1, top + 1)]


class _CsNet(_Nodes):
    """CS_NODES port validators, each a full node (_cs_node) with its WAL
    under wal_root, if given, and its ConsensusReactor on `verifier`;
    start() dials every node from every other over a _LoopNet."""

    def __init__(self, privs, verifier, wal_root=None):
        genesis = _cs_genesis(privs)
        self.net, self.closed = _LoopNet(), False
        self.nodes = [_cs_node(f"v{i:02d}", genesis, priv, verifier,
                               wal_root)
                      for i, priv in enumerate(privs)]

    def start(self):
        for n in self.nodes:
            self.net.add(n.name, n.reactor).reactor.start()
        names = [n.name for n in self.nodes]
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                self.net.connect(a, b)

    def close(self):
        if self.closed:
            return
        self.closed = True
        self.net.close()
        for n in self.nodes:
            n.bus.stop()
            if n.wal is not None:
                n.wal.close()


def _cs_privs():
    from cometbft_tpu_torch.crypto import ed25519 as ed
    return [ed.PrivKey.generate(_seed("consensus", i))
            for i in range(CS_NODES)]


def _cs_heights(cs_net, top, t0, commit_at):
    """heights/s to `top`, per-height ms (p50, p90) from node 0's
    commits, and the heights whose commit took more than one round."""
    gaps = [(commit_at[h] - commit_at[h - 1]) * 1e3
            for h in range(2, top + 1) if h in commit_at and h - 1 in commit_at]
    rounds = cs_net.rounds(top)
    return {"heights": top,
            "heights_per_s": top / (commit_at[top] - t0),
            "height_ms_p50": _pct(gaps, 50), "height_ms_p90": _pct(gaps, 90),
            "multi_round_heights": [h for h, r in enumerate(rounds, 1)
                                    if r > 0],
            "commit_rounds": rounds}


def _cs_timed_commits(node):
    """Record perf_counter at each height node applies."""
    commit_at = {}
    apply = node.exe.apply_verified_block

    def timed(st, bid, block, syncing_to_height=None):
        out = apply(st, bid, block, syncing_to_height)
        commit_at[block.header.height] = time.perf_counter()
        return out
    node.exe.apply_verified_block = timed
    return commit_at


def _cs_launch_run(state, torch):
    """Steps 1, 4 and 5 in one network: cache off, the vote stream's
    device threshold 1, CS_TXS transactions in node 0's mempool, every
    node past CS_TOP; node 1 is sent tampered votes from CS_TAMPER_AT on
    until one lands in a vote window; node 0 is then cut off and stopped
    and its WAL read back.  The counts are set to 0 just before the
    nodes start and read once every node, the stream and every window
    have stopped."""
    import shutil
    import tempfile

    from cometbft_tpu_torch.consensus import messages as cmsgs
    from cometbft_tpu_torch.consensus import reactor as creactor
    from cometbft_tpu_torch.consensus.round_types import STEP_NEW_HEIGHT
    from cometbft_tpu_torch.consensus.wal import EndHeightMessage
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import votestream as vs_mod
    from cometbft_tpu_torch.libs import devprof, latledger
    from cometbft_tpu_torch.p2p.base_reactor import Envelope
    from cometbft_tpu_torch.types import block as tblock
    from cometbft_tpu_torch.types import validation as val
    from cometbft_tpu_torch.types import vote_set as vset_mod
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import PREVOTE_TYPE, Vote

    privs = _cs_privs()
    cache = ed._A_TABLE_CACHE
    wal_root = tempfile.mkdtemp(prefix="cs-wal-")
    windows, checks, tamper_adds, landed = [], [], [], []
    tampered = {}                      # signature -> height
    packs = state.setdefault("consensus_packs", {})
    rec = {}
    real_vc, real_dv = val.verify_commit, cb._device_verify

    def counted_verify_commit(chain_id, vals, block_id, height, commit,
                              device="cuda"):
        n = sum(1 for s in commit.signatures
                if s.block_id_flag != tblock.BLOCK_ID_FLAG_ABSENT)
        checks.append((height, n, val._should_batch_verify(vals, commit)))
        return real_vc(chain_id, vals, block_id, height, commit,
                       device=device)

    def kept_device_verify(pubkeys, parsed, device, packed=cb._NO_PACK):
        ok, verdicts = real_dv(pubkeys, parsed, device, packed=packed)
        _keep_pack(packs, pubkeys, parsed, packed, ok)
        return ok, verdicts

    ledger = latledger.LatLedgerRecorder(slo=latledger.SLOTracker(
        on_burn=lambda *a: None))
    prof = devprof.DevprofRecorder()
    net = None
    with vd.VerifyPipeline(device=DEVICE) as pipe:
        sv = vs_mod.StreamingVerifier(device_threshold=1, pipeline=pipe,
                                      device=DEVICE)
        sv.start()
        try:
            t0 = time.perf_counter()
            check(sv.warmed.wait(timeout=900) and sv.warm_error is None,
                  f"consensus: the stream's pre-warm: {sv.warm_error!r}")
            rec["prewarm_seconds"] = time.perf_counter() - t0
            real_submit = pipe.submit

            def submit(items, **kw):
                items = list(items)
                h = real_submit(items, **kw)
                if kw.get("subsystem") == "consensus":
                    windows.append((items, h))
                    if any(sig in tampered for _, _, sig in items):
                        landed.append(len(windows) - 1)
                return h
            pipe.submit = submit
            net = _CsNet(privs, sv, wal_root)
            nodes = net.nodes
            target, liar = nodes[1], nodes[2]
            for i in range(CS_TXS):
                nodes[0].mempool.check_tx(b"cs%05d=v%d" % (i, i % 97))
            commit_at = _cs_timed_commits(nodes[0])

            def inject(kind, cs, data):
                """On node 1 entering a height from CS_TAMPER_AT on, until
                one lands in a window: a nil prevote for (height, 0) of
                validator 2, its signature's first bit flipped, sent by
                validator 2's peer handle."""
                if kind != "new_round_step" or cs.step != STEP_NEW_HEIGHT \
                        or cs.height < CS_TAMPER_AT or landed:
                    return
                addr = liar.priv.pub_key().address()
                idx, _ = cs.validators.get_by_address(addr)
                v = Vote(type=PREVOTE_TYPE, height=cs.height, round=0,
                         block_id=tblock.BlockID(),
                         timestamp=Timestamp(BS_T0 + cs.height, len(tampered)),
                         validator_address=addr, validator_index=idx)
                sig = liar.priv.sign(v.sign_bytes(CHAIN_ID))
                v.signature = bytes([sig[0] ^ 1]) + sig[1:]
                tampered[v.signature] = cs.height
                node = net.net.nodes[target.name]
                node.inbox.put(Envelope(
                    src=node.peers[liar.name],
                    channel_id=creactor.VOTE_CHANNEL,
                    message=cmsgs.wrap_message(cmsgs.VoteMessage(v))))
            target.cs.listeners.append(inject)
            preverify = target.reactor._preverify_vote

            def held(vote, tctx=None):
                """Node 1's reactor hands a tampered vote to its state
                machine once the vote's window has resolved, as a state
                thread that lags the verifier takes it (one that takes
                it at once cancels the pending verdict and verifies the
                vote itself)."""
                preverify(vote, tctx=tctx)
                if vote.signature in tampered and vote.preverified:
                    try:
                        vote.preverified.future.result(timeout=600)
                    except Exception:                   # noqa: BLE001
                        pass            # the window checks report it
            target.reactor._preverify_vote = held
            try_add = target.cs._try_add_vote

            def tracked(vote, peer_id):
                r = try_add(vote, peer_id)
                if vote.signature in tampered:
                    tamper_adds.append((vote.height, r))
                return r
            target.cs._try_add_vote = tracked

            val.verify_commit, cb._device_verify = (counted_verify_commit,
                                                    kept_device_verify)
            latledger.set_recorder(ledger)
            devprof.set_recorder(prof)
            vset_mod.reset_verify_paths()
            with _persig(torch) as persig:
                _zero_counts()
                h0 = cache.hits
                t_start = time.perf_counter()
                net.start()
                net.run_past(CS_TOP)
                t_end = time.perf_counter()
                # step 5: node 0 cut off from every peer and stopped, its
                # WAL read back
                n0 = nodes[0]
                for other in nodes[1:]:
                    net.net.disconnect(net.net.nodes[n0.name],
                                       net.net.nodes[other.name], "stopped")
                n0.reactor.stop()
                rec["node0_height"] = n0.bstore.height()
                rec["wal_end_heights"] = sorted(
                    m.msg.height for m in n0.wal.replay()
                    if isinstance(m.msg, EndHeightMessage))
                net.close()
                sv.stop()
                for _, h in windows:
                    h.result(timeout=600)
                got = _counts()
                hits = cache.hits - h0
        finally:
            val.verify_commit, cb._device_verify = real_vc, real_dv
            latledger.set_recorder(None)
            devprof.set_recorder(None)
            if net is not None:
                net.close()
            sv.stop()
            shutil.rmtree(wal_root, ignore_errors=True)
    rec.update(net=net, windows=windows, checks=checks, got=got, hits=hits,
               persig=persig, tampered=tampered, landed=landed,
               tamper_adds=tamper_adds, seconds=t_end - t_start,
               t_start=t_start, commit_at=commit_at, ledger=ledger,
               prof=prof, paths=vset_mod.verify_paths(), stream=sv)
    _keep_localized(state, "consensus_persig", windows, persig.widths,
                    "launch run")
    return rec


def _cs_check_launch_run(state, rec, out):
    """Steps 1, 4 and 5's checks and figures."""
    import collections

    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.libs import devprof

    net = rec["net"]
    top = net.same_blocks("launch run")
    check(top >= CS_TOP, f"launch run: the nodes hold {top} blocks")
    # each tx committed once, every app hash the tx count
    txs = [tx for h in range(1, top + 1)
           for tx in net.nodes[1].bstore.load_block(h).data.txs]
    check(len(txs) == CS_TXS and len(set(txs)) == CS_TXS,
          f"launch run: {len(txs)} txs committed, {len(set(txs))} distinct")
    want_hash = CS_TXS.to_bytes(8, "big")
    check(all(n.app.app_hash == want_hash and
              n.cs.state.app_hash == want_hash for n in net.nodes),
          f"launch run: app hashes "
          f"{sorted({n.app.app_hash.hex() for n in net.nodes})}")
    # every LastCommit check one RLC program
    checks = rec["checks"]
    check(checks and all(batch and n >= cb.DEVICE_THRESHOLD
                         for _, n, batch in checks),
          f"launch run: LastCommit checks (height, signatures, batched) "
          f"{[c for c in checks if not c[2] or c[1] < cb.DEVICE_THRESHOLD]}")
    check(min(n for _, n, _ in checks) >= 2 * CS_NODES // 3 + 1,
          "launch run: a LastCommit below +2/3")
    # every vote window one RLC program (two votes and more), a window
    # of one K1 + K14, a window with a rejected vote one K1 + K14 more
    sizes, n_rlc, n_persig, rejected = [], 0, 0, []
    for items, h in rec["windows"]:
        check(h.path == "device", f"launch run: a vote window resolved "
              f"on {h.path}")
        ok, verdicts = h.result(timeout=0)
        n = len(items)
        sizes.append(n)
        n_rlc += n >= 2
        n_persig += n == 1 or not all(verdicts)
        if not all(verdicts):
            rejected.append((n, [sig in rec["tampered"]
                                 for (_, _, sig), v in zip(items, verdicts)
                                 if not v]))
    want = _merge(_rlc_want(rec["hits"], len(checks) + n_rlc),
                  *[PERSIG_LAUNCHES] * n_persig)
    _want_launches({k: v for k, v in rec["got"].items() if v}, want,
                   "launch run")
    check(rec["persig"].calls == n_persig, f"launch run: "
          f"{rec['persig'].calls} localizations, not {n_persig}")
    sv = rec["stream"]
    check(sv.device_fallbacks == sv.build_errors == 0 and
          sv.path_flushes["host"] == 0,
          f"launch run: stream fallbacks {sv.device_fallbacks}, build "
          f"errors {sv.build_errors}, flushes {dict(sv.path_flushes)}")
    state["consensus_launches"] = rec["got"]
    # step 4: the tampered vote's window, localized once; not added
    hit = [(n, bad) for n, bad in rejected if any(bad)]
    check(len(hit) == 1 and all(hit[0][1]) and len(rejected) == 1,
          f"tampered vote: rejected windows (size, tampered?) {rejected}")
    check(rec["tamper_adds"] and not any(r for _, r in rec["tamper_adds"]),
          f"tampered vote: add results {rec['tamper_adds']}")
    # step 5: node 0's WAL ends every height it committed
    check(rec["wal_end_heights"] == list(range(1, rec["node0_height"] + 1)),
          f"WAL: end heights {rec['wal_end_heights'][:5]}... for "
          f"{rec['node0_height']} heights")
    rows = [r for r in rec["ledger"].rows() if r["consumer"] == "consensus"]
    segs = sorted({k for r in rows for k in r["segs"]})
    occ = devprof.occupancy_summary(rec["prof"].snapshot())
    paths = dict(sum((n.reactor.vote_paths for n in net.nodes),
                     collections.Counter()))
    out["launch_run"] = {
        "seconds": rec["seconds"], "prewarm_seconds": rec["prewarm_seconds"],
        **_cs_heights(net, CS_TOP, rec["t_start"], rec["commit_at"]),
        "txs": CS_TXS, "app_hash": want_hash.hex(),
        "lastcommit_checks": len(checks),
        "lastcommit_signatures": [min(n for _, n, _ in checks),
                                  max(n for _, n, _ in checks)],
        "vote_windows": len(sizes), "vote_window_sizes": {
            str(k): sizes.count(k) for k in sorted(set(sizes))},
        "rlc_programs": len(checks) + n_rlc, "localizations": n_persig,
        "a_table_hits": rec["hits"],
        "launches": {k: v for k, v in rec["got"].items() if v},
        "votes_streamed": rec["paths"].get("stream", 0),
        "votes_inline": rec["paths"].get("inline", 0),
        "reactor_vote_paths": paths,
        "devprof_busy_share": occ["device_occupancy_fraction"],
        "devprof_idle_seconds": occ["idle_cause_seconds"],
        "consensus_lane": {
            "windows": len(rows),
            "wall_ms_p50": _pct([r["wall"] * 1e3 for r in rows], 50),
            "wall_ms_p99": _pct([r["wall"] * 1e3 for r in rows], 99),
            "segments_ms_p50": {k: _pct([r["segs"][k] * 1e3 for r in rows
                                         if k in r["segs"]], 50)
                                for k in segs}}}
    emit({"consensus_step": "launch_run", "card": state["card"],
          **out["launch_run"]})
    items = rec["windows"][rec["landed"][0]][0]
    bad_sigs = [sig for _, _, sig in items if sig in rec["tampered"]]
    out["tampered_vote"] = {
        "height": rec["tampered"][bad_sigs[0]],
        "sent": len(rec["tampered"]), "window_size": hit[0][0],
        "localized_windows_of_that_size": rec["persig"].widths.count(
            hit[0][0]), "add_results": rec["tamper_adds"]}
    emit({"consensus_step": "tampered_vote", "card": state["card"],
          **out["tampered_vote"]})
    out["wal"] = {"node": "v00", "heights": rec["node0_height"],
                  "end_height_messages": len(rec["wal_end_heights"])}
    emit({"consensus_step": "wal", "card": state["card"], **out["wal"]})


def _cs_default_run(state, out):
    """Step 2: the default knobs (the verdict cache on, shared by every
    in-process node; default_verifier at 2 ms and 256), CS_DEFAULT_TOP
    heights."""
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.crypto import votestream as vs_mod
    from cometbft_tpu_torch.types import vote_set as vset_mod

    sigcache.set_enabled(True)
    sigcache.reset()
    dv = vs_mod.default_verifier(DEVICE)
    check(dv.warmed.wait(timeout=900) and dv.warm_error is None,
          f"default pre-warm: {dv.warm_error!r}")
    net = _CsNet(_cs_privs(), None)
    commit_at = _cs_timed_commits(net.nodes[0])
    vset_mod.reset_verify_paths()
    try:
        _zero_counts()
        t0 = time.perf_counter()
        net.start()
        net.run_past(CS_DEFAULT_TOP)
        got = _counts()
        stats = sigcache.cache().stats()
    finally:
        net.close()
        dv.stop()
        sigcache.reset()
        sigcache.set_enabled(False)
    net.same_blocks("default knobs")
    out["default_knobs"] = {
        "label": "in-process nodes on one shared verdict cache and "
                 "verifier: not per-node figures",
        "flush_ms": dv.flush_interval * 1e3,
        "device_threshold": dv.device_threshold,
        **_cs_heights(net, CS_DEFAULT_TOP, t0, commit_at),
        "launches": {k: v for k, v in got.items() if v},
        "stream_flushes_by_path": dict(dv.path_flushes),
        "stream_votes_by_path": dict(dv.path_votes),
        "votes_streamed": vset_mod.verify_paths().get("stream", 0),
        "votes_inline": vset_mod.verify_paths().get("inline", 0),
        "cache_hits": stats["hits"], "cache_misses": stats["misses"]}
    emit({"consensus_step": "default_knobs", "card": state["card"],
          **out["default_knobs"]})


def _cs_byzantine(node):
    """tests/test_byzantine.py's _make_byzantine on a port node: after
    its honest prevote for a block, a conflicting prevote signed with the
    raw key (the FilePV would refuse), sent to every peer."""
    from cometbft_tpu_torch.consensus import messages as cmsgs
    from cometbft_tpu_torch.consensus import reactor as creactor
    from cometbft_tpu_torch.types import block as tblock
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import PREVOTE_TYPE, Vote

    cs = node.cs
    sign_add, try_add = cs._sign_add_vote, cs._try_add_vote

    def byz_sign_add_vote(msg_type, hash_, header, block=None):
        sign_add(msg_type, hash_, header, block)
        if msg_type != PREVOTE_TYPE or not hash_:
            return
        addr = cs.priv_validator_pub_key.address()
        idx, _ = cs.validators.get_by_address(addr)
        other = _seed("equivocation", cs.height, cs.round)
        v = Vote(type=PREVOTE_TYPE, height=cs.height, round=cs.round,
                 block_id=tblock.BlockID(other, tblock.PartSetHeader(
                     1, hashlib.sha256(other).digest())),
                 timestamp=Timestamp.now(), validator_address=addr,
                 validator_index=idx)
        v.signature = node.priv.sign(v.sign_bytes(CHAIN_ID))
        msg = cmsgs.wrap_message(cmsgs.VoteMessage(v))
        for peer in node.reactor.switch.peers.list():
            peer.try_send(creactor.VOTE_CHANNEL, msg)

    def byz_try_add_vote(vote, peer_id):
        try:
            return try_add(vote, peer_id)
        except Exception:                          # noqa: BLE001
            return False        # its own equivocation gossiped back

    cs._sign_add_vote, cs._try_add_vote = byz_sign_add_vote, byz_try_add_vote


def _cs_evidence_run(state, out):
    """Step 3: validator 0 double-signs its prevotes; its
    DuplicateVoteEvidence is committed, every node validates the block
    holding it and marks it committed in its pool, and the chain goes
    CS_EVIDENCE_AFTER heights further.  Cache off, threshold 1."""
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import votestream as vs_mod
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence

    byz = _cs_privs()[0].pub_key().address()
    found = {}

    def evidence(n):
        for h in range(1, n.bstore.height() + 1):
            for ev in n.bstore.load_block(h).evidence:
                if isinstance(ev, DuplicateVoteEvidence) and \
                        ev.vote_a.validator_address == byz:
                    return h, ev
        return None

    with vd.VerifyPipeline(device=DEVICE) as pipe:
        sv = vs_mod.StreamingVerifier(device_threshold=1, pipeline=pipe,
                                      device=DEVICE)
        sv.start()
        net = _CsNet(_cs_privs(), sv)
        honest = net.nodes[1:]
        _cs_byzantine(net.nodes[0])
        try:
            t0 = time.perf_counter()
            net.start()

            def landed():
                for n in honest:
                    if n.name not in found:
                        e = evidence(n)
                        if e is None:
                            return False
                        found[n.name] = e
                return True
            net.wait(landed, "committed duplicate-vote evidence", honest)
            at = max(h for h, _ in found.values())
            seconds = time.perf_counter() - t0
            net.run_past(at + CS_EVIDENCE_AFTER, honest)
        finally:
            net.close()
            sv.stop()
    top = net.same_blocks("equivocation", honest)
    h, ev = found[honest[0].name]
    check(all(e[0] == h and e[1].hash() == ev.hash() for e in found.values()),
          f"equivocation: the nodes committed the evidence at "
          f"{sorted({e[0] for e in found.values()})}")
    check(all(n.evpool._is_committed(ev) for n in honest) and
          top >= h + CS_EVIDENCE_AFTER,
          f"equivocation: evidence committed in {sum(n.evpool._is_committed(ev) for n in honest)} pools, chain at {top}")
    out["equivocation"] = {
        "evidence_height": h, "vote_height": ev.vote_a.height,
        "seconds_to_evidence": seconds, "heights": top,
        "evidence_hash": ev.hash().hex(),
        "pools_marked_committed": len(honest)}
    emit({"consensus_step": "equivocation", "card": state["card"],
          **out["equivocation"]})


def phase_consensus(state, torch):
    """Consensus (consensus/: ConsensusState, ConsensusReactor, the WAL
    and the timeout ticker) committing kvstore blocks among CS_NODES (11)
    live in-process validators on the card, each a full node (_CsNet)
    over the loopback double (_LoopNet), at CometBFT's default timeouts
    (_cs_config):
    1. launch run: the verdict cache off and the vote stream's device
       threshold 1 (every flush a window on the pipeline's consensus
       lane), 2,000 kvstore transactions in node 0's mempool, every node
       past height 20: the same block hashes on every node, each
       transaction committed once, every app hash the transaction count;
       every LastCommit check (8-11 signatures, at DEVICE_THRESHOLD 8 or
       over) one RLC program, every vote window of two votes and more
       one, a window of one vote one K1 + K14, and the K1-K4 and K14
       launches exactly what those programs account for; heights/s,
       per-height p50 / p90, the heights of more than one round, votes
       streamed and verified inline, launches by kernel, devprof's busy
       share, the consensus lane's latency-ledger cuts;
    2. default knobs: the same network with the verdict cache on and
       default_verifier (2 ms, 256): launches and heights/s, in-process
       figures on one shared cache;
    3. equivocation: validator 0 double-signs its prevotes; its
       DuplicateVoteEvidence is committed, every honest node validates
       it and marks it committed, and the chain goes on;
    4. tampered vote (in step 1's network): from height 6, node 1 is
       sent a nil prevote of validator 2 with its signature's first bit
       flipped, at each new height until one lands in a vote window:
       that window is the run's one rejected window, localized by one
       K1 + K14 (in step 1's count), its other votes accepted, and the
       tampered vote is not added;
    5. WAL (step 1's network): node 0 stopped, its WAL holds one
       EndHeightMessage for each height it committed.
    Each step on a line of its own (`consensus_step`) with the card's
    name and power limit."""
    out = {"validators": CS_NODES, "config": "CometBFT default timeouts",
           "card": state["card"]}
    t0 = time.perf_counter()
    rec = _cs_launch_run(state, torch)
    _cs_check_launch_run(state, rec, out)
    _cs_default_run(state, out)
    _cs_evidence_run(state, out)
    launched = {k for k, v in state["consensus_launches"].items() if v}
    check(launched == DEFAULT_KERNELS,
          f"the consensus path launched {sorted(launched)}")
    out["launches"] = {k: v for k, v in state["consensus_launches"].items()
                       if v}
    out["wall_seconds"] = time.perf_counter() - t0
    _zero_counts()
    return out


# -- phase 16: the p2p stack ---------------------------------------------------

P2P_VALIDATORS = 4
P2P_TOP = 8                    # step 1 runs every validator past this height
P2P_TXS = 200                  # kvstore transactions in node 3's mempool
P2P_EVIDENCE_AFTER = 2         # step 3 runs this far past the evidence
P2P_CHANNELS = bytes([0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40])


class _P2PNet(_Nodes):
    """P2P_VALIDATORS port validators and one non-validator joiner, each
    a full node (_cs_node) with a Switch on 127.0.0.1:0
    (MultiplexTransport: SecretConnection, MConnection) carrying its
    consensus, mempool, evidence and blocksync reactors; the joiner
    syncs by block sync before its consensus reactor takes over.  Each
    switch counts its wire bytes by channel (P2PMetrics)."""

    def __init__(self, privs, verifier):
        from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
        from cometbft_tpu_torch.crypto import ed25519 as ed
        from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
        from cometbft_tpu_torch.libs import metrics
        from cometbft_tpu_torch.mempool.reactor import MempoolReactor
        from cometbft_tpu_torch.p2p import NodeInfo, NodeKey, Switch
        from cometbft_tpu_torch.p2p.transport import MultiplexTransport

        genesis = _cs_genesis(privs)
        self.closed = False
        self.nodes = [_cs_node(f"v{i:02d}", genesis, priv, verifier)
                      for i, priv in enumerate(list(privs) + [None])]
        self.validators, self.joiner = self.nodes[:-1], self.nodes[-1]
        for i, n in enumerate(self.nodes):
            sync = n is self.joiner
            n.key = NodeKey(ed.PrivKey.generate(_seed("p2p-node", i)))
            info = NodeInfo(node_id=n.key.id, network=CHAIN_ID,
                            channels=P2P_CHANNELS, moniker=n.name)
            n.sw = Switch(MultiplexTransport(n.key, info),
                          listen_addr="127.0.0.1:0")
            n.sw.metrics = metrics.P2PMetrics(metrics.Registry())
            n.reactor.wait_sync = sync
            n.blocksync = BlocksyncReactor(
                n.cs.state, n.exe, n.bstore, sync,
                consensus_reactor=n.reactor, device=DEVICE)
            n.mempool_reactor = MempoolReactor(n.mempool)
            n.evidence = EvidenceReactor(n.evpool)
            for name, r in (("CONSENSUS", n.reactor),
                            ("MEMPOOL", n.mempool_reactor),
                            ("EVIDENCE", n.evidence),
                            ("BLOCKSYNC", n.blocksync)):
                n.sw.add_reactor(name, r)

    def start(self, nodes=None):
        """Start each node's switch and dial every node started before
        it (a full mesh among `nodes`, the validators by default)."""
        nodes = self.validators if nodes is None else nodes
        for n in nodes:
            n.sw.start()
        for n in nodes:
            for m in self.nodes:
                if m is not n and m.sw.is_running() and \
                        not n.sw.peers.has(m.key.id) and \
                        not m.sw.peers.has(n.key.id):
                    n.sw.dial_peer(f"{m.key.id}@{m.sw.bound_addr}")
        want = {n.key.id: {m.key.id for m in self.nodes
                           if m is not n and m.sw.is_running()}
                for n in self.nodes if n.sw.is_running()}
        self.wait(lambda: all({p.id for p in n.sw.peers.list()} ==
                              want[n.key.id] for n in self.nodes
                              if n.sw.is_running()), "the full mesh",
                  timeout=60)

    def close(self):
        if self.closed:
            return
        self.closed = True
        for n in self.nodes:
            n.sw.stop()
        for n in self.nodes:
            n.bus.stop()


def _p2p_wire(nodes):
    """Bytes sent by channel (P2PMetrics), sealed SecretConnection frames
    sent and the flow-rate monitors' totals, summed over `nodes`."""
    by_ch, frames, sent, recv = {}, 0, 0, 0
    for n in nodes:
        m = n.sw.metrics.message_send_bytes_total
        for key, v in m._values.items():
            by_ch[key[0]] = by_ch.get(key[0], 0) + v
        for p in n.sw.peers.list():
            frames += p.mconn._conn._send_nonce.counter
            st = p.mconn.status()
            sent += st["send"]["bytes"]
            recv += st["recv"]["bytes"]
    return {"bytes_sent_by_channel": by_ch, "frames_sent": frames,
            "flowrate_bytes_sent": sent, "flowrate_bytes_received": recv}


def phase_p2p(state, torch):
    """The p2p stack (p2p/: SecretConnection, MConnection,
    MultiplexTransport, Switch) carrying the port's reactors between
    full nodes over TCP on 127.0.0.1, on the card: four validators and a
    fifth, non-validator node, each a Switch with the consensus,
    mempool, evidence and blocksync reactors over a kvstore app, at
    CometBFT's default timeouts (_cs_config), the verdict cache off, the
    vote stream's device threshold and both batch thresholds 1:
    1. the validators dial a full mesh over SecretConnection; 200
       transactions go into validator 3's mempool only; every validator
       runs past height 8: the same block hashes everywhere, each
       transaction committed once, gossiped by the mempool reactor;
    2. the fifth node starts (past height 8), dials the four and catches
       up by block sync over TCP: its windows on the card, its blocks
       the validators' and its app hash theirs;
    3. validator 0 double-signs its prevotes: its DuplicateVoteEvidence
       reaches the others' pools (the evidence reactor gossips it), is
       committed, and the chain goes 2 heights on.
    The counts are set to 0 before the network starts and read after it
    stopped: every LastCommit check, block-sync window and vote window
    of two votes or more one RLC program (K1-K4), a vote window of one
    one K1 + K14, exactly.  Reported: heights/s, per-height p50, bytes
    and packets sent by channel, sealed frames, handshake ms, launches by
    kernel."""
    import threading

    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.crypto import votestream as vs_mod
    from cometbft_tpu_torch.p2p.conn import connection as connmod
    from cometbft_tpu_torch.p2p.conn import secret_connection as scmod
    from cometbft_tpu_torch.types import validation as val
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence

    privs = [ed.PrivKey.generate(_seed("p2p", i))
             for i in range(P2P_VALIDATORS)]
    cache = ed._A_TABLE_CACHE
    packs = state.setdefault("p2p_packs", {})
    calls, bs_windows, handshakes = [], [], []
    ev_received = []
    real_dv, real_make = cb._device_verify, scmod.SecretConnection.make
    verify, verify_async = val.DeferredSigBatch.verify, \
        val.DeferredSigBatch.verify_async
    thresholds = (cb.DEVICE_THRESHOLD, val.DeferredSigBatch.DEVICE_THRESHOLD)

    inflight = [0]
    lock = threading.Lock()

    def counted_dv(pubkeys, parsed, device, packed=cb._NO_PACK):
        with lock:
            inflight[0] += 1
        try:
            ok, verdicts = real_dv(pubkeys, parsed, device, packed=packed)
            calls.append((len(pubkeys), ok))
            _keep_pack(packs, pubkeys, parsed, packed, ok)
            return ok, verdicts
        finally:
            with lock:
                inflight[0] -= 1

    def quiet():
        """Wait until no program is between its first and last launch
        (a window still on a pipeline once every node has stopped)."""
        deadline = time.monotonic() + 60
        while inflight[0] and time.monotonic() < deadline:
            time.sleep(0.01)
        check(inflight[0] == 0, "p2p: a program still running")

    packets = {}
    real_next = connmod._Channel.next_packet

    def counted_next(self):
        """MConnection packets (<= 1,024 bytes of a message) by channel."""
        out = real_next(self)
        with lock:
            key = "%#x" % self.desc.id
            packets[key] = packets.get(key, 0) + 1
        return out

    def timed_make(sock, priv_key):
        t0 = time.perf_counter()
        conn = real_make(sock, priv_key)
        handshakes.append((time.perf_counter() - t0) * 1e3)
        return conn

    def w_verify(self, device="cuda"):
        bs_windows.append(self.count())
        return verify(self, device=device)

    def w_verify_async(self, pipeline, subsystem="pipeline", lane=None):
        bs_windows.append(self.count())
        return verify_async(self, pipeline, subsystem=subsystem, lane=lane)

    byz = privs[0].pub_key().address()

    def evidence_of(n):
        for h in range(1, n.bstore.height() + 1):
            for ev in n.bstore.load_block(h).evidence:
                if isinstance(ev, DuplicateVoteEvidence) and \
                        ev.vote_a.validator_address == byz:
                    return h, ev
        return None

    out = {"validators": P2P_VALIDATORS, "nodes": P2P_VALIDATORS + 1,
           "config": "CometBFT default timeouts", "card": state["card"]}
    net = None
    with vd.VerifyPipeline(device=DEVICE) as pipe:
        sv = vs_mod.StreamingVerifier(device_threshold=1, pipeline=pipe,
                                      device=DEVICE)
        sv.start()
        try:
            check(sv.warmed.wait(timeout=900) and sv.warm_error is None,
                  f"p2p: the stream's pre-warm: {sv.warm_error!r}")
            cb.DEVICE_THRESHOLD = 1
            val.DeferredSigBatch.DEVICE_THRESHOLD = 1
            cb._device_verify = counted_dv
            connmod._Channel.next_packet = counted_next
            scmod.SecretConnection.make = staticmethod(timed_make)
            val.DeferredSigBatch.verify = w_verify
            val.DeferredSigBatch.verify_async = w_verify_async
            net = _P2PNet(privs, sv)
            vals = net.validators
            for n in net.nodes:
                recv = n.evidence.receive

                def spy(env, n=n, recv=recv):
                    ev_received.append(n.name)
                    return recv(env)
                n.evidence.receive = spy
            got_txs = {n.name: 0 for n in vals}
            for n in vals:
                recv = n.mempool_reactor.receive

                def mspy(env, n=n, recv=recv):
                    from cometbft_tpu_torch.mempool.reactor import decode_txs
                    got_txs[n.name] += len(decode_txs(env.message))
                    return recv(env)
                n.mempool_reactor.receive = mspy
            txs = [b"p2p%04d=v%d" % (i, i % 13) for i in range(P2P_TXS)]
            for tx in txs:
                vals[3].mempool.check_tx(tx)
            commit_at = _cs_timed_commits(vals[0])
            with _persig(torch) as persig, \
                    _kept_windows(pipe) as pipe_windows:
                _zero_counts()
                h0 = cache.hits
                t0 = time.perf_counter()
                net.start()
                mesh_s = time.perf_counter() - t0
                net.run_past(P2P_TOP, vals)
                t1 = time.perf_counter()
                # 2. the joiner
                joiner = net.joiner
                net.start([joiner])
                check(joiner.blocksync.wait_synced(CS_TIMEOUT_S),
                      "p2p: the joiner did not catch up")
                sync_s = time.perf_counter() - t1
                synced_to = joiner.bstore.height()
                windows_synced = list(bs_windows)
                # 3. equivocation
                t2 = time.perf_counter()
                _cs_byzantine(vals[0])
                found = {}

                def landed():
                    for n in vals[1:]:
                        if n.name not in found:
                            e = evidence_of(n)
                            if e is None:
                                return False
                            found[n.name] = e
                    return True
                net.wait(landed, "committed duplicate-vote evidence",
                         vals[1:])
                at = max(h for h, _ in found.values())
                ev_s = time.perf_counter() - t2
                net.run_past(at + P2P_EVIDENCE_AFTER, vals[1:])
                wire = _p2p_wire(net.nodes)
                t_end = time.perf_counter()
                net.close()
                sv.stop()
                for _, h in pipe_windows:
                    h.result(timeout=600)
                quiet()
                got = _counts()
                hits = cache.hits - h0
        finally:
            cb._device_verify = real_dv
            connmod._Channel.next_packet = real_next
            scmod.SecretConnection.make = staticmethod(real_make)
            val.DeferredSigBatch.verify = verify
            val.DeferredSigBatch.verify_async = verify_async
            cb.DEVICE_THRESHOLD, val.DeferredSigBatch.DEVICE_THRESHOLD = \
                thresholds
            if net is not None:
                net.close()
            sv.stop()
    # 1. the same chain, every transaction committed once, gossiped
    top = net.same_blocks("p2p", vals)
    check(top >= P2P_TOP, f"p2p: the validators hold {top} blocks")
    chain_txs = [tx for h in range(1, top + 1)
                 for tx in vals[0].bstore.load_block(h).data.txs]
    check(sorted(chain_txs) == sorted(txs),
          f"p2p: {len(chain_txs)} txs committed, {len(set(chain_txs))} "
          f"distinct, of {P2P_TXS}")
    check(all(got_txs[n.name] > 0 for n in vals[:3]),
          f"p2p: txs received by the mempool reactors {got_txs}")
    want_hash = P2P_TXS.to_bytes(8, "big")
    check(all(n.app.app_hash == want_hash for n in vals),
          f"p2p: app hashes {sorted({n.app.app_hash.hex() for n in vals})}")
    # 2. the joiner's blocks, windows and app hash
    jst = joiner.sstore.load()
    jh = jst.last_block_height
    ref = max(vals[1:], key=lambda n: n.bstore.height())
    want_jh = ref.bstore.load_block(jh + 1).header.app_hash \
        if ref.bstore.height() > jh else ref.cs.state.app_hash \
        if ref.cs.state.last_block_height == jh else None
    # a syncing node stops one block below its peers' height: the block
    # above carries the commit its last block needs
    check(windows_synced and synced_to >= P2P_TOP - 1 and
          joiner.blocksync.error is None,
          f"p2p: the joiner synced to {synced_to} in {len(windows_synced)} "
          f"windows, error {joiner.blocksync.error!r}")
    check(all(joiner.bstore.load_block(h).hash() ==
              ref.bstore.load_block(h).hash()
              for h in range(1, min(joiner.bstore.height(), top) + 1)),
          "p2p: the joiner's blocks differ from the validators'")
    check(jst.app_hash == want_jh,
          f"p2p: the joiner's app hash {jst.app_hash.hex()} at {jh}, the "
          f"validators' {want_jh.hex() if want_jh else None}")
    # 3. the evidence
    h, ev = found[vals[1].name]
    check(all(e[0] == h and e[1].hash() == ev.hash() for e in found.values())
          and all(n.evpool._is_committed(ev) for n in vals[1:]),
          f"p2p: evidence committed at {sorted({e[0] for e in found.values()})}")
    check(ev_received, "p2p: no evidence crossed the evidence reactor")
    check(all(n.evidence.error is None for n in net.nodes),
          f"p2p: evidence reactor errors "
          f"{[repr(n.evidence.error) for n in net.nodes]}")
    # launches: every program the run made, exactly
    n_rlc = sum(1 for n, _ in calls if n >= 2)
    n_persig = sum(1 for n, ok in calls if n == 1 or not ok)
    check(all(ok for n, ok in calls if n >= 2),
          f"p2p: a program rejected: {[c for c in calls if not c[1]]}")
    want = _merge(_rlc_want(hits, n_rlc), *[PERSIG_LAUNCHES] * n_persig)
    _want_launches({k: v for k, v in got.items() if v}, want, "p2p")
    check(persig.calls == n_persig, f"p2p: {persig.calls} localizations, "
          f"not {n_persig}")
    _keep_localized(state, "p2p_persig", pipe_windows, persig.widths, "p2p")
    check(pipe.faults == pipe.host_windows == pipe.staging_fallbacks == 0 and
          sv.device_fallbacks == sv.build_errors == 0 and
          sv.path_flushes["host"] == 0,
          f"p2p: pipeline faults {pipe.faults}, host windows "
          f"{pipe.host_windows}, stream flushes {dict(sv.path_flushes)}")
    state["p2p_launches"] = got
    launched = {k for k, v in got.items() if v}
    check(launched == DEFAULT_KERNELS,
          f"the p2p path launched {sorted(launched)}")
    heights = _cs_heights(net, P2P_TOP, t0, commit_at)
    out.update({
        "mesh_seconds": mesh_s, **heights,
        "handshake_ms": {"count": len(handshakes),
                         "p50": _pct(handshakes, 50),
                         "max": max(handshakes)},
        "txs": P2P_TXS, "txs_received_by_mempool_reactor": got_txs,
        "joiner": {"synced_to": synced_to, "seconds": sync_s,
                   "blocksync_windows": len(windows_synced),
                   "window_signatures": windows_synced},
        "evidence": {"height": h, "vote_height": ev.vote_a.height,
                     "seconds_to_evidence": ev_s,
                     "evidence_messages_received": len(ev_received)},
        "programs": {"rlc": n_rlc, "localizations": n_persig,
                     "blocksync_windows": len(bs_windows)},
        "a_table_hits": hits, "seconds": t_end - t0, **wire,
        "packets_sent_by_channel": dict(packets),
        "launches": {k: v for k, v in got.items() if v}})
    _zero_counts()
    return out


# -- phase 17: the engine configurations -------------------------------------

def phase_engines(state, torch):
    """Each configuration drives the commit, the window and (where
    listed) the batch through the normal entry points, with the counts
    set to 0 just before and read just after; it must launch exactly its
    kernels.  The A-table cache starts empty, so the window's programs
    are the whole one and the cached-A one."""
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.types import validation as val

    commits = [(h, state["commits"][h]) for h in state["heights"]]
    rows = []
    state["engine_launches"] = {}
    for name, flags, needed, with_batch in ENGINES:
        _set_engine(flags)
        try:
            ed._A_TABLE_CACHE = ed.ATableCache()
            _zero_counts()
            t0 = time.perf_counter()
            rec = {"configuration": name, "flags": flags}
            rec["commit_accept_seconds"], rec["commit_reject_seconds"] = \
                _commit_accept_reject(state, val)
            with _Timed(ed, "rlc_verify", torch) as rlc:
                t1 = time.perf_counter()
                n = _run_window(state, val, commits)
                rec["window_seconds"] = time.perf_counter() - t1
                rec["window_sigs_per_s"] = n / rec["window_seconds"]
                rec["window_rlc_verify_seconds"] = rlc.seconds
            (rec["window_reject_seconds"], _, _,
             rec["window_persig_seconds"]) = _window_reject(state, val,
                                                            commits)
            if with_batch:
                rec["batch_seconds"], rec["batch_rlc_verify_seconds"] = \
                    _clean_batch(state, torch)
                rec["batch_sigs_per_s"] = N_BATCH / rec["batch_seconds"]
            rec["seconds"] = time.perf_counter() - t0
            counts = _counts()
        finally:
            _set_engine({})
        launched = {k for k, v in counts.items() if v}
        check(launched == needed, f"{name} launched {sorted(launched)}, "
              f"not {sorted(needed)}: {counts}")
        rec["launches"] = counts
        state["engine_launches"][name] = counts
        rows.append(rec)
    _zero_counts()
    return {"configurations": rows}


# -- phase 18: kernel vs plain -----------------------------------------------

def _hostile_words(state, torch):
    """K1 input at W = 8192: the phase-4 public keys (two of them
    non-canonical) with more hostile lanes: x = 0 with the sign bit,
    u/v not a square, an 8-torsion point, y = 2^255 - 1."""
    from cometbft_tpu_torch import convert
    import numpy as np

    ref = state["ref"]
    pubs = list(state["batch_items"][0])
    bad_y = [y for y in range(2, 64)
             if ref.point_decompress(y.to_bytes(32, "little")) is None]
    pubs[10] = (1 | (1 << 255)).to_bytes(32, "little")
    pubs[11] = bad_y[0].to_bytes(32, "little")
    pubs[12] = bytes.fromhex(
        "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")
    pubs[13] = ((1 << 255) - 1).to_bytes(32, "little")
    words = np.stack([np.frombuffer(p, dtype=np.uint32) for p in pubs], 1)
    return convert.words_from_numpy(words, DEVICE)


def _proj_err(torch, fe, a, b):
    """max |X1 Z2 - X2 Z1| and |Y1 Z2 - Y2 Z1| over frozen limbs."""
    def f(x):
        return fe.freeze(x)
    ex = (f(fe.mul(a[0], b[2])) - f(fe.mul(b[0], a[2]))).abs().max()
    ey = (f(fe.mul(a[1], b[2])) - f(fe.mul(b[1], a[2]))).abs().max()
    return int(max(ex, ey))


def _hostile_digits(torch, mags):
    """mags with magnitudes 17, 31 and -1 in the first and last windows:
    each selects the identity."""
    m = mags.clone()
    bad = torch.tensor([17, 31, -1], dtype=torch.int32, device=m.device)
    m[0, :3] = bad
    m[-1, -3:] = bad
    return m


def _exact(a, b):
    return int((a - b).abs().max())


# K4's partial sets beyond the main path's, (na, nr): 1 + 1, the window's
# and the batch's partial counts, 129, K5's partials of the batch
# (320 + 256) and K6's (2560 + 2048); the torsion case at two of them
# the phases whose RLC packs (state[f"{path}_packs"]) and localized items
# (state[f"{path}_persig"]) the kernels phase holds K1-K4 and K14 to
PATH_PACKS = ("consensus", "lightserve", "p2p")
FOLD_SETS = ((1, 1), (4, 10), (10, 8), (65, 64), (320, 256), (2560, 2048))
FOLD_TORSION = ((10, 8), (320, 256))
TORSION8 = "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"


def _fold_sets(state, torch):
    """K4 inputs made on the card from the seed, for each (na, nr) of
    FOLD_SETS: n - 1 = na + nr - 1 points Q_a + Q_b over a pool of 16
    seeded multiples of B, then minus their sum, so the set sums to the
    identity (expect True); the same set with one limb of one partial
    raised by one (expect False); at FOLD_TORSION also the set with an
    8-torsion point added to its first partial: it sums to that point,
    which the cofactor 8 clears (expect True).  [(label, want, pa, pr)]"""
    import numpy as np

    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.ops import fe

    ref = state["ref"]
    rng = np.random.default_rng(SEED)

    def limbs(pts):
        arr = np.stack([np.stack([fe.int_to_limbs(p[c]) for p in pts], 1)
                        for c in range(4)])
        return torch.from_numpy(arr.astype(np.int32)).to(DEVICE)

    pool = limbs([ref.point_mul(int(k), ref.B)
                  for k in rng.integers(1, 1 << 62, 16)])
    t8 = limbs([ref.point_decompress(bytes.fromhex(TORSION8))])
    out = []
    for na, nr in FOLD_SETS:
        n = na + nr
        a, b = (torch.from_numpy(rng.integers(0, 16, n - 1)).to(DEVICE)
                for _ in range(2))
        pts = dev.point_add(pool[..., a], pool[..., b])
        full = torch.cat([pts, dev.point_neg(dev._tree_reduce(pts, 1))], -1)
        bad = full.clone()
        bad[n % 4, 7, n // 2] += 1
        sets = [("identity", True, full), ("one limb changed", False, bad)]
        if (na, nr) in FOLD_TORSION:
            tor = full.clone()
            tor[..., :1] = dev.point_add(full[..., :1], t8)
            sets.append(("8-torsion", True, tor))
        out += [(f"{label} {na} + {nr}", want, s[..., :na].contiguous(),
                 s[..., na:].contiguous()) for label, want, s in sets]
    return out


# K6's and K7's blocks beyond loop_blk's on the batch's 10,240- and
# 8,192-lane sides: 8 and 16 rows per output lane
LOOP_WIDE_BLKS = [1024, 2048]

# the sides at which K1 is compared and timed: the main path's widths
# 128, 5120, 10240 and 8192 (K2 is, at every side)
K1_SIDES = {("commit", "A"), ("window", "R"), ("batch", "A"), ("batch", "R")}


def phase_kernels(state, torch):
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.ops import fe

    saved = _counts()
    cases = {}
    k1, k2 = [], []

    def k1_case(phase, words):
        pk, okk = cd.decompress(words)
        pp, okp = cd.decompress_plain(words)
        err = int((pk - pp).abs().max()) + int((okk != okp).sum())
        check(err == 0, f"K1 {phase} {tuple(words.shape)} differs from plain "
              f"by {err}")
        k1.append({"shape": [8, int(words.shape[-1])], "max_abs_err": err,
                   "args": (words,), "phase": phase})
        return pk, okk

    def k2_case(phase, pt):
        e2 = _exact(cm.table17_neg(pt), cm.table17_neg_plain(pt))
        check(e2 == 0, f"K2 {phase} {tuple(pt.shape)} differs by {e2}")
        k2.append({"shape": [4, 20, int(pt.shape[-1])], "max_abs_err": e2,
                   "args": (pt,), "phase": phase})

    words = _hostile_words(state, torch)
    _, okk = k1_case("hostile", words)
    check(not bool(okk[10]) and not bool(okk[11]) and bool(okk[12]),
          "hostile lanes decoded wrongly")
    # ragged widths: a part of a warp, a part of a block, one lane past a
    # block; the first two hold the hostile lanes 10-13
    for lo, hi in ((10, 11), (10, 17), (0, 129)):
        pt, _ = k1_case("ragged", words[:, lo:hi].contiguous())
        k2_case("ragged", pt)

    shapes = {}
    for label, packed in (("window", state["window_packed"]),
                          ("batch", state["batch_packed"]),
                          ("commit", state["commit_packed"])):
        t = convert.packed_from_numpy(packed, DEVICE)
        shapes[label] = t
    k3, k5, k6, k7 = [], [], [], []

    def k3_case(phase, tab, mg, negs):
        part = cm.msm_window_major(tab, mg, negs, group=1)
        e3 = _exact(part, cm.msm_window_major_plain(tab, mg, negs))
        check(e3 == 0, f"K3 {phase} {tuple(mg.shape)} differs by {e3}")
        k3.append({"shape": [int(d) for d in mg.shape], "max_abs_err": e3,
                   "args": (tab, mg, negs), "phase": phase, "partials": part})
        return part

    for label, t in shapes.items():
        for side, (w, mags, negs) in (("A", (t[0], t[2], t[3])),
                                      ("R", (t[1], t[4], t[5]))):
            if (label, side) in K1_SIDES:
                pt, _ = k1_case(f"{label} {side}", w)
            else:
                pt, _ = cd.decompress(w)
            k2_case(f"{label} {side}", pt)
            tab = cm.table17_neg(pt)
            if label == "commit":          # K3 alone at the commit's sides
                k3_case(label, tab, mags, negs)
                if side == "A":            # the Horner chain alone
                    k3_case("chain only", tab[..., :32].contiguous(),
                            mags[:, :32].contiguous(),
                            negs[:, :32].contiguous())
                continue
            nwin, width = (int(d) for d in mags.shape)
            digit_sets = [(label, mags)]
            if label == "window" and side == "R":
                digit_sets.append(("digits outside 0..16",
                                   _hostile_digits(torch, mags)))
            for phase, mg in digit_sets:
                part = k3_case(phase, tab, mg, negs)
                for requested in (4, 13):
                    g = cm.group_for(nwin, requested)
                    p5 = cm.msm_window_major_grouped(tab, mg, negs, g)
                    e5 = _exact(p5, cm.msm_window_major_grouped_plain(
                        tab, mg, negs, g))
                    vs_k3 = _proj_err(torch, fe, dev._tree_reduce(p5, 1),
                                      dev._tree_reduce(part, 1))
                    check(e5 == 0 and vs_k3 == 0, f"K5 {phase}/{side} G {g} "
                          f"differs from plain by {e5}, its sum from K3's "
                          f"by {vs_k3}")
                    k5.append({"shape": [nwin, width], "group": g,
                               "max_abs_err": e5, "vs_k3": vs_k3,
                               "args": (tab, mg, negs, g), "phase": phase})
                blks = [cm.loop_blk(width)]
                if phase == "batch":
                    blks += LOOP_WIDE_BLKS
                for blk in blks:
                    p6 = cm.msm_window_loop(tab, mg, negs, blk)
                    e6 = _exact(p6, cm.msm_window_loop_plain(tab, mg, negs,
                                                             blk))
                    sum_err = _proj_err(torch, fe, dev._tree_reduce(p6, 1),
                                        dev._tree_reduce(part, 1))
                    check(e6 == 0 and sum_err == 0, f"K6 {phase}/{side} blk "
                          f"{blk} differs from plain by {e6}; its sum from "
                          f"K3's by {sum_err}")
                    k6.append({"shape": [nwin, width], "blk": blk,
                               "max_abs_err": e6, "vs_k3": sum_err,
                               "args": (tab, mg, negs, blk), "phase": phase})
                    for j in (0, nwin - 1):
                        p7 = cm.select_tree(tab, mg[j], negs[j], blk)
                        e7 = _exact(p7, cm.select_tree_plain(
                            tab, mg[j], negs[j], blk))
                        check(e7 == 0, f"K7 {phase}/{side} blk {blk} row {j} "
                              f"differs by {e7}")
                        k7.append({"shape": [width], "row": j, "blk": blk,
                                   "max_abs_err": e7,
                                   "args": (tab, mg[j], negs[j], blk),
                                   "phase": phase})
    # phase 8's sr25519 packs at the shapes the ed25519 packs above do not
    # have: K1-K3 on both sides, K4 on their partials
    held = {(int(t[0].shape[-1]), int(t[1].shape[-1])) for t in shapes.values()}
    sr_folds = []
    for (kind, width), (packed, items) in sorted(state["sr_packs"].items()):
        if kind != "rlc" or (packed[0].shape[-1], width) in held:
            continue
        label = f"sr25519 N = {width}"
        t = convert.packed_from_numpy(packed, DEVICE)
        parts = []
        for side, (w, mags, negs) in (("A", (t[0], t[2], t[3])),
                                      ("R", (t[1], t[4], t[5]))):
            pt, _ = k1_case(f"{label} {side}", w)
            k2_case(f"{label} {side}", pt)
            parts.append(k3_case(f"{label} {side}", cm.table17_neg(pt),
                                 mags, negs))
        sr_folds.append((label, all(_sr_oracle(state, tuple(zip(*items)))),
                         *parts))
    # the RLC programs of the consensus, lightserve and p2p phases
    # (LastCommit checks, vote, serving and block-sync windows, sampled
    # client-side commits) at the (A, R) widths the packs above do not
    # have: K1-K3 on both sides, K4 on their partials (each pack's
    # program accepted)
    cs_folds = []
    for path, (wa, wr), packed in sorted(
            (path, key, p) for path in PATH_PACKS
            for key, p in state.get(f"{path}_packs", {}).items()):
        if (wa, wr) in held:
            continue
        held.add((wa, wr))
        label = f"{path} A {wa}, R {wr}"
        t = convert.packed_from_numpy(packed, DEVICE)
        parts = []
        for side, (w, mags, negs) in (("A", (t[0], t[2], t[3])),
                                      ("R", (t[1], t[4], t[5]))):
            pt, _ = k1_case(f"{label} {side}", w)
            k2_case(f"{label} {side}", pt)
            parts.append(k3_case(f"{label} {side}", cm.table17_neg(pt),
                                 mags, negs))
        cs_folds.append((label, True, *parts))
    cases["ed25519_decompress"] = k1
    cases["ed25519_table17_neg"] = k2
    cases["ed25519_msm_window_major"] = k3
    cases["ed25519_msm_window_major_grouped"] = k5
    cases["ed25519_msm_window_loop"] = k6
    cases["ed25519_select_tree"] = k7
    k4 = []

    def k4_case(label, want, pa, pr):
        got = cm.fold_verify(pa, pr)
        plain = cm.fold_verify_plain(pa, pr)
        check(bool(got) is want and bool(plain) is want,
              f"K4 {label}: kernel {bool(got)}, plain {bool(plain)}")
        k4.append({"shape": [int(pa.shape[-1]), int(pr.shape[-1])],
                   "max_abs_err": 0, "args": (pa, pr), "phase": label})

    bad = convert.packed_from_numpy(state["window_packed_bad"], DEVICE)
    bad_pa, bad_pr = (cm.msm_window_major(cm.table17_neg(cd.decompress(w)[0]),
                                          m, n, group=1)
                      for w, m, n in ((bad[0], bad[2], bad[3]),
                                      (bad[1], bad[4], bad[5])))
    main_k3 = [c for c in k3 if c["phase"] in ("window", "batch")]
    for label, want, pa, pr in (
            ("batch accept", True, main_k3[2]["partials"],
             main_k3[3]["partials"]),
            ("window accept", True, main_k3[0]["partials"],
             main_k3[1]["partials"]),
            ("window reject", False, bad_pa, bad_pr)):
        k4_case(label, want, pa, pr)
    for label, want, pa, pr in sr_folds + cs_folds + _fold_sets(state,
                                                                torch):
        k4_case(label, want, pa, pr)
    cases["ed25519_fold_verify"] = k4
    cases["sha512_blocks"], cases["sha256_blocks"] = _sha_cases(state, torch)
    cases.update(_secp_cases(state, torch))
    cases["ed25519_verify_ladder"] = _persig_cases(state, torch)
    for name, fn in _kernels().items():  # comparison launches do not count
        fn.launches = saved[name]
    state["cases"] = cases
    keep = ("shape", "max_abs_err", "group", "vs_k3", "blk", "row",
            "rejected")
    return {"tolerance": "exact: integer limbs, frozen and projective",
            "compared": {k: [{"phase": c.get("phase", "batch"),
                              **{f: c[f] for f in keep if f in c}}
                             for c in v] for k, v in cases.items()}}


# R||A||M lengths at SHA-512's padding boundaries and message lengths at
# SHA-256's, 16 messages each, with 16 rows of block count 0
SHA512_BOUNDARIES = (111, 112, 127, 128, 239, 240)
SHA256_BOUNDARIES = (55, 56, 63, 64)


def _sha_case(torch, name, label, msgs, arrays):
    """Kernel K9 or K10 against its plain version word for word, and
    against hashlib: rows 0..len(msgs)-1 hash msgs, the rows past them
    and every row of block count 0 give the initial state."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.ops import sha2

    *blocks, nb = arrays
    args = tuple(convert.words_from_numpy(b, DEVICE) for b in blocks) + \
        (torch.from_numpy(np.ascontiguousarray(nb)).to(DEVICE),)
    fn = getattr(sha2, name)
    got, plain = fn(*args), getattr(sha2, name + "_plain")(*args)
    if name == "sha256_blocks":
        got, plain = (got,), (plain,)
        digest, init = sha2.digest256_to_bytes, [sha2.H256]
        lib = hashlib.sha256
    else:
        digest, lib = sha2.digest512_to_bytes, hashlib.sha512
        init = [[v >> 32 for v in sha2.H512],
                [v & sha2.M32 for v in sha2.H512]]
    err = max(int((g.long() - p.long()).abs().max()) for g, p in
              zip(got, plain))
    rows = [x.cpu().numpy() for x in got]
    want_init = digest(*init)
    bad = [i for i in range(len(nb)) if digest(*(r[i] for r in rows)) !=
           (lib(msgs[i]).digest() if i < len(msgs) and nb[i] else want_init)]
    check(err == 0 and not bad, f"{name} {label} {tuple(blocks[0].shape)}: "
          f"differs from plain by {err}, from hashlib at {bad[:8]}")
    return {"shape": [int(d) for d in blocks[0].shape], "max_abs_err": err,
            "args": args, "phase": label, "msgs": msgs,
            "zero_rows": int((nb == 0).sum())}


def _sha_length(rng, count, block_bytes):
    """A seeded message length that pads to exactly max(count, 1)
    blocks of block_bytes."""
    lenbytes = 16 if block_bytes == 128 else 8
    count = max(count, 1)
    return rng.randrange(max(0, (count - 1) * block_bytes - lenbytes),
                         count * block_bytes - lenbytes)


def _sha_groups(rng, name, nblk):
    """The warp-pair cases of K9 (nblk = 3) or K10 (nblk = 1): the chain
    (32 messages of nblk blocks: one pair, the design's floor for one
    message), 33 messages of 1..nblk blocks (a second pair with one live
    lane), one message, and one group of 32 whose counts run 0..B (B =
    nblk, or 2 for K10), each lane's message exactly its count long.
    [(label, msgs, arrays)]."""
    import numpy as np

    from cometbft_tpu_torch.ops import sha2

    bb = 128 if name == "sha512_blocks" else 64
    pad = sha2.pad_sha512 if name == "sha512_blocks" else sha2.pad_sha256
    out = []
    for label, counts in (("chain", [nblk] * 32),
                          ("ragged 33", [rng.randint(1, nblk)
                                         for _ in range(33)]),
                          ("one message", [nblk])):
        msgs = [rng.randbytes(_sha_length(rng, c, bb)) for c in counts]
        out.append((label, msgs, pad(msgs, nblk)))
    bucket = max(nblk, 2)
    counts = np.array([lane % (bucket + 1) for lane in range(32)],
                      dtype=np.int32)
    msgs = [rng.randbytes(_sha_length(rng, int(c), bb)) for c in counts]
    arrays = list(pad(msgs, bucket))
    arrays[-1] = np.where(counts == 0, 0, arrays[-1]).astype(np.int32)
    out.append((f"counts 0..{bucket}", msgs, arrays))
    return out


def _sha_cases(state, torch):
    """K9 at the hash phase's widths and at the padding boundaries, K10
    at the validator leaves and at its padding boundaries; both at the
    warp-pair cases of _sha_groups."""
    import random

    from cometbft_tpu_torch.ops import sha2

    k9 = []
    for label, arrays, msgs in state["k9_inputs"]:
        k9.append(_sha_case(torch, "sha512_blocks", label, msgs, arrays))
    rng = random.Random(SEED)
    out = {}
    for name, sizes, bucket in (("sha512_blocks", SHA512_BOUNDARIES, 3),
                                ("sha256_blocks", SHA256_BOUNDARIES, 2)):
        msgs = [rng.randbytes(s) for s in sizes for _ in range(16)]
        pad = sha2.pad_sha512 if name == "sha512_blocks" else sha2.pad_sha256
        arrays = list(pad(msgs + [rng.randbytes(20)] * 16, bucket))
        arrays[-1] = arrays[-1].copy()
        arrays[-1][len(msgs):] = 0
        arrays[-1][::9] = 0
        out[name] = _sha_case(torch, name, "padding boundaries", msgs, arrays)
    k9.append(out["sha512_blocks"])
    leaves = [b"\x00" + x for x in state["valset_leaves"]]
    k10 = [_sha_case(torch, "sha256_blocks", "validator leaves", leaves,
                     sha2.pad_sha256(leaves)), out["sha256_blocks"]]
    for name, nblk, into in (("sha512_blocks", 3, k9),
                             ("sha256_blocks", 1, k10)):
        for label, msgs, arrays in _sha_groups(rng, name, nblk):
            into.append(_sha_case(torch, name, label, msgs, arrays))
    return k9, k10


# K14's edge lanes: two buckets of 16
PERSIG_EDGE_WIDTH = 16
ALL_15 = (1 << 256) - 1              # every nibble 15


def _persig_edges(ref):
    """K14's edge lanes, 32 of them: [(label, A encoding, R encoding, s,
    h, (pubkey, msg, sig) or None)], made from the seed with `ref` (an
    ed25519_ref module).  A signature lane has h = SHA512(R||A||M) mod L
    and its triple; a lane with a triple of None takes any 256-bit s and
    h (limbs only: all nibbles 0, all 15).  Lanes: a valid signature; A,
    R, and both that fail to decompress; the identity key as y = 1 and as
    the non-canonical y = p + 1 (R = sB); R with an 8-torsion component
    (valid only under the cofactored equation); each of the 8 small-order
    points as A (R = sB) and as R (s = h a); s = L - 1 (valid, and
    tampered); s = h = 0; s = h = all 15s; h = all 15s; the
    non-canonical key y = p + 3; a second key's valid signature."""
    L, B = ref.L, ref.B

    def scalar(*parts):
        return int.from_bytes(_seed("persig", *parts), "little") % L

    def enc(pt):
        return ref.point_compress(pt)

    def h_of(r_enc, a_enc, msg):
        return int.from_bytes(hashlib.sha512(r_enc + a_enc + msg).digest(),
                              "little") % L

    def minus(p, q):
        return ref.point_add(p, ref.point_neg(q))

    lanes = []

    def sig_lane(label, a_enc, r_enc, s, msg):
        sig = r_enc + s.to_bytes(32, "little")
        lanes.append((label, a_enc, r_enc, s, h_of(r_enc, a_enc, msg),
                      (a_enc, msg, sig)))

    def limb_lane(label, a_enc, s, h, r_enc=None):
        a_pt = ref.point_decompress(a_enc)
        if r_enc is None:                   # R = sB - hA: valid
            r_enc = enc(minus(ref.point_mul(s, B), ref.point_mul(h, a_pt)))
        lanes.append((label, a_enc, r_enc, s, h, None))

    seed = _seed("persig key")
    a = ref._clamp(hashlib.sha512(seed).digest()[:32])
    pk = ref.pubkey_from_seed(seed)
    msg = b"persig edge"
    sig0 = ref.sign(seed, msg)
    r0, s0 = sig0[:32], int.from_bytes(sig0[32:], "little")
    bad_y = [y.to_bytes(32, "little") for y in range(2, 64)
             if ref.point_decompress(y.to_bytes(32, "little")) is None]
    t8 = ref.point_decompress(bytes.fromhex(TORSION8))
    ident = (1).to_bytes(32, "little")
    ident_nc = (ref.P + 1).to_bytes(32, "little")
    sig_lane("valid", pk, r0, s0, msg)
    sig_lane("A fails to decompress", bad_y[0], r0, s0, msg)
    sig_lane("R fails to decompress", pk, bad_y[1], s0, msg)
    s = scalar("identity")
    for label, key in (("identity key y = 1", ident),
                       ("identity key y = p + 1", ident_nc)):
        sig_lane(label, key, enc(ref.point_mul(s, B)), s, msg)
    r = scalar("torsion")
    r_enc = enc(ref.point_add(ref.point_mul(r, B), t8))
    sig_lane("torsion in R", pk, r_enc,
             (r + h_of(r_enc, pk, msg) * a) % L, msg)
    for k in range(8):
        small = enc(ref.point_mul(k, t8))
        s = scalar("small A", k)
        sig_lane(f"small-order A {k}", small, enc(ref.point_mul(s, B)), s,
                 msg)
    for k in range(8):
        small = enc(ref.point_mul(k, t8))
        sig_lane(f"small-order R {k}", pk, small,
                 h_of(small, pk, msg) * a % L, msg)
    sig_lane("s = L - 1", ident_nc, enc(ref.point_mul(L - 1, B)), L - 1, msg)
    sig_lane("s = L - 1, tampered", pk, r0, L - 1, msg)
    limb_lane("s = h = 0, R small-order", pk, 0, 0, enc(t8))
    limb_lane("s = h = 0, R = B", pk, 0, 0, enc(B))
    limb_lane("all nibbles 15", pk, ALL_15, ALL_15)
    limb_lane("all nibbles 15, R = B", pk, ALL_15, ALL_15, enc(B))
    limb_lane("h nibbles all 15", pk, scalar("h15"), ALL_15)
    limb_lane("A and R fail to decompress", bad_y[0], scalar("s"),
              scalar("h"), bad_y[1])
    limb_lane("key y = p + 3", (ref.P + 3).to_bytes(32, "little"),
              scalar("p3 s"), scalar("p3 h"))
    seed2 = _seed("persig key 2")
    sig2 = ref.sign(seed2, msg + b"2")
    sig_lane("second key valid", ref.pubkey_from_seed(seed2), sig2[:32],
             int.from_bytes(sig2[32:], "little"), msg + b"2")
    return lanes


def _persig_arrays(lanes):
    """The lanes as pack_batch's (a_words (8, N), r_words (8, N), s_limbs
    (16, N), h_limbs (16, N)) numpy arrays."""
    import numpy as np

    def words(encs):
        return np.ascontiguousarray(np.stack(
            [np.frombuffer(e, dtype=np.uint32) for e in encs], 1))

    def limbs(vals):
        return np.array([[(v >> (16 * j)) & 0xFFFF for j in range(16)]
                         for v in vals], dtype=np.uint32).T.copy()

    return (words([ln[1] for ln in lanes]), words([ln[2] for ln in lanes]),
            limbs([ln[3] for ln in lanes]), limbs([ln[4] for ln in lanes]))


def _persig_oracle(ref, lanes):
    """Each lane's verdict by `ref`'s group law: A and R decompress
    (ZIP-215) and [8](sB - hA - R) is the identity."""
    out = []
    for _, a_enc, r_enc, s, h, _ in lanes:
        a_pt, r_pt = ref.point_decompress(a_enc), ref.point_decompress(r_enc)
        out.append(a_pt is not None and r_pt is not None and ref.point_eq(
            ref.point_mul(8 * s, ref.B),
            ref.point_add(ref.point_mul(8, r_pt), ref.point_mul(8 * h, a_pt))))
    return out


def _persig_wide(state):
    """K14's wide case: WIDE_LANES (16,384) real signatures (the batch's 8,192 and the
    window's 4,848, tiled), a third corrupted: s + 1 mod L (lanes 12k +
    5), R taken from the next lane's signature (12k + 6), the key of the
    next lane (12k + 9), and one nibble of h raised by one mod 16 in the
    pack (12k + 8, nibble i % 64).  Returns (pack_batch's four arrays,
    the verdicts they must give: ed25519_ref.verify's, and a reject where
    a nibble changed)."""
    from cometbft_tpu_torch.crypto import ed25519 as ed

    ref, n = state["ref"], WIDE_LANES
    window = _window_items(state, [(h, state["commits"][h])
                                   for h in state["heights"]])
    base = [list(x) + list(y) for x, y in zip(state["batch"], window)]
    pubs, msgs, sigs = ([x[i % len(x)] for i in range(n)] for x in base)
    for i in range(n):
        j = (i + 1) % n
        if i % 12 == 5:
            s = (int.from_bytes(sigs[i][32:], "little") + 1) % ref.L
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif i % 12 == 6:
            sigs[i] = sigs[j][:32] + sigs[i][32:]
        elif i % 12 == 9:
            pubs[i] = pubs[j]
    want = _oracle(state, (pubs, msgs, sigs))
    a, r, s, h, valid = ed.pack_batch(pubs, msgs, sigs, n)
    h = h.copy()
    for i in range(8, n, 12):
        w = i % 64
        limb, shift = h[w // 4, i], 4 * (w % 4)
        nib = ((int(limb) >> shift) + 1) & 15
        h[w // 4, i] = (int(limb) & ~(15 << shift)) | (nib << shift)
        want[i] = False
    check(all(valid) and sum(want) > n // 2 and not any(
        want[i] for i in range(n) if i % 12 in (5, 6, 8, 9)),
        "K14 wide pack oracle")
    return (a, r, s, h), want


def _frozen25519(t):
    """ops/fe.freeze along the limb axis (second to last)."""
    from cometbft_tpu_torch.ops import fe

    return fe.freeze(t.movedim(-2, 0)).movedim(0, -2)


def _persig_cases(state, torch):
    """K14 against its plain version on the card, verdict for verdict and
    accumulator for accumulator (its optional output, K14's frozen
    digits against the plain version's accumulators frozen, coordinate
    for coordinate), on K1's output of each pack: the tampered commit's
    and the bad window's and the hostile batch's at their buckets (256,
    16,384, 16,384) and at their live widths (101, 4,848, 8,192: the main
    path's since K14 launches over the live lanes), the edge lanes (two
    buckets of 16)
    and the wide corrupted pack (and its first 4,096 lanes), and each
    live width the consensus, lightserve and p2p phases localized at;
    every verdict also against ed25519_ref (the edge lanes: its group
    law)."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import ed25519 as ed
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_persig as cp
    from cometbft_tpu_torch.ops import ed25519 as dev

    ref = state["ref"]

    def packed(items, live=False):
        n = len(items[0])
        a, r, s, h, valid = ed.pack_batch(
            *items, n if live else dev.bucket_size(n))
        want = [bool(v) and w for v, w in
                zip(valid, _oracle(state, items) + [False] * len(valid))]
        return (a, r, s, h), want

    commit, _ = _with_sig(state["commits"][5][1], N_VALS // 4, 11, 0x40)
    commit_items = _window_items(state, [(5, (state["commits"][5][0],
                                              commit))])
    window_items = _window_items(state, state["window_bad"][0])
    lanes = _persig_edges(ref)
    edges = _persig_arrays(lanes)
    edge_want = _persig_oracle(ref, lanes)
    check(all(ref.verify(*ln[5]) == w for ln, w in zip(lanes, edge_want)
              if ln[5] is not None), "K14 edge oracle")
    wide, wide_want = _persig_wide(state)
    runs = [("commit, tampered", *packed(commit_items)),
            ("commit, tampered, live", *packed(commit_items, live=True)),
            ("window, bad height", *packed(window_items)),
            ("window, bad height, live", *packed(window_items, live=True)),
            ("batch, hostile", *packed(state["batch_items"])),
            ("batch, hostile, live", *packed(state["batch_items"],
                                             live=True))]
    for b in range(2):
        sl = slice(b * PERSIG_EDGE_WIDTH, (b + 1) * PERSIG_EDGE_WIDTH)
        runs.append((f"edges {b + 1}",
                     tuple(np.ascontiguousarray(x[:, sl]) for x in edges),
                     edge_want[sl]))
    quarter = WIDE_LANES // 4
    runs.append((f"wide, corrupted, first {quarter}",
                 tuple(np.ascontiguousarray(x[:, :quarter]) for x in wide),
                 wide_want[:quarter]))
    runs.append(("wide, corrupted", wide, wide_want))
    held = {int(arrays[2].shape[-1]) for _, arrays, _ in runs}
    for (kind, width), (packed_sr, items) in sorted(
            state["sr_packs"].items()):
        # phase 8's localizations at the widths the runs above do not have
        if kind == "persig" and width not in held:
            *arrays, valid = packed_sr
            runs.append((f"sr25519, live {width}", tuple(arrays), [
                bool(v) and w for v, w in
                zip(valid, _sr_oracle(state, tuple(zip(*items))))]))
    for path in PATH_PACKS:
        # the localizations of the consensus, lightserve and p2p phases
        # (windows of one vote, the tampered vote's window, each window
        # that held the forged commit) at the live widths the runs lack
        for width, items in sorted(state.get(f"{path}_persig", {}).items()):
            if width not in held:
                held.add(width)
                runs.append((f"{path}, live {width}",
                             *packed(items, live=True)))
    out = []
    for label, arrays, want in runs:
        aw, rw, st, ht = convert.batch_from_numpy(*arrays, DEVICE)
        pts, oks = cd.decompress(torch.cat([aw, rw], dim=-1))
        got, acc = cp.verify_ladder(pts, oks, st, ht, return_acc=True)
        plain, pacc = cp.verify_ladder_plain(pts, oks, st, ht,
                                             return_acc=True)
        err = max(int((got != plain).sum()), _exact(acc, _frozen25519(pacc)))
        verdicts = got.cpu().tolist()
        differ = [i for i, w in enumerate(want) if verdicts[i] != w]
        check(err == 0 and not differ, f"K14 {label}: differs from plain "
              f"by {err}, from ed25519_ref at {differ[:8]}")
        out.append({"shape": [int(st.shape[-1])], "max_abs_err": err,
                    "args": (pts, oks, st, ht), "phase": label,
                    "rejected": len(want) - sum(want)})
    return out


def _secp_window_items(state, commits):
    """The secp window's (pubkeys, msgs, sigs) as DeferredSigBatch
    collects them."""
    return _window_items(state, commits, state["secp"]["vals"])


def _nibbles_msb(v: int):
    return [(v >> (4 * (63 - j))) & 0xF for j in range(64)]


def _ladder_edges(torch):
    """K13 inputs at the hostile edges of its exact additions, 16 lanes,
    and the verdict each must give (None: held against the plain version
    only).  Lane 0: Q = G, u1 = u2, so the first nonzero window adds
    k G + k G (the doubling branch); lane 1: Q = -G, u1 = u2 (P + (-P),
    the cancelling branch, every window); lane 2: u1 = u2 = 0 (both at
    infinity throughout); lane 3: u1 = 0 (infinity + Q entries); lane 4:
    u2 = 0; lane 5: nibbles outside 0..15 (row 0 taken); lane 6: Q = G,
    u1 + u2 = n (the sum at infinity); lane 7: x in the r + n slot; lanes
    8-15 generic."""
    import random

    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.ops import fe_secp as fs

    rng = random.Random(SEED)
    g = (sk.GX, sk.GY)
    key = sk._jaffine(sk._jmul(rng.randrange(1, sk.N), sk._G))
    lanes = []
    for lane in range(16):
        k = rng.randrange(1, sk.N)
        q, u1, u2 = key, k, rng.randrange(1, sk.N)
        if lane == 0:
            q, u2 = g, k
        elif lane == 1:
            q, u2 = (sk.GX, sk.P - sk.GY), k
        elif lane == 2:
            u1 = u2 = 0
        elif lane == 3:
            u1 = 0
        elif lane == 4:
            u2 = 0
        elif lane == 6:
            q, u2 = g, sk.N - k
        lanes.append((q, u1, u2))
    qx = np.zeros((16, fs.NLIMBS), np.int32)
    qy = np.zeros_like(qx)
    u1n = np.zeros((16, 64), np.int32)
    u2n = np.zeros_like(u1n)
    r_l = np.zeros_like(qx)
    rn_l = np.zeros_like(qx)
    rn_ok = np.zeros(16, bool)
    want = []
    for i, (q, u1, u2) in enumerate(lanes):
        qx[i], qy[i] = fs.int_to_limbs(q[0]), fs.int_to_limbs(q[1])
        u1n[i], u2n[i] = _nibbles_msb(u1), _nibbles_msb(u2)
        pt = sk._jaffine(sk._jadd(sk._jmul(u1, sk._G),
                                  sk._jmul(u2, q + (1,))))
        x = 1 if pt is None else pt[0]
        r_l[i] = fs.int_to_limbs(x)
        if i == 7:
            r_l[i], rn_l[i], rn_ok[i] = fs.int_to_limbs(x + 1), \
                fs.int_to_limbs(x), True
        want.append(pt is not None)
    u1n[5] = [rng.choice((-3, -1, 16, 19, rng.randrange(16)))
              for _ in range(64)]
    want[5] = None
    check(want[:8] == [True, False, False, True, True, None, False, True],
          f"ladder edge oracle {want[:8]}")
    args = convert.secp_batch_from_numpy(
        tuple(np.ascontiguousarray(a.T) for a in (qx, qy, u1n, u2n, r_l,
                                                   rn_l)) + (rn_ok,), DEVICE)
    return args, want


def _r_in_rn_slot(pk, want):
    """A copy of a pack_msm_batch dict whose first four lanes carry a
    wrong r (r + 1) and the true r in the r + n slot, rn_valid set on
    lanes 0 and 2 alone: X == (r+n) Z^2 must accept lanes 0 and 2 and
    reject lanes 1 and 3.  Returns (pack, the verdicts it must give)."""
    from cometbft_tpu_torch.ops import fe_secp as fs

    pk = dict(pk, r_limbs=pk["r_limbs"].copy(),
              rn_limbs=pk["rn_limbs"].copy(), rn_valid=pk["rn_valid"].copy())
    want = list(want)
    check(all(want[:4]), "the r + n lanes must start from valid signatures")
    for lane in range(4):
        r = fs.limbs_to_int(pk["r_limbs"][:, lane])
        pk["rn_limbs"][:, lane] = fs.int_to_limbs(r)
        pk["r_limbs"][:, lane] = fs.int_to_limbs(r + 1)
        pk["rn_valid"][lane] = want[lane] = lane % 2 == 0
    return pk, want


def _frozen(t):
    """ops/fe_secp.freeze along the limb axis (second to last)."""
    from cometbft_tpu_torch.ops import fe_secp as fs

    return fs.freeze(t.movedim(-2, 0)).movedim(0, -2)


def _wide_pack(state):
    """K12's wide case: a pack of WIDE_LANES signatures, lane i signed by
    key i % WIDE_KEYS (seeded), a third of the lanes corrupted: s + 1
    (lanes 12k + 5), r + 1 (12k + 6), one digit of the pack (12k + 8: a Q
    window's sign, or a G window's row), the key slot (12k + 9: moved to
    the next slot, the signature then held against that key); lanes 0-3
    with r in the r + n slot (_r_in_rn_slot).  Returns (pack, the verdicts
    it must give: _verify_py's, and a reject where a digit changed, then
    K11's tables of its keys)."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.ops import cuda_secp as cs
    from cometbft_tpu_torch.ops import fe_secp as fs

    pool = state["pool"]
    seeds = [_seed("secp wide key", k) for k in range(WIDE_KEYS)]
    keys = _pool_map(pool, _secp_pubkeys, seeds)
    msgs = [b"secp wide %d" % i for i in range(WIDE_LANES)]
    sigs = _pool_map(pool, _secp_sign, [(seeds[i % WIDE_KEYS], m)
                                        for i, m in enumerate(msgs)])
    pubs = [keys[i % WIDE_KEYS] for i in range(WIDE_LANES)]
    for i in range(WIDE_LANES):
        r, s_ = int.from_bytes(sigs[i][:32], "big"), int.from_bytes(
            sigs[i][32:], "big")
        if i % 12 == 5:
            s_ = s_ % (sk.N - 1) + 1
        elif i % 12 == 6:
            r = r % (sk.N - 1) + 1
        sigs[i] = r.to_bytes(32, "big") + s_.to_bytes(32, "big")
    pk = sk.pack_msm_batch(pubs, msgs, sigs, WIDE_LANES)
    pk = {k: np.array(v) for k, v in pk.items()}
    nk = pk["keys_x"].shape[-1]
    slot_pubs = list(pubs)
    for i in range(9, WIDE_LANES, 12):
        g = (int(pk["gid"][i]) + 1) % nk
        pk["gid"][i] = g
        x, y = (fs.limbs_to_int(pk[k][:, g]) for k in ("keys_x", "keys_y"))
        slot_pubs[i] = bytes([2 + y % 2]) + x.to_bytes(32, "big")
    want = _secp_oracle(state, (slot_pubs, msgs, sigs))
    state["wide_items"] = (slot_pubs, msgs, sigs), list(want)
    for i in range(8, WIDE_LANES, 12):
        if (i // 12) % 2:
            pk["q_neg"][i % 52, i] ^= True
        else:
            pk["g_rows"][i % 32, i] = (pk["g_rows"][i % 32, i] + 1) % 128
        want[i] = False
    pk, want = _r_in_rn_slot(pk, want)
    check(sum(want) > WIDE_LANES // 2 and not any(
        want[i] for i in range(WIDE_LANES) if i % 12 in (5, 6, 8, 9)),
        "wide pack oracle")
    qt, qc = cs.q_msm_tables(*(convert.to_device_async(pk[k], np.int32,
                                                        DEVICE)
                               for k in ("keys_x", "keys_y")))
    return pk, want, qt, qc


def _wide_ladder(state):
    """K13's wide case: _wide_pack's signatures (s + 1, r + 1 and the key
    corrupted on lanes 12k + 5, 6, 9) through pack_batch, one nibble
    changed on lanes 12k + 8 (window i % 64 of u1, or of u2 on every
    other such lane, + 1 mod 16), lanes 0-3 with r in the r + n slot
    (_r_in_rn_slot).  Returns (arguments, the verdicts they must give:
    _verify_py's, and a reject where a nibble changed, the pack's
    structural mask)."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import secp256k1 as sk

    items, want = state["wide_items"]
    want = list(want)
    packed = [np.array(a) for a in sk.pack_batch(*items, WIDE_LANES)]
    for i in range(8, WIDE_LANES, 12):
        nibs = packed[2 + (i // 12) % 2]
        nibs[i % 64, i] = (nibs[i % 64, i] + 1) % 16
        want[i] = False
    rn, want = _r_in_rn_slot(dict(zip(("r_limbs", "rn_limbs", "rn_valid"),
                                      packed[4:7])), want)
    packed[4:7] = rn["r_limbs"], rn["rn_limbs"], rn["rn_valid"]
    check(sum(want) > WIDE_LANES // 2 and not any(
        want[i] for i in range(WIDE_LANES) if i % 12 in (5, 6, 8, 9)),
        "wide ladder oracle")
    return convert.secp_batch_from_numpy(packed[:-1], DEVICE), want, \
        packed[-1]


def _ladder_zero_z_arrays():
    """K13 inputs whose sum has Z = 0 off infinity, 8 lanes as numpy
    arrays in pack_batch's layout (its `valid` left out), and the
    verdicts they must give.  An off-curve key with y = 0 doubles to Z =
    0, and u1 = 0 with u2 = 2 * 16^63 makes the sum 2Q, doubled 252
    times: lanes 0-3 take Q = (0, 0), whose sum is (0, 0, 0) (X = 0),
    lanes 4-7 Q = (x, 0), x seeded (X != 0).  The plain version's Fermat
    inverse of 0 is 0, so its affine x is 0: a lane accepts where r = 0
    (lanes 0 and 4, lane 4 as the weak zero p), or rn = 0 with rn_valid
    (lanes 2 and 6, lane 6 as p), and rejects where rn = 0 without it
    (lanes 3 and 7) or r = rn = 5 (lanes 1 and 5) - X == r Z^2 alone
    would accept every lane of 0-3."""
    import random

    import numpy as np

    from cometbft_tpu_torch.ops import fe_secp as fs

    rng = random.Random(SEED)
    qx = np.zeros((fs.NLIMBS, 8), np.int32)
    for i in range(4, 8):
        qx[:, i] = fs.int_to_limbs(rng.randrange(1, fs.P))
    u2 = np.zeros((64, 8), np.int32)
    u2[0] = 2
    r = np.repeat(fs.int_to_limbs(5)[:, None], 8, 1)
    rn = r.copy()
    r[:, 0] = fs.int_to_limbs(0)
    r[:, 4] = fs._P_CANON
    for i in (2, 3, 7):
        rn[:, i] = fs.int_to_limbs(0)
    rn[:, 6] = fs._P_CANON
    rn_valid = np.zeros(8, bool)
    rn_valid[[2, 6]] = True
    return (qx, np.zeros_like(qx), np.zeros_like(u2), u2, r, rn,
            rn_valid), [True, False, True, False] * 2


def _ladder_zero_z(torch):
    """_ladder_zero_z_arrays on DEVICE."""
    from cometbft_tpu_torch import convert

    arrays, want = _ladder_zero_z_arrays()
    return convert.secp_batch_from_numpy(arrays, DEVICE), want


def _secp_cases(state, torch):
    """K11, K12 and K13 against their plain versions on the card: K11 at
    K = 4, 128 (commit, batch) and 192 (window), equal at canonical value;
    K12 at the commit's, window's and hostile batch's packs, at the
    commit's with r moved into the r + n slot (_r_in_rn_slot) and at the
    wide corrupted pack (_wide_pack), K13 at the hostile batch, the edge
    lanes, the Z = 0 lanes and the wide corrupted pack (_wide_ladder),
    verdict for verdict, and against _verify_py."""
    import numpy as np

    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.crypto import secp256k1 as sk
    from cometbft_tpu_torch.ops import cuda_secp as cs
    from cometbft_tpu_torch.ops import ed25519 as dev
    from cometbft_tpu_torch.ops import secp256k1 as sk_ops

    sp = state["secp"]
    hostile, _ = _secp_hostile(sp["batch"])
    commit = _secp_window_items(state, [(SECP_COMMIT_HEIGHT,
                                         sp["commits"][SECP_COMMIT_HEIGHT])])
    window = _secp_window_items(state, [(h, sp["commits"][h])
                                        for h in sp["heights"]])
    k11, k12, k13 = [], [], []
    for label, items in (("keys 4", tuple(x[:2] for x in sp["batch"])),
                         ("commit", commit), ("window", window),
                         ("batch", hostile)):
        n = len(items[0])
        pk = sk.pack_msm_batch(*items, dev.bucket_size(n))
        kx, ky = (convert.to_device_async(pk[k], np.int32, DEVICE)
                  for k in ("keys_x", "keys_y"))
        qt, qc = cs.q_msm_tables(kx, ky)
        pt, pc = sk_ops.q_msm_tables_kernel_plain(kx, ky)
        # K11 stores frozen tables, its plain version weak ones: equal at
        # canonical value, and K11's digits already canonical
        err = max(_exact(qt, _frozen(pt)), _exact(qc, _frozen(pc)),
                  _exact(qt, _frozen(qt)), _exact(qc, _frozen(qc)))
        nk = int(kx.shape[-1])
        check(err == 0, f"K11 {label} K = {nk} differs from plain by {err}")
        k11.append({"shape": [nk], "max_abs_err": err, "args": (kx, ky),
                    "phase": label})
        if label == "keys 4":
            continue
        runs = [(label, pk, _secp_oracle(state, items))]
        if label == "commit":
            runs.append(("commit r + n", *_r_in_rn_slot(pk, runs[0][2])))
        if label == "window":
            wide, want, qt_w, qc_w = _wide_pack(state)
            runs.append(("wide, corrupted", wide, want))
        for run, p, want in runs:
            tabs = (qt_w, qc_w) if run.startswith("wide") else (qt, qc)
            args = tabs + convert.secp_msm_from_numpy(p, DEVICE)
            got = cs.msm_verify(*args)
            plain = sk_ops.msm_verify_kernel_plain(*args)
            err = int((got != plain).sum())
            verdicts = (got.cpu().numpy() & p["valid"])[:len(want)].tolist()
            check(err == 0 and verdicts == want, f"K12 {run}: {err} "
                  "verdicts differ from plain, or from _verify_py")
            k12.append({"shape": [int(got.shape[0]), int(tabs[0].shape[-1])],
                        "max_abs_err": err, "args": args, "phase": run})
    packed = sk.pack_batch(*hostile, SECP_BATCH)
    for label, (args, want, mask) in (
            ("batch", (convert.secp_batch_from_numpy(packed[:-1], DEVICE),
                       _secp_oracle(state, hostile), packed[-1])),
            ("edges", (*_ladder_edges(torch), True)),
            ("Z = 0", (*_ladder_zero_z(torch), True)),
            ("wide, corrupted", _wide_ladder(state))):
        got = cs.verify_ladder(*args)
        plain = sk_ops.verify_kernel_plain(*args)
        err = int((got != plain).sum())
        verdicts = got.cpu().numpy() & mask
        check(err == 0 and all(w is None or w == bool(v)
                               for w, v in zip(want, verdicts)),
              f"K13 {label}: {err} verdicts differ from plain, or from the "
              "host")
        k13.append({"shape": [int(got.shape[0])], "max_abs_err": err,
                    "args": args, "phase": label})
    return {"secp_q_tables": k11, "secp_msm_verify": k12,
            "secp_ladder": k13}


def _raw_secp(torch, name, args, step=None):
    """K11, K12 or K13 launched through its C function into preallocated
    outputs: the kernel's time without the wrapper's checks; K11's walk
    or rows alone with step "walk" or "rows"."""
    from cometbft_tpu_torch.ops import cuda_secp as cs
    from cometbft_tpu_torch.ops import device as devmod
    from cometbft_tpu_torch.ops import secp256k1 as sk

    lib = cs._lib()
    dev = args[0].device
    stream = devmod.stream(args[0])
    if name == "secp_q_tables":
        nk = int(args[0].shape[-1])
        outs = [torch.empty(s, dtype=torch.int32, device=dev) for s in (
            (sk.MSM_NQ, 3, 22, nk), (sk.MSM_NQ, 16, 3, 22, nk), (3, 22, nk))]
        ptrs = [devmod.ptr(t) for t in (*args, *outs)]
        fn, call = {
            None: (lib.secp_q_tables, (ptrs[0], ptrs[1], nk, *ptrs[2:])),
            "walk": (lib.secp_q_tables_walk, (ptrs[0], ptrs[1], nk, ptrs[2],
                                              ptrs[4])),
            "rows": (lib.secp_q_tables_rows, (ptrs[2], nk, ptrs[3]))}[step]
        if step == "rows":           # the bases the rows read
            devmod.check_launch(lib.secp_q_tables(ptrs[0], ptrs[1], nk,
                                                  *ptrs[2:], stream), name)

        def launch():
            devmod.check_launch(fn(*call, stream), name)
        return launch
    out = torch.empty(args[2].shape[0] if name == "secp_msm_verify"
                      else args[0].shape[-1], dtype=torch.bool, device=dev)
    gtab, gcorr, ladder_gtab = sk.g_tables_on(dev)
    if name == "secp_msm_verify":
        ptrs = [devmod.ptr(t) for t in (*args, gtab, gcorr)]
        nb, nk = int(out.shape[0]), int(args[0].shape[-1])

        def launch():
            devmod.check_launch(lib.secp_msm_verify(*ptrs, nb, nk,
                                                    devmod.ptr(out), stream),
                                name)
        return launch
    ptrs = [devmod.ptr(t) for t in (*args, ladder_gtab)]
    nb = int(out.shape[0])

    def launch():
        devmod.check_launch(lib.secp_ladder(*ptrs, nb, devmod.ptr(out),
                                            stream), name)
    return launch


# -- phase 19: timing -------------------------------------------------------

def _time(torch, fn, args, reps, inner=1, warm=True):
    """Median over reps of the CUDA-event time of `inner` calls made back
    to back, divided by inner: with inner > 1 the launches queue behind
    each other, which hides the wrapper's host time wherever a launch
    takes longer than it.  warm=False skips the first, untimed call, for
    a function the caller has run on these arguments already."""
    if warm:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def _work(name, case):
    """(int32 multiply-adds, bytes) the function needs on these inputs:
    field products only; each input read once, each output written
    once.  An MSM over all windows counts its whole table; one window of
    select-tree needs one table row per lane; K12 counts the distinct
    table rows its lanes gather.  K3 and K5 sum each
    window's lanes into their partials' lane groups (K3's chunks, K5's
    32-lane blocks), then run one Horner chain per partial."""
    from cometbft_tpu_torch.ops import cuda_msm as cm

    if name == "ed25519_decompress":
        w = case["args"][0].shape[-1]
        return w * DECOMPRESS, w * (32 + 320 + 4)
    if name == "ed25519_table17_neg":
        w = case["args"][0].shape[-1]
        return w * TABLE, w * (320 + 17 * 320)
    if name in ("ed25519_msm_window_major",
                "ed25519_msm_window_major_grouped"):
        mags = case["args"][1]
        nwin, w = mags.shape
        nout = (cm.msm_geometry(w, nwin)[2]
                if name == "ed25519_msm_window_major"
                else -(-w // cm.GROUP_LANES))
        ops = (nwin * (w - nout) * ADD
               + nout * (nwin - 1) * (4 * DBL + DBL_T + ADD))
        return ops, w * 17 * 320 + nwin * w * 5 + nout * 320
    if name == "ed25519_msm_window_loop":
        mags, blk = case["args"][1], case["args"][3]
        nwin, w = mags.shape
        blk, out_l, nblk = cm.loop_geometry(w, blk)
        nout = nblk * out_l
        ops = (nwin * nblk * (blk - out_l) * ADD
               + (nwin - 1) * nout * (4 * DBL + DBL_T + ADD))
        return ops, w * 17 * 320 + nwin * w * 5 + nout * 320
    if name == "ed25519_select_tree":
        w, blk = case["args"][1].shape[-1], case["args"][3]
        blk, out_l, nblk = cm.loop_geometry(w, blk)
        return nblk * (blk - out_l) * ADD, w * (320 + 5) + nblk * out_l * 320
    if name == "secp_q_tables":
        nk = case["args"][0].shape[-1]
        return nk * K11_KEY, nk * (2 * 88 + (52 * 16 + 1) * 264)
    if name == "secp_msm_verify":
        # the table rows this run's lanes gather, each once: distinct
        # (window, row, key) of the key tables (264 bytes a Jacobian row)
        # and their keys' corrections, distinct (window, row) of the G
        # table (176 bytes an affine row); never more than the tables
        qtab, gid, g_rows, q_rows = (case["args"][k] for k in (0, 2, 3, 5))
        nb, nk = gid.shape[0], qtab.shape[-1]
        slot = gid.long().clamp(0, nk - 1)
        q_win = q_rows.new_tensor(range(q_rows.shape[0]))[:, None].long()
        q_used = int(((q_win * 16 + q_rows.long().clamp(0, 15)) * nk
                      + slot[None]).unique().numel())
        g_win = g_rows.new_tensor(range(g_rows.shape[0]))[:, None].long()
        g_used = int((g_win * 128 + g_rows.long().clamp(0, 127))
                     .unique().numel())
        keys = int(slot.unique().numel())
        tables = (min(q_used, 52 * 16 * nk) * 264 + keys * 264
                  + min(g_used, 32 * 128) * 176 + 176 + 264)
        per_sig = 4 + 32 * 5 + 52 * 5 + 2 * 88 + 1 + 1
        return nb * K12_SIG, tables + nb * per_sig
    if name == "secp_ladder":
        # the G table read once; the Q tables live in shared memory only
        nb = case["args"][0].shape[-1]
        return nb * K13_SIG, 16 * 264 + nb * (2 * 88 + 2 * 256 + 2 * 88 + 2)
    if name == "ed25519_verify_ladder":
        # A and R points and ok flags, s and h limbs in, a verdict out, the
        # B table once; the -A tables live in shared memory only
        n = case["args"][2].shape[-1]
        return n * PERSIG_SIG, n * (2 * 320 + 2 + 2 * 64 + 1) + 16 * 320
    if name in HASH_KERNELS:
        blocks, nb = case["args"][0], case["args"][-1]
        used = int(nb.clamp(0, blocks.shape[1]).sum())
        n = blocks.shape[0]
        if name == "sha512_blocks":
            return used * SHA512_BLOCK_OPS, used * 128 + n * (4 + 64)
        return used * SHA256_BLOCK_OPS, used * 64 + n * (4 + 32)
    pa, pr = case["args"]
    n = pa.shape[-1] + pr.shape[-1]
    return (n - 1) * ADD + 3 * DBL, n * 320 + 4


def _raw_persig(torch, args):
    """K14 launched through its C function into a preallocated verdict:
    the kernel's time without the wrapper's checks."""
    from cometbft_tpu_torch.ops import cuda_persig as cp
    from cometbft_tpu_torch.ops import device as devmod

    lib = cp._lib()
    n = int(args[2].shape[-1])
    dev = args[0].device
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    btab = devmod.constant(cp._ed()._BTAB_NP, dev, torch.int32)
    call = (*(devmod.ptr(t) for t in (*args, btab)), n, devmod.ptr(out),
            None, devmod.stream(args[0]))

    def launch():
        devmod.check_launch(lib.ed25519_verify_ladder(*call),
                            "ed25519_verify_ladder")
    return launch


def _raw_sha(torch, name, args):
    """K9 or K10 launched through its C function into preallocated
    outputs: the kernel's time without the wrapper's host work."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import device as devmod

    lib = _build.load("sha2_kernels")
    n, nblk = (int(d) for d in args[0].shape[:2])
    outs = [torch.empty((n, 8), dtype=torch.int32, device=args[0].device)
            for _ in range(len(args) - 1)]
    ptrs = [devmod.ptr(t) for t in args]
    optrs = [devmod.ptr(t) for t in outs]
    stream = devmod.stream(args[0])
    fn = getattr(lib, name)

    def launch():
        devmod.check_launch(fn(*ptrs, n, nblk, *optrs, stream), name)
        return outs
    return launch


def _hashlib_ms(name, msgs):
    """hashlib's time for the same messages on the host, the median of
    three passes (what the kernel replaces; no PyTorch call computes
    SHA-2)."""
    fn = hashlib.sha512 if name == "sha512_blocks" else hashlib.sha256
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for m in msgs:
            fn(m).digest()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[1]


def _sass_block_loops():
    """{kernel name: instruction count and opcode mix of its longest
    loop} for K9 and K10 as nvcc compiled them (cuobjdump of the built
    library; the round warp's block loop, its rounds unrolled, where the
    compiler unrolls the chunks), to set beside SHA512_BLOCK_OPS and
    SHA256_BLOCK_OPS.  Information only: a missing cuobjdump gives
    {"error": ...}."""
    from cometbft_tpu_torch.ops import _build

    try:
        tk = _tool("time_kernels")
        tool = Path(_build.nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(tool), "-sass",
                               str(_build._target("sha2_kernels"))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        return {name: tk._loop_mix(sass, None, KERNEL_ENTRIES[name][0])
                for name in HASH_KERNELS}
    except Exception as e:                    # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"}


def _peak(state):
    """int32 multiply-adds per second of the whole card."""
    return 132 * INT32_LANES_PER_SM_CLK * state["sm_clock_hz"]


def _bound(state, ops, nbytes, bytes_per_s=HBM_BYTES_PER_S):
    """(bound ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / _peak(state) * 1e3, nbytes / bytes_per_s * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# the entry functions of each secp256k1 kernel (K11 has two, K12 one per
# split T and its out-of-line products) and of K14, as ptxas names them
KERNEL_ENTRIES = {"secp_q_tables": ("q_bases_kernel", "q_rows_kernel"),
                  "secp_msm_verify": ("msm_verify_kernel", "7fesecpn3mul",
                                      "7fesecpn3sqr"),
                  "secp_ladder": ("13ladder_kernel",),
                  "ed25519_verify_ladder": ("20verify_ladder_kernel",),
                  "sha512_blocks": ("6Sha512E",),
                  "sha256_blocks": ("6Sha256E",)}
# the kernels whose rows carry raw_ms, the per-lane price and ptxas
SLOW_PLAIN = SECP_KERNELS + ("ed25519_verify_ladder",)


def _ptxas_of(state, name):
    """ptxas -v's registers, stack and spills of the entry functions of
    K9-K14."""
    return {k: v for k, v in state["ptxas"].items()
            if any(e in k for e in KERNEL_ENTRIES[name])}


def phase_timing(state, torch):
    from cometbft_tpu_torch.ops import cuda_decompress as cd
    from cometbft_tpu_torch.ops import cuda_msm as cm
    from cometbft_tpu_torch.ops import cuda_persig as cp
    from cometbft_tpu_torch.ops import secp256k1 as secp_ops
    from cometbft_tpu_torch.ops import sha2

    plain = {"ed25519_verify_ladder": cp.verify_ladder_plain,"sha512_blocks": sha2.sha512_blocks_plain,
             "sha256_blocks": sha2.sha256_blocks_plain,
             "ed25519_decompress": cd.decompress_plain,
             "ed25519_table17_neg": cm.table17_neg_plain,
             "ed25519_msm_window_major": cm.msm_window_major_plain,
             "ed25519_fold_verify": cm.fold_verify_plain,
             "ed25519_msm_window_major_grouped":
                 cm.msm_window_major_grouped_plain,
             "ed25519_msm_window_loop": cm.msm_window_loop_plain,
             "ed25519_select_tree": cm.select_tree_plain,
             "secp_q_tables": secp_ops.q_msm_tables_kernel_plain,
             "secp_msm_verify": secp_ops.msm_verify_kernel_plain,
             "secp_ladder": secp_ops.verify_kernel_plain}
    saved = _counts()
    sass = _sass_block_loops()
    rows = []
    for name in KERNELS:
        fn = _kernels()[name]
        shapes = []
        for case in state["cases"][name]:
            ms = _time(torch, fn, case["args"], 7, inner=10)
            # one call of the plain version, warmed by the kernels
            # phase's comparison on the same arguments: the plain
            # versions are host-bound (thousands of small launches, 10^5
            # for secp and K14), seconds a call, 1-2x between runs
            plain_ms = _time(torch, plain[name], case["args"], 1, warm=False)
            ops, nbytes = _work(name, case)
            bound_ms, bound_by = _bound(state, ops, nbytes)
            extra = {k: case[k] for k in ("group", "blk", "row", "zero_rows")
                     if k in case}
            if name in SECP_KERNELS:
                extra["raw_ms"] = _time(torch, _raw_secp(torch, name,
                                                         case["args"]),
                                        (), 7, inner=10)
            if name == "ed25519_verify_ladder":
                extra["raw_ms"] = _time(torch, _raw_persig(torch,
                                                           case["args"]),
                                        (), 7, inner=10)
                extra["bound_ms_20x13"] = _bound(
                    state, case["shape"][0] * PERSIG_SIG_13, nbytes)[0]
                extra["rejected"] = case["rejected"]
            if name == "secp_q_tables":
                for step in ("walk", "rows"):
                    extra[f"raw_{step}_ms"] = _time(
                        torch, _raw_secp(torch, name, case["args"], step),
                        (), 7, inner=10)
            if name in HASH_KERNELS:
                extra["raw_ms"] = _time(torch, _raw_sha(torch, name,
                                                        case["args"]),
                                        (), 7, inner=20)
                extra["host_hashlib_ms"] = _hashlib_ms(name, case["msgs"])
            shapes.append({"shape": case["shape"],
                           "phase": case.get("phase", "batch"), "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by,
                           ("int32_ops" if name in HASH_KERNELS
                            else "int32_madds"): ops,
                           "bytes": nbytes,
                           "max_abs_err": case["max_abs_err"], **extra})
        top = max(shapes, key=lambda s: s["ms"])
        by_path = {"main": state["main_launches"][name],
                   "mesh": state["mesh_launches"][name],
                   "hash": state["hash_launches"][name],
                   "secp": state["secp_launches"][name],
                   "sr25519": state["sr25519_launches"][name],
                   "sigcache": state["sigcache_launches"][name],
                   "pipeline": state["pipeline_launches"][name],
                   "votes": state["votes_launches"][name],
                   "light": state["light_launches"].get(name, 0),
                   "blocksync": state["blocksync_launches"].get(name, 0),
                   "consensus": state["consensus_launches"].get(name, 0),
                   "lightserve": state["lightserve_launches"].get(name, 0),
                   "p2p": state["p2p_launches"].get(name, 0),
                   **{cfg: c[name]
                      for cfg, c in state["engine_launches"].items()}}
        if name in DEFAULT_KERNELS:
            launches = by_path["main"]
        elif name in HASH_KERNELS:
            launches = by_path["hash"]
        elif name in SECP_KERNELS:
            launches = by_path["secp"]
        else:
            launches = sum(v for k, v in by_path.items()
                           if k not in ("main", "mesh", "hash", "secp",
                                        "sr25519", "sigcache", "pipeline",
                                        "votes", "light", "blocksync",
                                        "consensus", "lightserve", "p2p"))
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": CSRC + source,
                     "replaces": replaces, "launches": launches,
                     "launches_by_path": by_path,
                     "max_abs_err": max(s["max_abs_err"] for s in shapes),
                     "ms": top["ms"], "plain_ms": top["plain_ms"],
                     "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                     "library_ms": None, "matches_plain": True,
                     "shape": top["shape"], "shapes": shapes,
                     **({"raw_ms": top["raw_ms"],
                         "int32_madds_per_lane": {
                             "secp_q_tables": K11_KEY,
                             "secp_msm_verify": K12_SIG,
                             "secp_ladder": K13_SIG,
                             "ed25519_verify_ladder": PERSIG_SIG}[name],
                         "ptxas": _ptxas_of(state, name)}
                        if name in SLOW_PLAIN else {}),
                     **({"host_hashlib_ms": top["host_hashlib_ms"],
                         "min_ops_per_block": (
                             SHA512_BLOCK_OPS if name == "sha512_blocks"
                             else SHA256_BLOCK_OPS),
                         "chain": {k: v for k, v in next(
                             s for s in shapes if s["phase"] == "chain")
                             .items() if k in ("shape", "ms", "raw_ms",
                                               "bound_ms", "bound_by")},
                         "ptxas": _ptxas_of(state, name),
                         "sass_block_loop": sass.get(name, sass)}
                        if name in HASH_KERNELS else {})})
    for name, fn in _kernels().items():   # timing launches do not count
        fn.launches = saved[name]
    state["kernel_rows"] = rows + [state["k8_row"]]
    return {"card": state["card"], "peak_int32_madds_per_s": _peak(state),
            "main_path_seconds": state["main_s"]}


if __name__ == "__main__":
    sys.exit(main())
