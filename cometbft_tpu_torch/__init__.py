"""PyTorch/CUDA port of cometbft_tpu's commit-verification path.

Runs verify_commit / verify_commit_light / DeferredSigBatch -> RLC batch
verify on one NVIDIA card (Hopper, sm_90a), with a hand-written CUDA
kernel for each step the JAX package runs as a Pallas TPU kernel, and
for SHA-512 / SHA-256 on the device-hash path and validator-set hashing;
secp256k1 and mixed-key commits run on hand-written kernels too (the
per-key tables, the MSM verify and the ladder).  The consumers on top
of it: the verify pipeline, the consensus vote stream and the light
client (light/), with the wire types they read.  The
package imports torch, numpy and the standard library only; its entry
points take `device=` (default "cuda") and run every kernel's plain
torch version when the caller passes device="cpu".
"""
