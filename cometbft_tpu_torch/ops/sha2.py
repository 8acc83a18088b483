"""Batched SHA-256 / SHA-512 of pre-padded messages: kernels K9 and K10,
their plain torch versions, and the host padding helpers — the port's
counterpart of `cometbft_tpu.ops.sha2`.

Layout is the JAX package's: a batch of pre-padded messages is
(N, B, 16) 32-bit words, B the static number of blocks, with per-message
block counts (N,) masking the blocks past each message's end.  SHA-512's
64-bit words travel as separate hi and lo 32-bit halves, so the packers
stay byte-identical to the JAX package's.  Words are int32 tensors
holding the uint32 bit patterns; digests come back the same way.

Routes: sha256_blocks / sha512_blocks launch their CUDA kernel
(ops/csrc/sha2_kernels.cu) for CUDA tensors and run the plain version
for CPU tensors.  The plain versions hold every 32-bit word in int64,
masked to 32 bits after each add and left shift (torch's `>>` on int32
sign-extends), and build SHA-512's 64-bit rotations from the hi/lo
halves as the JAX package does.

K10 replaces the JAX package's `sha256_blocks` (ops/sha2.py:78) and K9
its `sha512_blocks` (:210): plain `jnp` under `lax.fori_loop` /
`lax.scan`, which XLA compiles into one program.  Eager torch would
launch tens of thousands of small ops per call instead (80 rounds x B
blocks x tens of ops), so the card runs one hand-written kernel: one
thread per message, the state and the 16-word schedule in registers,
the rounds unrolled, blocks past n_blocks skipped.  What bounds them on
the H100: 32-bit integer operations (a SHA-512 block is ~5,800 of them
against 128 bytes read); one thread per message leaves the card short
of threads below ~30,000 messages.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as devmod

M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# constants (FIPS 180-4)
# ---------------------------------------------------------------------------

K256 = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]
H256 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

K512 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817]
H512 = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
        0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
        0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]


# ---------------------------------------------------------------------------
# 32-bit words in int64
# ---------------------------------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """Bit patterns in any integer dtype -> int64 values in [0, 2**32)."""
    return t.to(torch.int64) & M32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def _rotr32(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _rotr64(h, l, n):
    if n < 32:
        return (((h >> n) | (l << (32 - n))) & M32,
                ((l >> n) | (h << (32 - n))) & M32)
    if n == 32:
        return l, h
    n -= 32
    return (((l >> n) | (h << (32 - n))) & M32,
            ((h >> n) | (l << (32 - n))) & M32)


def _shr64(h, l, n):
    if n < 32:
        return h >> n, ((l >> n) | (h << (32 - n))) & M32
    return torch.zeros_like(h), h >> (n - 32)


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _sha256_block(state, w):
    """One compression: state 8 (N,) words, w 16 (N,) words, int64."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            w15, w2 = w[(i - 15) % 16], w[(i - 2) % 16]
            s0 = _rotr32(w15, 7) ^ _rotr32(w15, 18) ^ (w15 >> 3)
            s1 = _rotr32(w2, 17) ^ _rotr32(w2, 19) ^ (w2 >> 10)
            w[i % 16] = (w[i % 16] + s0 + w[(i - 7) % 16] + s1) & M32
        s1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = (h + s1 + ch + K256[i] + w[i % 16]) & M32
        s0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        a, b, c, d, e, f, g, h = ((t1 + t2) & M32, a, b, c,
                                  (d + t1) & M32, e, f, g)
    return [(s + x) & M32 for s, x in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_blocks_plain(blocks: torch.Tensor,
                        n_blocks: torch.Tensor) -> torch.Tensor:
    """(N, B, 16) big-endian words, (N,) block counts -> (N, 8) digest
    words, as int32 bit patterns: the JAX package's sha256_blocks."""
    words = _u32(blocks)
    nb = n_blocks.to(torch.int64)
    n = words.shape[0]
    state = [torch.full((n,), v, dtype=torch.int64, device=words.device)
             for v in H256]
    for b in range(words.shape[1]):
        new = _sha256_block(state, words[:, b].unbind(-1))
        keep = b < nb
        state = [torch.where(keep, x, s) for x, s in zip(new, state)]
    return _i32(torch.stack(state, dim=-1))


def _sha512_block(sh, sl, wh, wl):
    """One compression: state hi/lo 8 (N,) words each, schedule hi/lo 16
    (N,) words each, int64."""
    wh, wl = list(wh), list(wl)
    (ah, bh, ch_, dh, eh, fh, gh, hh) = sh
    (al, bl, cl, dl, el, fl, gl, hl) = sl
    for i in range(80):
        j = i % 16
        if i >= 16:
            i15, i2, i7 = (i - 15) % 16, (i - 2) % 16, (i - 7) % 16
            s0 = _xor3(_rotr64(wh[i15], wl[i15], 1),
                       _rotr64(wh[i15], wl[i15], 8),
                       _shr64(wh[i15], wl[i15], 7))
            s1 = _xor3(_rotr64(wh[i2], wl[i2], 19),
                       _rotr64(wh[i2], wl[i2], 61),
                       _shr64(wh[i2], wl[i2], 6))
            th, tl = _add64(wh[j], wl[j], *s0)
            th, tl = _add64(th, tl, wh[i7], wl[i7])
            wh[j], wl[j] = _add64(th, tl, *s1)
        s1 = _xor3(_rotr64(eh, el, 14), _rotr64(eh, el, 18),
                   _rotr64(eh, el, 41))
        chh = (eh & fh) ^ ((eh ^ M32) & gh)
        chl = (el & fl) ^ ((el ^ M32) & gl)
        t1h, t1l = _add64(hh, hl, *s1)
        t1h, t1l = _add64(t1h, t1l, chh, chl)
        t1h, t1l = _add64(t1h, t1l, K512[i] >> 32, K512[i] & M32)
        t1h, t1l = _add64(t1h, t1l, wh[j], wl[j])
        s0 = _xor3(_rotr64(ah, al, 28), _rotr64(ah, al, 34),
                   _rotr64(ah, al, 39))
        majh = (ah & bh) ^ (ah & ch_) ^ (bh & ch_)
        majl = (al & bl) ^ (al & cl) ^ (bl & cl)
        t2h, t2l = _add64(*s0, majh, majl)
        ndh, ndl = _add64(dh, dl, t1h, t1l)
        nah, nal = _add64(t1h, t1l, t2h, t2l)
        ah, bh, ch_, dh, eh, fh, gh, hh = nah, ah, bh, ch_, ndh, eh, fh, gh
        al, bl, cl, dl, el, fl, gl, hl = nal, al, bl, cl, ndl, el, fl, gl
    out = [_add64(sh[k], sl[k], x, y) for k, (x, y) in enumerate(
        zip((ah, bh, ch_, dh, eh, fh, gh, hh),
            (al, bl, cl, dl, el, fl, gl, hl)))]
    return [o[0] for o in out], [o[1] for o in out]


def sha512_blocks_plain(blocks_hi: torch.Tensor, blocks_lo: torch.Tensor,
                        n_blocks: torch.Tensor):
    """(N, B, 16) hi and lo halves of big-endian 64-bit words, (N,) block
    counts -> (N, 8) digest hi and lo words, as int32 bit patterns: the
    JAX package's sha512_blocks."""
    bh, bl = _u32(blocks_hi), _u32(blocks_lo)
    nb = n_blocks.to(torch.int64)
    n = bh.shape[0]

    def init(vals):
        return [torch.full((n,), v, dtype=torch.int64, device=bh.device)
                for v in vals]

    sh, sl = init([v >> 32 for v in H512]), init([v & M32 for v in H512])
    for b in range(bh.shape[1]):
        nh, nl = _sha512_block(sh, sl, bh[:, b].unbind(-1),
                               bl[:, b].unbind(-1))
        keep = b < nb
        sh = [torch.where(keep, x, s) for x, s in zip(nh, sh)]
        sl = [torch.where(keep, x, s) for x, s in zip(nl, sl)]
    return _i32(torch.stack(sh, dim=-1)), _i32(torch.stack(sl, dim=-1))


# ---------------------------------------------------------------------------
# kernel wrappers (K9, K10)
# ---------------------------------------------------------------------------

def _require_blocks(t: torch.Tensor, name: str, like=None) -> None:
    devmod.require(t, name, torch.int32,
                   (None, None, 16) if like is None else tuple(like.shape))
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name}: expected device {like.device}, got "
                         f"{t.device}")


def _require_counts(n_blocks: torch.Tensor, blocks: torch.Tensor) -> None:
    devmod.require(n_blocks, "n_blocks", torch.int32, (blocks.shape[0],))
    if not n_blocks.is_contiguous():
        raise ValueError("n_blocks: expected a contiguous tensor")
    if n_blocks.device != blocks.device:
        raise ValueError(f"n_blocks: expected device {blocks.device}, got "
                         f"{n_blocks.device}")


def sha256_blocks(blocks: torch.Tensor, n_blocks: torch.Tensor):
    """(N, B, 16) int32 bit patterns of big-endian words, (N,) int32 block
    counts -> (N, 8) int32 digest words.  CPU tensor: the plain version;
    CUDA tensor: kernel K10."""
    if not blocks.is_cuda:
        return sha256_blocks_plain(blocks, n_blocks)
    from . import _build

    _require_blocks(blocks, "sha256 blocks")
    _require_counts(n_blocks, blocks)
    n, nblk = blocks.shape[0], blocks.shape[1]
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    if n == 0:
        return out
    lib = _build.load("sha2_kernels")
    with torch.cuda.device(blocks.device):
        rc = lib.sha256_blocks(devmod.ptr(blocks), devmod.ptr(n_blocks), n,
                               nblk, devmod.ptr(out), devmod.stream(blocks))
    devmod.check_launch(rc, "sha256_blocks")
    sha256_blocks.launches += 1
    return out


sha256_blocks.launches = 0


def sha512_blocks(blocks_hi: torch.Tensor, blocks_lo: torch.Tensor,
                  n_blocks: torch.Tensor):
    """(N, B, 16) int32 bit patterns of the hi and lo halves of big-endian
    64-bit words, (N,) int32 block counts -> (N, 8) int32 digest hi and
    lo words.  CPU tensor: the plain version; CUDA tensor: kernel K9."""
    if not blocks_hi.is_cuda:
        return sha512_blocks_plain(blocks_hi, blocks_lo, n_blocks)
    from . import _build

    _require_blocks(blocks_hi, "sha512 blocks_hi")
    _require_blocks(blocks_lo, "sha512 blocks_lo", like=blocks_hi)
    _require_counts(n_blocks, blocks_hi)
    n, nblk = blocks_hi.shape[0], blocks_hi.shape[1]
    out_hi = torch.empty((n, 8), dtype=torch.int32, device=blocks_hi.device)
    out_lo = torch.empty_like(out_hi)
    if n == 0:
        return out_hi, out_lo
    lib = _build.load("sha2_kernels")
    with torch.cuda.device(blocks_hi.device):
        rc = lib.sha512_blocks(devmod.ptr(blocks_hi), devmod.ptr(blocks_lo),
                               devmod.ptr(n_blocks), n, nblk,
                               devmod.ptr(out_hi), devmod.ptr(out_lo),
                               devmod.stream(blocks_hi))
    devmod.check_launch(rc, "sha512_blocks")
    sha512_blocks.launches += 1
    return out_hi, out_lo


sha512_blocks.launches = 0


# ---------------------------------------------------------------------------
# host-side padding (numpy), byte for byte the JAX package's
# ---------------------------------------------------------------------------

def pad_sha256(msgs: list[bytes], max_blocks: int | None = None):
    """Pad a batch of messages; returns (blocks (N,B,16) u32, n_blocks
    (N,))."""
    return _pad(msgs, 64, max_blocks)


def pad_sha512(msgs: list[bytes], max_blocks: int | None = None):
    """Returns (blocks_hi, blocks_lo (N,B,16) u32, n_blocks (N,))."""
    blocks, n = _pad(msgs, 128, max_blocks)
    # blocks: (N, B, 32) u32 big-endian words; split into 64-bit hi/lo
    hi = blocks[..., 0::2]
    lo = blocks[..., 1::2]
    return hi, lo, n


def pad_sha512_matrix(mat: np.ndarray, lens: np.ndarray):
    """Like pad_sha512, but over a caller-built (N, B*128) u8 matrix:
    row i holds message bytes [0, lens[i]) with zeros beyond.  The
    matrix is padded IN PLACE (0x80 + big-endian bit length) — the
    zero-copy seam for packers that can assemble messages columnarly.
    Returns (blocks_hi, blocks_lo (N,B,16) u32, n_blocks (N,))."""
    blocks, n = _pad_matrix(mat, np.asarray(lens, dtype=np.int64), 128)
    hi = blocks[..., 0::2]
    lo = blocks[..., 1::2]
    return hi, lo, n


def _pad(msgs: list[bytes], block_bytes: int, max_blocks: int | None):
    # vectorized: one C-level join + masked scatter instead of four
    # numpy ops per message
    lenbytes = 16 if block_bytes == 128 else 8
    n = len(msgs)
    lens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    fit = (lens + 1 + lenbytes + block_bytes - 1) // block_bytes
    B = int(max_blocks or (fit.max() if n else 1))
    out = np.zeros((n, B * block_bytes), dtype=np.uint8)
    if n:
        if int(fit.max()) > B:
            raise ValueError("message exceeds max_blocks")
        # boolean-mask assignment fills row-major, i.e. in exactly the
        # concatenated-message order of `flat`
        col = np.arange(B * block_bytes, dtype=np.int64)
        flat = np.frombuffer(b"".join(msgs), dtype=np.uint8)
        out[col[None, :] < lens[:, None]] = flat
    return _pad_matrix(out, lens, block_bytes)


def _pad_matrix(out: np.ndarray, lens: np.ndarray, block_bytes: int):
    lenbytes = 16 if block_bytes == 128 else 8
    n = out.shape[0]
    B = out.shape[1] // block_bytes
    n_blocks = ((lens + 1 + lenbytes + block_bytes - 1)
                // block_bytes).astype(np.int32)
    if n:
        if int(n_blocks.max()) > B:
            raise ValueError("message exceeds max_blocks")
        rows = np.arange(n)
        out[rows, lens] = 0x80
        end = n_blocks.astype(np.int64) * block_bytes
        # big-endian bit length in the block tail; bytes above the low
        # 8 stay zero for any message under 2^61 bits
        bits = (lens * 8).astype(np.uint64)
        for k in range(8):
            out[rows, end - 1 - k] = \
                ((bits >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8)
    # big-endian u32 words via one byteswapping view+copy
    w32 = out.view(">u4").reshape(n, B, block_bytes // 4) \
        .astype(np.uint32)
    return w32, n_blocks


def digest256_to_bytes(words) -> bytes:
    """(8,) big-endian digest words (uint32, or int32 bit patterns) ->
    32 bytes."""
    return (np.asarray(words).astype(np.int64) & M32).astype(">u4").tobytes()


def digest512_to_bytes(hi, lo) -> bytes:
    """(8,) hi and (8,) lo digest words -> 64 bytes."""
    pairs = np.stack([np.asarray(hi), np.asarray(lo)], axis=-1)
    return (pairs.astype(np.int64) & M32).astype(">u4").tobytes()
