"""Authenticated encryption for all peer traffic (the port's copy of
`cometbft_tpu.p2p.conn.secret_connection`; CometBFT
p2p/conn/secret_connection.go).

Station-to-Station over TCP: ephemeral X25519 ECDH -> HKDF-SHA256 ->
two ChaCha20-Poly1305 AEADs (one per direction, little-endian counter
nonces) -> Ed25519 signature over the transcript challenge proving the
long-term identity.  Frames are fixed 1024-byte chunks (length-prefixed
inside), each sealed with a 16-byte MAC.

The transcript binding uses HKDF over the sorted ephemeral pubkeys, as
the JAX package does (CometBFT uses a Merlin transcript): a port node
interoperates with a JAX one, not with CometBFT.  The ciphers are the
pure-Python ones of crypto/aead.py, wire compatible with a peer that
runs the `cryptography` wheel's.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct

from ...crypto import aead
from ...crypto import ed25519
from ...libs import lockrank

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE

CHALLENGE_INFO = b"TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


class SecretConnectionError(Exception):
    pass


def _hkdf_sha256(ikm: bytes, salt: bytes | None, info: bytes,
                 length: int) -> bytes:
    """RFC 5869 extract-then-expand over HMAC-SHA256."""
    prk = hmac.new(salt if salt else b"\x00" * 32, ikm,
                   hashlib.sha256).digest()
    okm, t, i = b"", b"", 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]),
                     hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def derive_secrets(shared: bytes, salt: bytes | None, we_are_lo: bool,
                   info: bytes = CHALLENGE_INFO
                   ) -> tuple[bytes, bytes, bytes]:
    """HKDF-SHA256 -> (recv_key, send_key, challenge).

    Split rule of CometBFT's deriveSecrets (secret_connection.go): the
    lo ("least") side receives with okm[0:32] and sends with
    okm[32:64]; the hi side swaps them; okm[64:96] is the transcript
    challenge both sides sign.  Byte for byte the JAX package's."""
    okm = _hkdf_sha256(shared, salt, info, 96)
    if we_are_lo:
        recv_key, send_key = okm[0:32], okm[32:64]
    else:
        send_key, recv_key = okm[0:32], okm[32:64]
    return recv_key, send_key, okm[64:96]


class _NonceCounter:
    """96-bit nonce: 4 zero bytes + 64-bit little-endian counter
    (secret_connection.go incrNonce)."""

    def __init__(self):
        self.counter = 0

    def next(self) -> bytes:
        n = struct.pack("<4xQ", self.counter)
        self.counter += 1
        if self.counter >= 1 << 64:
            raise SecretConnectionError("nonce wrapped")
        return n


class SecretConnection:
    """Wrap a socket-like object (sendall/recv/close) with an
    authenticated encrypted stream."""

    def __init__(self, sock, recv_aead, send_aead, remote_pubkey):
        self._sock = sock
        self._recv_aead = recv_aead
        self._send_aead = send_aead
        self._recv_nonce = _NonceCounter()
        self._send_nonce = _NonceCounter()
        self._send_mtx = lockrank.RankedLock("p2p.conn.send")
        self._recv_mtx = lockrank.RankedLock("p2p.conn.recv")
        self.remote_pubkey = remote_pubkey

    # -- handshake ---------------------------------------------------------
    @staticmethod
    def make(sock, priv_key) -> "SecretConnection":
        """Mutual-auth handshake (secret_connection.go
        MakeSecretConnection). priv_key: our long-term Ed25519 key."""
        eph_priv = os.urandom(32)
        eph_pub = aead.x25519_base(eph_priv)

        # 1. exchange ephemerals (plaintext)
        sock.sendall(eph_pub)
        remote_eph = _read_exact(sock, 32)

        # sort to decide directional keys (lo side = "first")
        we_are_lo = eph_pub < remote_eph
        lo, hi = sorted((eph_pub, remote_eph))

        shared = aead.x25519(eph_priv, remote_eph)

        # 2. derive: 2 x 32-byte keys + 32-byte challenge, transcript-
        # bound to both ephemerals via the HKDF salt
        recv_key, send_key, challenge = derive_secrets(
            shared, lo + hi, we_are_lo)

        conn = SecretConnection(sock, aead.ChaCha20Poly1305(recv_key),
                                aead.ChaCha20Poly1305(send_key), None)

        # 3. exchange long-term identity + signature over the challenge
        # (over the now-encrypted channel)
        local_pub = priv_key.pub_key().bytes()
        sig = priv_key.sign(challenge)
        conn.write(local_pub + sig)

        auth = b""
        while len(auth) < 96:
            chunk = conn.read()
            if not chunk:
                raise SecretConnectionError("peer closed during handshake")
            auth += chunk
        remote_pub_bytes, remote_sig = auth[:32], auth[32:96]
        remote_pub = ed25519.PubKey(remote_pub_bytes)
        if not remote_pub.verify_signature(challenge, remote_sig):
            raise SecretConnectionError("challenge signature invalid")
        conn.remote_pubkey = remote_pub
        return conn

    # -- framed IO ---------------------------------------------------------
    def write(self, data: bytes) -> int:
        """Encrypt+send data in sealed 1024-byte frames."""
        n = 0
        with self._send_mtx:
            view = memoryview(data)
            while len(view) > 0:
                chunk = view[:DATA_MAX_SIZE]
                frame = struct.pack("<I", len(chunk)) + bytes(chunk)
                frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
                sealed = self._send_aead.encrypt(
                    self._send_nonce.next(), frame, None)
                self._sock.sendall(sealed)
                n += len(chunk)
                view = view[len(chunk):]
        return n

    def remote_host(self) -> str:
        """Observed IP of the other side (for PEX address learning)."""
        try:
            return self._sock.getpeername()[0]
        except OSError:
            return ""

    def read(self) -> bytes:
        """One decrypted frame's payload (empty bytes = EOF)."""
        with self._recv_mtx:
            sealed = _read_exact(self._sock, SEALED_FRAME_SIZE,
                                 allow_eof=True)
            if sealed is None:
                return b""
            try:
                frame = self._recv_aead.decrypt(
                    self._recv_nonce.next(), sealed, None)
            except Exception as e:
                raise SecretConnectionError(
                    f"frame decryption failed: {e}") from e
            (length,) = struct.unpack_from("<I", frame)
            if length > DATA_MAX_SIZE:
                raise SecretConnectionError("invalid frame length")
            return frame[DATA_LEN_SIZE:DATA_LEN_SIZE + length]

    def close(self) -> None:
        # shutdown() first: close() alone doesn't send FIN (or wake a
        # blocked recv) while another thread holds the fd in recv()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except (OSError, AttributeError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def _read_exact(sock, n: int, allow_eof: bool = False):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if allow_eof and not buf:
                return None
            raise SecretConnectionError("unexpected EOF")
        buf += chunk
    return buf
