"""The p2p stack in the port (crypto/aead.py, libs/flowrate.py, p2p/key,
node_info, conn/connection, conn/secret_connection, peer, transport,
switch) against the JAX package on the CPU.

The ciphers run on the RFC 7748 / 8439 vectors of tests/test_aead.py and
on seeded inputs beside the JAX module; derive_secrets, NodeInfo bytes,
node IDs, key files and MConnection packets are compared byte for byte.
Interop runs over a socketpair or 127.0.0.1: a port SecretConnection
against a JAX one (the port's ephemeral key chosen so that it is the
"lo" side, then the "hi" side), a tampered frame each way, a port
MConnection exchanging channel messages with a JAX one, and a port
transport dialling a JAX one and back, with the wrong-ID and
network-mismatch rejects compared.  Every socket carries a timeout, so a
hung handshake fails its test."""

import gc
import hashlib
import json
import random
import socket
import struct
import threading
import time

import pytest
import torch

from cometbft_tpu.crypto import aead as jaead
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.libs import flowrate as jflow
from cometbft_tpu.p2p import key as jkey
from cometbft_tpu.p2p import node_info as jni
from cometbft_tpu.p2p import transport as jtr
from cometbft_tpu.p2p.conn import connection as jconn
from cometbft_tpu.p2p.conn import secret_connection as jsc
from cometbft_tpu_torch.crypto import aead as taead
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.libs import flowrate as tflow
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import metrics as tmetrics
from cometbft_tpu_torch.p2p import key as tkey
from cometbft_tpu_torch.p2p import node_info as tni
from cometbft_tpu_torch.p2p import transport as ttr
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn import connection as tconn
from cometbft_tpu_torch.p2p.conn import secret_connection as tsc
from cometbft_tpu_torch.p2p.switch import Switch

SOCK_TIMEOUT_S = 20.0
SEED = 20261025
# ephemeral X25519 scalars whose public keys start with 0x00 (the port is
# the "lo" side of the handshake) and 0xff (the "hi" side)
EPH = {"lo": hashlib.sha256(b"lo443").digest(),
       "hi": hashlib.sha256(b"hi2").digest()}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


@pytest.fixture(autouse=True)
def _checks():
    """Lock ranks in raise mode and no thread left behind."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    yield
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=5.0) == []


def _rng(salt=0):
    return random.Random(SEED + salt)


def _bytes(rng, n):
    return bytes(rng.getrandbits(8) for _ in range(n))


# -- ciphers -------------------------------------------------------------------------

RFC7748 = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]


@pytest.mark.parametrize("k,u,out", RFC7748)
def test_x25519_rfc7748_vectors(k, u, out):
    assert taead.x25519(bytes.fromhex(k), bytes.fromhex(u)) == \
        bytes.fromhex(out)


def test_x25519_rfc7748_iterated_and_dh():
    k = u = (9).to_bytes(32, "little")
    k, u = taead.x25519(k, u), k
    assert k == bytes.fromhex(
        "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079")
    a = bytes.fromhex(
        "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex(
        "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    a_pub, b_pub = taead.x25519_base(a), taead.x25519_base(b)
    assert a_pub == bytes.fromhex(
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert b_pub == bytes.fromhex(
        "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    shared = bytes.fromhex(
        "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert taead.x25519(a, b_pub) == taead.x25519(b, a_pub) == shared


def test_chacha20_poly1305_rfc8439_vectors():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    assert taead._chacha20_block(struct.unpack("<8I", key), 1,
                                 struct.unpack("<3I", nonce)) == bytes.fromhex(
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
    assert taead.poly1305_mac(bytes.fromhex(
        "85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b"),
        b"Cryptographic Forum Research Group") == bytes.fromhex(
        "a8061dc1305136c6c22b8baf0c0127a9")
    key = bytes(range(0x80, 0xa0))
    nonce = bytes.fromhex("070000004041424344454647")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer "
          b"you only one tip for the future, sunscreen would be it.")
    a = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    sealed = taead.ChaCha20Poly1305(key).encrypt(nonce, pt, a)
    assert sealed[-16:] == bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")
    assert sealed[:-16] == bytes.fromhex(
        "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
        "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
        "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b6116")
    assert taead.ChaCha20Poly1305(key).decrypt(nonce, sealed, a) == pt


def test_aead_refusals_as_jax():
    box = taead.ChaCha20Poly1305(b"k" * 32)
    nonce = b"\x00" * 12
    sealed = box.encrypt(nonce, b"hello fleet", b"aad")
    for call in (lambda m: m.ChaCha20Poly1305(b"k" * 32).decrypt(
                     nonce, sealed, b"other-aad"),
                 lambda m: m.ChaCha20Poly1305(b"k" * 32).decrypt(
                     nonce, bytes([sealed[0] ^ 1]) + sealed[1:], b"aad"),
                 lambda m: m.ChaCha20Poly1305(b"k" * 32).decrypt(
                     nonce, sealed[:8], b"aad"),
                 lambda m: m.ChaCha20Poly1305(b"short"),
                 lambda m: m.ChaCha20Poly1305(b"\0" * 32).encrypt(
                     b"\0" * 8, b"x", None),
                 lambda m: m.x25519(b"\0" * 31, b"\0" * 32)):
        msgs = []
        for m in (taead, jaead):
            with pytest.raises(ValueError) as e:
                call(m)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert box.decrypt(nonce, box.encrypt(nonce, b"", None), None) == b""


@pytest.mark.parametrize("salt", range(4))
def test_ciphers_equal_jax_on_seeded_inputs(salt):
    rng = _rng(salt)
    k, u = _bytes(rng, 32), _bytes(rng, 32)
    assert taead.x25519(k, u) == jaead.x25519(k, u)
    assert taead.x25519_base(k) == jaead.x25519_base(k)
    key, nonce, aad = _bytes(rng, 32), _bytes(rng, 12), _bytes(rng, salt * 7)
    for n in (0, 1, 63, 64, 65, 1028, 3000):
        data = _bytes(rng, n)
        sealed = taead.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert sealed == jaead.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert jaead.ChaCha20Poly1305(key).decrypt(nonce, sealed, aad) == data
        assert taead.poly1305_mac(key, data) == jaead.poly1305_mac(key, data)


def test_flowrate_monitor_like_jax():
    clock = [100.0]
    mons = [tflow.Monitor(), jflow.Monitor()]
    for m in mons:
        m._start = m._sample_start = m._last_refill = clock[0]
    rng = _rng(9)
    for mod in (tflow, jflow):
        mod.time = type("T", (), {"monotonic": staticmethod(lambda: clock[0]),
                                  "sleep": staticmethod(time.sleep)})
    try:
        for _ in range(50):
            clock[0] += rng.choice([0.01, 0.05, 0.2, 1.5])
            n = rng.randint(0, 5000)
            assert mons[0].update(n) == mons[1].update(n) == n
            rate = rng.choice([0, 1000, 10_000])
            assert mons[0].limit(n, rate) == mons[1].limit(n, rate)
            assert mons[0].status() == mons[1].status()
    finally:
        tflow.time = jflow.time = time


# -- identity and wire bytes -----------------------------------------------------

@pytest.mark.parametrize("salt", range(3))
def test_derive_secrets_and_node_ids_equal_jax(salt):
    rng = _rng(100 + salt)
    shared, salt_b = _bytes(rng, 32), _bytes(rng, 64)
    for lo in (True, False):
        assert tsc.derive_secrets(shared, salt_b, lo) == \
            jsc.derive_secrets(shared, salt_b, lo)
    assert tsc.derive_secrets(shared, None, True) == \
        jsc.derive_secrets(shared, None, True)
    seed = _bytes(rng, 32)
    tk, jk = ted.PrivKey.generate(seed), jed.PrivKey.generate(seed)
    assert tkey.node_id_from_pubkey(tk.pub_key()) == \
        jkey.node_id_from_pubkey(jk.pub_key())
    assert tkey.NodeKey(tk).id == jkey.NodeKey(jk).id


def test_node_key_file_equal_jax(tmp_path):
    seed = _bytes(_rng(7), 32)
    tk = tkey.NodeKey(ted.PrivKey.generate(seed))
    jk = jkey.NodeKey(jed.PrivKey.generate(seed))
    tk.save_as(str(tmp_path / "t" / "node_key.json"))
    jk.save_as(str(tmp_path / "j" / "node_key.json"))
    t_text = (tmp_path / "t" / "node_key.json").read_text()
    assert t_text == (tmp_path / "j" / "node_key.json").read_text()
    assert json.loads(t_text)["priv_key"]["type"] == \
        "tendermint/PrivKeyEd25519"
    assert tkey.NodeKey.load(str(tmp_path / "j" / "node_key.json")).id == \
        jk.id
    path = str(tmp_path / "gen" / "node_key.json")
    assert tkey.NodeKey.load_or_gen(path).id == \
        tkey.NodeKey.load_or_gen(path).id == jkey.NodeKey.load(path).id


def _infos(mod, salt):
    rng = _rng(200 + salt)
    return [mod.NodeInfo(), mod.NodeInfo(
        protocol_version=mod.ProtocolVersion(rng.randint(0, 300),
                                             rng.randint(0, 300),
                                             rng.randint(0, 2**40)),
        node_id=_bytes(rng, 20).hex(), listen_addr="127.0.0.1:%d" % salt,
        network="chain-%d" % salt, version="1.0.%d" % salt,
        channels=bytes([0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40][:salt + 1]),
        moniker="node-é-%d" % salt, tx_index="off" if salt else "on",
        rpc_address="tcp://0.0.0.0:%d" % (26657 + salt))]


@pytest.mark.parametrize("salt", range(4))
def test_node_info_bytes_equal_jax(salt):
    for t, j in zip(_infos(tni, salt), _infos(jni, salt)):
        assert t.to_proto() == j.to_proto()
        assert t.protocol_version.to_proto() == j.protocol_version.to_proto()
        back = tni.NodeInfo.from_proto(j.to_proto())
        assert back == t and back.to_proto() == t.to_proto()


def test_node_info_checks_as_jax():
    base = dict(node_id="ab" * 20, network="n", channels=b"\x30\x38")
    cases = [dict(node_id="x"), dict(channels=bytes(range(17))),
             dict(channels=b"\x30\x30"), dict(moniker="m" * 256), {}]
    for c in cases:
        out = []
        for mod in (tni, jni):
            try:
                mod.NodeInfo(**{**base, **c}).validate_basic()
                out.append("ok")
            except mod.NodeInfoError as e:
                out.append(str(e))
        assert out[0] == out[1]
    others = [dict(network="m"), dict(channels=b"\x40"),
              dict(protocol_version=(9, 12, 0)), {}]
    for c in others:
        out = []
        for mod in (tni, jni):
            kw = dict(c)
            if "protocol_version" in kw:
                kw["protocol_version"] = mod.ProtocolVersion(
                    *kw["protocol_version"])
            try:
                mod.NodeInfo(**base).compatible_with(
                    mod.NodeInfo(**{**base, **kw}))
                out.append("ok")
            except mod.NodeInfoError as e:
                out.append(str(e))
        assert out[0] == out[1]


def test_mconnection_packets_equal_jax():
    rng = _rng(300)
    assert tconn._pack_ping() == jconn._pack_ping()
    assert tconn._pack_pong() == jconn._pack_pong()
    pkts = [tconn._pack_ping(), tconn._pack_pong()]
    for ch in (0x00, 0x20, 0x38, 0x40, 0xff):
        for eof in (False, True):
            for n in (0, 1, 1024):
                data = _bytes(rng, n)
                p = tconn._pack_msg(ch, eof, data)
                assert p == jconn._pack_msg(ch, eof, data)
                pkts.append(p)
        ctx = ("node-é", rng.randint(0, 10**9), rng.randint(0, 50),
               rng.randint(0, 2**40))
        p = tconn._pack_ctx(ch, ctx)
        assert p == jconn._pack_ctx(ch, ctx)
        pkts.append(p)
    for p in pkts:
        assert tconn._unpack_packet(p) == jconn._unpack_packet(p)
    for mod in (tconn, jconn):
        with pytest.raises(mod.MConnectionError, match="empty packet"):
            mod._unpack_packet(b"")


def test_parse_addr_equal_jax():
    for addr in ("ab12@10.0.0.1:26656", "tcp://1.2.3.4:80", ":7",
                 "id@tcp://127.0.0.1:1", "host:65535"):
        assert ttr.parse_addr(addr) == jtr.parse_addr(addr)


# -- SecretConnection interop ------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(SOCK_TIMEOUT_S)
    b.settimeout(SOCK_TIMEOUT_S)
    return a, b


def _both(fa, fb):
    """Run fa and fb in two threads; return their results (raising the
    first exception)."""
    out, errs = [None, None], []

    def run(i, f):
        try:
            out[i] = f()
        except Exception as e:                      # noqa: BLE001
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i, f))
          for i, f in enumerate((fa, fb))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(SOCK_TIMEOUT_S + 5)
    assert not any(t.is_alive() for t in ts), "handshake hung"
    if errs:
        raise errs[0]
    return out


class _FixedUrandom:
    """The port module's `os` with urandom returning one fixed value."""

    def __init__(self, value):
        self.value = value

    def urandom(self, n):
        return self.value[:n]


def _handshake(monkeypatch, role):
    assert taead.x25519_base(EPH[role])[0] == (0 if role == "lo" else 0xff)
    monkeypatch.setattr(tsc, "os", _FixedUrandom(EPH[role]))
    sa, sb = _pair()
    tk = ted.PrivKey.generate(_bytes(_rng(400), 32))
    jk = jed.PrivKey.generate(_bytes(_rng(401), 32))
    pc, jc = _both(lambda: tsc.SecretConnection.make(sa, tk),
                   lambda: jsc.SecretConnection.make(sb, jk))
    return pc, jc, tk, jk


@pytest.mark.parametrize("role", ["lo", "hi"])
def test_secret_connection_interop(monkeypatch, role):
    """A port SecretConnection against a JAX one: each authenticates the
    other's key, and data of one frame and of several crosses both
    ways."""
    pc, jc, tk, jk = _handshake(monkeypatch, role)
    try:
        assert pc.remote_pubkey.bytes() == jk.pub_key().bytes()
        assert jc.remote_pubkey.bytes() == tk.pub_key().bytes()
        big = _bytes(_rng(402), 5000)
        for w, r in ((pc, jc), (jc, pc)):
            w.write(b"hello")
            assert r.read() == b"hello"
            w.write(big)
            got = b""
            while len(got) < len(big):
                chunk = r.read()
                assert chunk
                got += chunk
            assert got == big
    finally:
        pc.close()
        jc.close()


class _Tamper:
    """A socket that flips one bit of the n-th sendall's data."""

    def __init__(self, sock, n):
        self.sock, self.n, self.sent = sock, n, 0

    def sendall(self, data):
        self.sent += 1
        if self.sent == self.n:
            data = bytes([data[0] ^ 1]) + data[1:]
        return self.sock.sendall(data)

    def recv(self, n):
        return self.sock.recv(n)

    def shutdown(self, how):
        self.sock.shutdown(how)

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_secret_connection_tampered_frame_detected(monkeypatch, sender):
    """After the handshake, one bit flipped in a sealed frame: the
    receiver's read raises its package's SecretConnectionError."""
    monkeypatch.setattr(tsc, "os", _FixedUrandom(EPH["lo"]))
    sa, sb = _pair()
    tk = ted.PrivKey.generate(_bytes(_rng(403), 32))
    jk = jed.PrivKey.generate(_bytes(_rng(404), 32))
    # sendall 1: the ephemeral key, 2: the auth frame, 3: the tampered
    wa = _Tamper(sa, 3) if sender == "port" else sa
    wb = _Tamper(sb, 3) if sender == "jax" else sb
    pc, jc = _both(lambda: tsc.SecretConnection.make(wa, tk),
                   lambda: jsc.SecretConnection.make(wb, jk))
    try:
        w, r, err = ((pc, jc, jsc.SecretConnectionError) if sender == "port"
                     else (jc, pc, tsc.SecretConnectionError))
        w.write(b"first")
        with pytest.raises(err, match="frame decryption failed"):
            r.read()
    finally:
        pc.close()
        jc.close()


def test_secret_connection_tampered_handshake_fails():
    sa, sb = _pair()
    tk = ted.PrivKey.generate(_bytes(_rng(405), 32))
    jk = jed.PrivKey.generate(_bytes(_rng(406), 32))
    with pytest.raises(Exception):
        _both(lambda: tsc.SecretConnection.make(_Tamper(sa, 2), tk),
              lambda: jsc.SecretConnection.make(sb, jk))
    sa.close()
    sb.close()


# -- MConnection interop -------------------------------------------------------------

@pytest.mark.parametrize("role", ["lo", "hi"])
def test_mconnection_interop(monkeypatch, role):
    """A port MConnection over a port SecretConnection exchanges channel
    messages with a JAX MConnection over a JAX one: short, multi-packet
    and trace-context messages both ways, on two channels."""
    pc, jc, _, _ = _handshake(monkeypatch, role)
    t_got, j_got, errs = [], [], []
    tdescs = [tconn.ChannelDescriptor(0x20, priority=5,
                                      send_queue_capacity=10),
              tconn.ChannelDescriptor(0x30, priority=1,
                                      send_queue_capacity=10)]
    jdescs = [jconn.ChannelDescriptor(0x20, priority=5,
                                      send_queue_capacity=10),
              jconn.ChannelDescriptor(0x30, priority=1,
                                      send_queue_capacity=10)]
    tm = tconn.MConnection(pc, tdescs,
                           lambda ch, m, tctx=None: t_got.append(
                               (ch, m, tctx)), errs.append,
                           flush_throttle=0.001)
    jm = jconn.MConnection(jc, jdescs,
                           lambda ch, m, tctx=None: j_got.append(
                               (ch, m, tctx)), errs.append,
                           flush_throttle=0.001)
    tm.start()
    jm.start()
    try:
        big = _bytes(_rng(407), 10_240)
        msgs = [(0x20, b"vote", None), (0x30, big, None),
                (0x20, b"with-ctx", ("origin", 7, 1, 42)), (0x30, b"", None)]
        for ch, m, ctx in msgs:
            assert tm.send(ch, m, tctx=ctx)
            assert jm.send(ch, m, tctx=ctx)
        deadline = time.monotonic() + SOCK_TIMEOUT_S
        while (len(t_got) < 4 or len(j_got) < 4) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(t_got, key=repr) == sorted(msgs, key=repr)
        assert sorted(j_got, key=repr) == sorted(msgs, key=repr)
        assert not errs
        st = tm.status()
        assert st["send"]["bytes"] > len(big) and \
            st["recv"]["bytes"] > len(big)
    finally:
        tm.stop()
        jm.stop()
        for m in (tm, jm):
            for t in m._threads:
                t.join(5)


# -- transport and switch ----------------------------------------------------------

def _transport(mod, kmod, seed, network="net-1"):
    nk = kmod.NodeKey((ted if mod is ttr else jed).PrivKey.generate(seed * 32))
    info = (tni if mod is ttr else jni).NodeInfo(
        node_id=nk.id, network=network, channels=bytes([0x30]), moniker="t")
    return mod.MultiplexTransport(nk, info, handshake_timeout=SOCK_TIMEOUT_S), nk


@pytest.mark.parametrize("dialer", ["port", "jax"])
def test_transport_dials_the_other_package(dialer):
    """A port transport dials a JAX one listening on 127.0.0.1, and the
    other way: both sides upgrade and see each other's NodeInfo."""
    port, pk = _transport(ttr, tkey, b"\x31")
    jax, jk = _transport(jtr, jkey, b"\x32")
    dial, listen = (port, jax) if dialer == "port" else (jax, port)
    lk = jk if dialer == "port" else pk
    accepted = []
    bound = listen.listen("127.0.0.1:0",
                          lambda conn, info: accepted.append((conn, info)))
    conn = None
    try:
        conn, info = dial.dial(f"{lk.id}@{bound}")
        assert info.node_id == lk.id
        deadline = time.monotonic() + SOCK_TIMEOUT_S
        while not accepted and time.monotonic() < deadline:
            time.sleep(0.01)
        assert accepted[0][1].node_id == (pk if dialer == "port" else jk).id
        conn.write(b"over-tcp")
        assert accepted[0][0].read() == b"over-tcp"
    finally:
        if conn is not None:
            conn.close()
        for c, _ in accepted:
            c.close()
        listen.close()
        dial.close()


@pytest.mark.parametrize("case", ["wrong_id", "network"])
def test_transport_rejects_as_jax(case):
    """A dial pinning the wrong ID, and one to a node on another
    network, raise ErrRejected with the JAX package's message."""
    msgs = []
    for mod, kmod in ((ttr, tkey), (jtr, jkey)):
        listen, lk = _transport(mod, kmod, b"\x33")
        dial, _ = _transport(mod, kmod, b"\x34",
                             network="net-2" if case == "network"
                             else "net-1")
        bound = listen.listen("127.0.0.1:0", lambda c, i: c.close())
        target = ("ab" * 20 if case == "wrong_id" else lk.id) + "@" + bound
        try:
            with pytest.raises(mod.ErrRejected) as e:
                dial.dial(target)
            msgs.append(str(e.value))
        finally:
            listen.close()
            dial.close()
    assert msgs[0] == msgs[1]


class _Echo(Reactor):
    def __init__(self, tag, got):
        super().__init__(f"echo-{tag}")
        self.tag, self.got = tag, got
        self.removed = []

    def get_channels(self):
        return [tconn.ChannelDescriptor(0x30, priority=5)]

    def receive(self, envelope: Envelope):
        self.got.append((self.tag, bytes(envelope.message)))

    def remove_peer(self, peer, reason):
        self.removed.append((peer.id, reason))


def _wait(cond, what):
    deadline = time.monotonic() + SOCK_TIMEOUT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_switch_end_to_end_and_eviction():
    """Two port switches over 127.0.0.1: the dialled peer appears on
    both sides, send / broadcast reach the other reactor, a duplicate
    dial is refused, and a dropped connection evicts the peer on the
    other side, telling its reactor."""
    got = []
    ta, ka = _transport(ttr, tkey, b"\x41")
    tb, kb = _transport(ttr, tkey, b"\x42")
    sa, sb = Switch(ta, listen_addr="127.0.0.1:0"), Switch(tb)
    sa.metrics = tmetrics.P2PMetrics(tmetrics.Registry())
    ra, rb = _Echo("a", got), _Echo("b", got)
    sa.add_reactor("echo", ra)
    sb.add_reactor("echo", rb)
    sa.start()
    sb.start()
    try:
        with pytest.raises(Exception, match="already registered"):
            sa.add_reactor("again", _Echo("c", got))
        peer = sb.dial_peer(f"{ka.id}@{sa.bound_addr}")
        assert peer.id == ka.id and peer.outbound
        _wait(lambda: sa.peers.size() == 1, "the inbound peer")
        assert sa.peers.list()[0].id == kb.id
        assert sa.num_peers() == {"outbound": 0, "inbound": 1, "dialing": 0}
        assert peer.send(0x30, b"from-b")
        assert sa.peers.list()[0].send(0x30, b"from-a")
        sb.broadcast(0x30, b"bcast")
        _wait(lambda: len(got) == 3, "three messages")
        assert sorted(got) == [("a", b"bcast"), ("a", b"from-b"),
                               ("b", b"from-a")]
        # framed bytes by channel: prefix + packet, both directions
        sent = sa.metrics.message_send_bytes_total._values
        recv = sa.metrics.message_receive_bytes_total._values
        assert sent[("0x30",)] > len(b"from-a") and \
            recv[("0x30",)] > len(b"from-b") + len(b"bcast")
        assert sa.metrics.peers._values[()] == 1
        with pytest.raises(Exception, match="already connected"):
            sb.dial_peer(f"{ka.id}@{sa.bound_addr}")
        peer.mconn._conn.close()
        _wait(lambda: sa.peers.size() == 0, "the eviction")
        assert [pid for pid, _ in ra.removed] == [kb.id]
        assert isinstance(ra.removed[0][1], Exception)
    finally:
        sa.stop()
        sb.stop()
