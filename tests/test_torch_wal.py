"""The port's consensus WAL (consensus/wal.py over libs/autofile.Group and
libs/crc32c.py) against the JAX package's, byte for byte on the CPU.

CRC-32C over random inputs from a numpy seed; one record of every WAL
message kind (EventRoundState, MsgInfo carrying every consensus message,
TimeoutInfo, EndHeightMessage); a WAL written by either package read
back by the other; the same repair of a torn tail and the same
DataCorruptionError and repair of mid-log corruption; the same chunk
files after Group rotation and the total-size bound.  The wall clock a
record carries is pinned (Timestamp.now patched in both packages)."""

import gc
import os
import types

import numpy as np
import pytest
import torch

from cometbft_tpu.consensus import messages as jmsgs
from cometbft_tpu.consensus import wal as jwal
from cometbft_tpu.libs import autofile as jaf
from cometbft_tpu.libs import bits as jbits
from cometbft_tpu.libs import crc32c as jcrc
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import part_set as jps
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import vote as jvote
from cometbft_tpu_torch.consensus import messages as tmsgs
from cometbft_tpu_torch.consensus import wal as twal
from cometbft_tpu_torch.libs import autofile as taf
from cometbft_tpu_torch.libs import bits as tbits
from cometbft_tpu_torch.libs import crc32c as tcrc
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import part_set as tps
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import vote as tvote

JAX = types.SimpleNamespace(msgs=jmsgs, wal=jwal, af=jaf, bits=jbits,
                            block=jblock, ps=jps, ts=jts, vote=jvote)
PORT = types.SimpleNamespace(msgs=tmsgs, wal=twal, af=taf, bits=tbits,
                             block=tblock, ps=tps, ts=tts, vote=tvote)
SIDES = (JAX, PORT)
SEED = 20261020
NOW = (1_700_000_123, 456_789)


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
def _pinned_clock(monkeypatch):
    for ns in SIDES:
        cls = ns.ts.Timestamp
        monkeypatch.setattr(cls, "now", staticmethod(lambda c=cls: c(*NOW)))


def consensus_messages(ns):
    """One of every consensus message (tests/test_consensus.py's
    TestMessagesWire cases, with a vote extension and a nil block ID)."""
    m, b = ns.msgs, ns.block
    bid = b.BlockID(b"\x01" * 32, b.PartSetHeader(2, b"\x02" * 32))
    ba = ns.bits.BitArray.from_bools([1, 0, 1, 1, 0, 0, 0, 1, 1])
    parts = ns.ps.PartSet.from_data(bytes(range(256)) * 2, 100)
    ts = ns.ts.Timestamp(9, 1)
    return [
        m.NewRoundStepMessage(5, 1, 3, 10, 0),
        m.NewRoundStepMessage(1, 0, 1, 0, -1),
        m.NewValidBlockMessage(5, 1, bid.part_set_header, ba, True),
        m.ProposalMessage(ns.vote.Proposal(
            height=5, round=1, pol_round=-1, block_id=bid, timestamp=ts,
            signature=b"s" * 64)),
        m.ProposalMessage(ns.vote.Proposal(
            height=7, round=3, pol_round=2, block_id=bid, timestamp=ts,
            signature=b"t" * 64)),
        m.ProposalPOLMessage(5, 0, ba),
        m.BlockPartMessage(5, 1, parts.get_part(0)),
        m.BlockPartMessage(5, 1, parts.get_part(parts.header.total - 1)),
        m.VoteMessage(ns.vote.Vote(
            type=ns.vote.PRECOMMIT_TYPE, height=5, round=2, block_id=bid,
            timestamp=ts, validator_address=b"a" * 20, validator_index=2,
            signature=b"s" * 64, extension=b"ext",
            extension_signature=b"e" * 64)),
        m.VoteMessage(ns.vote.Vote(
            type=ns.vote.PREVOTE_TYPE, height=5, round=0,
            block_id=b.BlockID(), timestamp=ts,
            validator_address=b"b" * 20, validator_index=0,
            signature=b"n" * 64)),
        m.HasVoteMessage(5, 1, 1, 2),
        m.VoteSetMaj23Message(5, 1, 2, bid),
        m.VoteSetBitsMessage(5, 1, 2, bid, ba),
        m.HasProposalBlockPartMessage(5, 1, 0),
    ]


def wal_messages(ns):
    w = ns.wal
    out = [w.EventRoundState(height=1, round=0, step="RoundStepNewHeight"),
           w.TimeoutInfo(duration_ns=80_000_000, height=1, round=0, step=3),
           w.TimeoutInfo(duration_ns=0, height=2, round=4, step=1)]
    for i, cm in enumerate(consensus_messages(ns)):
        out.append(w.MsgInfo(peer_id="" if i % 2 else f"peer{i}",
                             msg_bytes=ns.msgs.wrap_message(cm)))
    out += [w.EndHeightMessage(1), w.EndHeightMessage(0),
            w.EventRoundState(height=2, round=1, step="RoundStepPropose"),
            w.EndHeightMessage(2)]
    return out


def _record(ns, msg, ts=NOW):
    rec = ns.wal.TimedWALMessage(ns.ts.Timestamp(*ts), msg)
    return ns.wal._encode_record(rec.to_proto())


# -- crc32c ----------------------------------------------------------------------

def test_crc32c_random_inputs():
    rng = np.random.default_rng(SEED)
    assert tcrc.crc32c(b"123456789") == jcrc.crc32c(b"123456789") \
        == 0xE3069283
    for n in list(range(0, 40)) + [255, 256, 1000, 4099]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        init = int(rng.integers(0, 2**32))
        assert tcrc.crc32c(data) == jcrc.crc32c(data)
        assert tcrc.crc32c(data, init) == jcrc.crc32c(data, init)
        half = n // 2
        assert tcrc.crc32c(data[half:], tcrc.crc32c(data[:half])) == \
            jcrc.crc32c(data)


# -- records -----------------------------------------------------------------

def test_every_message_kind_encodes_byte_equal():
    jm, tm = wal_messages(JAX), wal_messages(PORT)
    assert len(jm) == len(tm) == 21
    kinds = set()
    for j, t in zip(jm, tm):
        kinds.add(type(t).__name__)
        rj, rt = _record(JAX, j), _record(PORT, t)
        assert rt == rj
        # each package decodes the other's record to the same message
        back_t = list(twal.decode_records(rj))[0]
        back_j = list(jwal.decode_records(rt))[0]
        assert _record(PORT, back_t.msg) == _record(JAX, back_j.msg) == rj
        assert (back_t.time.seconds, back_t.time.nanos) == NOW
    assert kinds == {"EventRoundState", "MsgInfo", "TimeoutInfo",
                     "EndHeightMessage"}


def _write_wal(ns, path, msgs, sync_every=3):
    w = ns.wal.WAL(str(path))
    for i, m in enumerate(msgs):
        if i % sync_every == 0:
            w.write_sync(m)
        else:
            w.write(m)
    w.flush_and_sync()
    w.close()


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def _replayed(ns, path):
    w = ns.wal.WAL(str(path))
    try:
        return [_record(ns, r.msg, (r.time.seconds, r.time.nanos))
                for r in w.replay()]
    finally:
        w.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_written_by_one_read_by_the_other(tmp_path, writer):
    src, dst = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    _write_wal(src, tmp_path / "a" / "wal", wal_messages(src))
    _write_wal(dst, tmp_path / "b" / "wal", wal_messages(dst))
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    want = [_record(src, m) for m in wal_messages(src)]
    assert _replayed(dst, tmp_path / "a" / "wal") == want
    assert _replayed(src, tmp_path / "a" / "wal") == want
    for h in (0, 1, 2, 7):
        res = []
        for ns in SIDES:
            w = ns.wal.WAL(str(tmp_path / "a" / "wal"))
            found, tail = w.search_for_end_height(h)
            res.append((found, [_record(ns, r.msg) for r in tail]))
            w.close()
        assert res[0] == res[1]
        assert res[0][0] == (h != 7)


# -- torn tail and mid-log corruption ---------------------------------------------

def _two_copies(tmp_path, msgs_of):
    for ns, d in ((JAX, "j"), (PORT, "t")):
        _write_wal(ns, tmp_path / d / "wal", msgs_of(ns))
    return tmp_path / "j" / "wal", tmp_path / "t" / "wal"


@pytest.mark.parametrize("cut", [1, 5, 8, 9, 40])
def test_torn_tail(tmp_path, cut):
    pj, pt = _two_copies(tmp_path, wal_messages)
    for p in (pj, pt):
        data = p.read_bytes()
        p.write_bytes(data[:len(data) - cut])
    # decoding stops quietly at the torn record, in both packages
    got = [[_record(ns, r.msg) for r in ns.wal.decode_records(p.read_bytes())]
           for ns, p in ((JAX, pj), (PORT, pt))]
    last = len(_record(JAX, wal_messages(JAX)[-1]))
    kept = 20 if cut <= last else 19
    assert got[0] == got[1] and len(got[0]) == kept
    for ns, p in ((JAX, pj), (PORT, pt)):
        with pytest.raises(ns.wal.DataCorruptionError):
            list(ns.wal.decode_records(p.read_bytes(),
                                       tolerate_torn_tail=False))
    # reopening truncates the torn tail; new records append after it
    for ns, p in ((JAX, pj), (PORT, pt)):
        w = ns.wal.WAL(str(p))
        w.write_sync(ns.wal.EndHeightMessage(9))
        w.close()
    assert pj.read_bytes() == pt.read_bytes()
    assert len(_replayed(PORT, pj)) == len(_replayed(JAX, pt)) == kept + 1


@pytest.mark.parametrize("flip", [3, 60, 300])
def test_mid_log_corruption(tmp_path, flip):
    pj, pt = _two_copies(tmp_path, wal_messages)
    for p in (pj, pt):
        data = bytearray(p.read_bytes())
        data[flip] ^= 0x40
        p.write_bytes(bytes(data))
    errs, repaired = [], []
    for ns, p in ((JAX, pj), (PORT, pt)):
        # opening truncates at the corrupt record, as CometBFT's repair
        # of a head file does; reading the raw bytes raises first
        with pytest.raises(ns.wal.DataCorruptionError) as ei:
            list(ns.wal.decode_records(p.read_bytes()))
        errs.append(str(ei.value))
        w = ns.wal.WAL(str(p))
        repaired.append((w.repair(), [_record(ns, r.msg)
                                      for r in w.replay()]))
        w.close()
    assert errs[0] == errs[1]
    assert repaired[0] == repaired[1]
    assert pj.read_bytes() == pt.read_bytes()
    assert _files(pj.parent) == _files(pt.parent)


def test_repair_moves_later_chunks_aside(tmp_path):
    """Corruption in a rolled chunk: repair truncates it and moves every
    later chunk aside, the same files in both packages."""
    out = []
    for ns, d in ((JAX, "j"), (PORT, "t")):
        p = tmp_path / d / "wal"
        w = ns.wal.WAL(str(p), head_size_limit=300)
        for m in wal_messages(ns):
            w.write(m)
            w.flush_and_sync()
            w.maybe_rotate()
        w.close()
        first = sorted(f for f in os.listdir(p.parent) if f != "wal")[0]
        data = bytearray((p.parent / first).read_bytes())
        data[20] ^= 1
        (p.parent / first).write_bytes(bytes(data))
        w = ns.wal.WAL(str(p), head_size_limit=300)
        changed = w.repair()
        w.write_sync(ns.wal.EndHeightMessage(5))
        w.close()
        out.append((changed, _files(p.parent)))
    assert out[0] == out[1]
    assert out[0][0] and any(f.endswith(".corrupt") for f in out[0][1])


# -- Group rotation ----------------------------------------------------------------

@pytest.mark.parametrize("head,total", [(256, 1 << 20), (200, 900)])
def test_group_rotation_same_chunks(tmp_path, head, total):
    rng = np.random.default_rng(SEED + head)
    blobs = [rng.integers(0, 256, int(rng.integers(1, 120)),
                          dtype=np.uint8).tobytes() for _ in range(60)]
    seen = []
    for ns, d in ((JAX, "j"), (PORT, "t")):
        path = tmp_path / d / "g"
        g = ns.af.Group(str(path), head_size_limit=head,
                        total_size_limit=total)
        for b in blobs:
            g.write(b)
            g.flush()
            g.maybe_rotate()
        g.flush_and_sync()
        seen.append((g.min_index(), g.max_index(),
                     [os.path.basename(c) for c in g.chunk_paths()],
                     g.read_all()))
        g.close()
        # reopening finds the same chunks
        g = ns.af.Group(str(path), head_size_limit=head,
                        total_size_limit=total)
        assert (g.min_index(), g.max_index()) == seen[-1][:2]
        g.rotate_file()
        g.close()
    assert seen[0] == seen[1]
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    assert seen[0][1] > 3
    if total < 1 << 20:
        assert seen[0][0] > 0          # the oldest chunks were dropped
