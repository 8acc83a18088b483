"""The port's vote path types against the JAX package on the CPU: each
case of tests/test_vote_set.py and the BitArray cases of
tests/test_libs.py run on both packages with the same seeded keys and
compared; the sign bytes (vote, extension, proposal) and the proto bytes
of Vote, Proposal, Commit, ExtendedCommit, BitArray and
DuplicateVoteEvidence byte for byte, with round trips through
from_proto; the protobuf reader and Timestamp's new half; and the slice
as a whole at 7 validators: a round's prevotes and precommits through
each package's vote stream and VoteSet, one tampered vote and one
equivocation, with the same verdicts, errors, commit bytes, bit arrays
and evidence.  The port's stream sends its windows through the plain
K1-K4 / K14 (device="cpu"); the JAX stream verifies on its host path."""

import dataclasses
import gc
import threading
import types

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import sigcache as jsigcache
from cometbft_tpu.crypto import votestream as jstream
from cometbft_tpu.evidence import verify as jevverify
from cometbft_tpu.libs import bits as jbits
from cometbft_tpu.libs import protowire as jpw
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import evidence as jevidence
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validator_set as jvset
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.types import vote_set as jvs
from cometbft_tpu_torch.crypto import dispatch as vd
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto import votestream as tstream
from cometbft_tpu_torch.evidence import verify as tevverify
from cometbft_tpu_torch.libs import bits as tbits
from cometbft_tpu_torch.libs import lockrank as plr
from cometbft_tpu_torch.libs import protowire as tpw
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import canonical as tcanon
from cometbft_tpu_torch.types import evidence as tevidence
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types import validator_set as tvset
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.types import vote_set as tvs

CHAIN = "test-chain"
CPU = "cpu"

JAX = types.SimpleNamespace(
    name="jax", ed=jed, bits=jbits, block=jblock, canon=jcanon,
    evidence=jevidence, evverify=jevverify, ts=jts, vset=jvset,
    vote=jvote, vs=jvs, stream=jstream,
    verify_commit=lambda vals, bid, h, c: vals.verify_commit(
        CHAIN, bid, h, c))
PORT = types.SimpleNamespace(
    name="port", ed=ted, bits=tbits, block=tblock, canon=tcanon,
    evidence=tevidence, evverify=tevverify, ts=tts, vset=tvset,
    vote=tvote, vs=tvs, stream=tstream,
    verify_commit=lambda vals, bid, h, c: tval.verify_commit(
        CHAIN, vals, bid, h, c, device=CPU))
SIDES = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _frozen_heap():
    """After each test's own objects are collected, the heap is frozen
    for the next: the per-test gc.collect() of the leak checks walks only
    what one test made.  Unfrozen at the module's end."""
    yield
    gc.unfreeze()


@pytest.fixture(autouse=True)
def _freeze_heap():
    gc.freeze()


@pytest.fixture(autouse=True)
def _caches():
    """Both packages' verdict caches empty and in their default state
    around each case; the port's lock ranks in raise mode."""
    plr.enable("raise")
    baseline = set(threading.enumerate())
    sigcache.reset()
    sigcache.set_enabled(None)
    jsigcache.reset()
    jsigcache.set_enabled(None)
    yield
    sigcache.reset()
    sigcache.set_enabled(None)
    assert plr.violations() == []
    plr.disable()
    assert plr.leaked_threads(baseline, grace_s=1.0) == []


# -- the JAX package's fixtures (tests/test_vote_set.py), on either side -----

def make_valset(side, n, power=10):
    privs = [side.ed.PrivKey.generate(bytes([i + 1]) * 32) for i in range(n)]
    vals = side.vset.ValidatorSet(
        [side.vset.Validator(p.pub_key(), power) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    return vals, [by_addr[v.address] for v in vals.validators]


def block_id(side, seed=1):
    return side.block.BlockID(bytes([seed]) * 32, side.block.PartSetHeader(
        1, bytes([seed + 1]) * 32))


def signed_vote(side, priv, idx, vote_type, height, round_, bid, ts=None,
                ext=b""):
    v = side.vote.Vote(type=vote_type, height=height, round=round_,
                       block_id=bid, timestamp=ts or side.ts.Timestamp(1, 0),
                       validator_address=priv.pub_key().address(),
                       validator_index=idx, extension=ext)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    if ext and vote_type == side.vote.PRECOMMIT_TYPE and not bid.is_nil():
        v.extension_signature = priv.sign(v.extension_sign_bytes(CHAIN))
    return v


def both(case):
    """Run `case` on both packages; their records must be equal."""
    got = [case(side) for side in SIDES]
    assert got[0] == got[1]
    return got[1]


def outcome(fn):
    """("ok", value) or (error class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:              # noqa: BLE001
        return (type(e).__name__, str(e))


# -- tests/test_vote_set.py, case by case --------------------------------------

def test_majority_at_two_thirds_plus_one():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        bid = block_id(s)
        seen = []
        for i in range(2):
            seen.append(vs.add_vote(signed_vote(
                s, privs[i], i, s.vote.PREVOTE_TYPE, 1, 0, bid)))
            seen.append(vs.has_two_thirds_majority())
        seen.append(vs.add_vote(signed_vote(
            s, privs[2], 2, s.vote.PREVOTE_TYPE, 1, 0, bid)))
        got, ok = vs.two_thirds_majority()
        return seen, ok, got.to_proto(), got == bid
    assert both(case) == ([True, False, True, False, True], True,
                          block_id(PORT).to_proto(), True)


def test_duplicate_returns_false():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        v = signed_vote(s, privs[0], 0, s.vote.PREVOTE_TYPE, 1, 0,
                        block_id(s))
        return vs.add_vote(v), vs.add_vote(v)
    assert both(case) == (True, False)


def test_wrong_step_rejected():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        return [outcome(lambda: vs.add_vote(signed_vote(
                    s, privs[0], 0, t, h, 0, block_id(s))))
                for t, h in ((s.vote.PREVOTE_TYPE, 2),
                             (s.vote.PRECOMMIT_TYPE, 1))]
    got = both(case)
    assert [g[0] for g in got] == ["ErrVoteUnexpectedStep"] * 2


def test_bad_signature_rejected():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        v = signed_vote(s, privs[0], 0, s.vote.PREVOTE_TYPE, 1, 0,
                        block_id(s))
        v.signature = bytes(64)
        return outcome(lambda: vs.add_vote(v))
    assert both(case) == ("ErrVoteInvalidSignature", "invalid signature")


def test_wrong_address_rejected():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        return outcome(lambda: vs.add_vote(signed_vote(
            s, privs[0], 1, s.vote.PREVOTE_TYPE, 1, 0, block_id(s))))
    assert both(case)[0] == "ErrVoteInvalidValidatorAddress"


def test_conflicting_vote_raises_and_is_dropped():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        first = vs.add_vote(signed_vote(s, privs[0], 0, s.vote.PREVOTE_TYPE,
                                        1, 0, block_id(s, 1)))
        err = outcome(lambda: vs.add_vote(signed_vote(
            s, privs[0], 0, s.vote.PREVOTE_TYPE, 1, 0, block_id(s, 3))))
        return first, err, vs.get_by_index(0).block_id.to_proto()
    first, err, kept = both(case)
    assert first and err[0] == "ErrVoteConflictingVotes"
    assert kept == block_id(PORT, 1).to_proto()


def test_conflict_tracked_after_peer_maj23():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        bid_a, bid_b = block_id(s, 1), block_id(s, 3)
        rec = [vs.add_vote(signed_vote(s, privs[0], 0, s.vote.PREVOTE_TYPE,
                                       1, 0, bid_a))]
        vs.set_peer_maj23("peer1", bid_b)
        rec.append(outcome(lambda: vs.add_vote(signed_vote(
            s, privs[0], 0, s.vote.PREVOTE_TYPE, 1, 0, bid_b)))[0])
        for i in (1, 2):
            rec.append(vs.add_vote(signed_vote(
                s, privs[i], i, s.vote.PREVOTE_TYPE, 1, 0, bid_b)))
        got, ok = vs.two_thirds_majority()
        return (rec, ok, got == bid_b, vs.get_by_index(0).block_id == bid_b,
                str(vs.bit_array()), str(vs.bit_array_by_block_id(bid_b)))
    rec, ok, maj_b, flipped, _, _ = both(case)
    assert rec == [True, "ErrVoteConflictingVotes", True, True]
    assert ok and maj_b and flipped


def test_make_commit():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PRECOMMIT_TYPE, vals)
        bid = block_id(s)
        nil_v = signed_vote(s, privs[3], 3, s.vote.PRECOMMIT_TYPE, 1, 0,
                            s.block.BlockID())
        added = [vs.add_vote(nil_v)]
        for i in range(3):
            added.append(vs.add_vote(signed_vote(
                s, privs[i], i, s.vote.PRECOMMIT_TYPE, 1, 0, bid)))
        commit = vs.make_commit()
        s.verify_commit(vals, bid, 1, commit)
        return (added, commit.height, commit.block_id == bid,
                [x.block_id_flag for x in commit.signatures],
                commit.to_proto(), commit.hash())
    added, height, same, flags, _, _ = both(case)
    assert added == [True] * 4 and height == 1 and same
    assert flags == [jblock.BLOCK_ID_FLAG_COMMIT] * 3 + [
        jblock.BLOCK_ID_FLAG_NIL]


def test_commit_round_trips_through_vote_set():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 2, 1, s.vote.PRECOMMIT_TYPE, vals)
        bid = block_id(s)
        for i in range(3):
            vs.add_vote(signed_vote(s, privs[i], i, s.vote.PRECOMMIT_TYPE,
                                    2, 1, bid))
        commit = vs.make_commit()
        vs2 = s.vs.commit_to_vote_set(CHAIN, commit, vals)
        again = s.block.Commit.from_proto(commit.to_proto())
        return (vs2.has_two_thirds_majority(),
                vs2.make_commit().block_id == bid,
                vs2.make_commit().to_proto() == commit.to_proto(),
                again == commit)
    assert both(case) == (True, True, True, True)


def test_extended_commit():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PRECOMMIT_TYPE, vals,
                          extensions_enabled=True)
        bid = block_id(s)
        for i in range(4):
            vs.add_vote(signed_vote(s, privs[i], i, s.vote.PRECOMMIT_TYPE,
                                    1, 0, bid, ext=b"ext%d" % i))
        ec = vs.make_extended_commit(True)
        ec2 = s.block.ExtendedCommit.from_proto(ec.to_proto())
        vs2 = s.vs.extended_commit_to_vote_set(CHAIN, ec2, vals)
        return (all(x.extension_signature for x in ec.extended_signatures),
                ec2.block_id == bid, ec2.size(), ec2 == ec,
                vs2.has_two_thirds_majority(), ec.to_proto(),
                ec.to_commit().to_proto(), str(ec.bit_array()),
                outcome(lambda: ec.ensure_extensions(False)))
    got = both(case)
    assert got[:5] == (True, True, 4, True, True)
    assert got[8] == ("ValueError", "unexpected vote extension data")


def test_absent_validators_marked_absent():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PRECOMMIT_TYPE, vals)
        bid = block_id(s)
        for i in range(3):
            vs.add_vote(signed_vote(s, privs[i], i, s.vote.PRECOMMIT_TYPE,
                                    1, 0, bid))
        commit = vs.make_commit()
        return commit.signatures[3].block_id_flag, commit.to_proto()
    assert both(case)[0] == jblock.BLOCK_ID_FLAG_ABSENT


def test_two_thirds_any_vs_majority():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        for i, bid in enumerate((block_id(s, 1), block_id(s, 3),
                                 s.block.BlockID())):
            vs.add_vote(signed_vote(s, privs[i], i, s.vote.PREVOTE_TYPE, 1,
                                    0, bid))
        return vs.has_two_thirds_any(), vs.has_two_thirds_majority()
    assert both(case) == (True, False)


def test_bit_arrays():
    def case(s):
        vals, privs = make_valset(s, 4)
        vs = s.vs.VoteSet(CHAIN, 1, 0, s.vote.PREVOTE_TYPE, vals)
        bid = block_id(s)
        vs.add_vote(signed_vote(s, privs[1], 1, s.vote.PREVOTE_TYPE, 1, 0,
                                bid))
        return (vs.bit_array().true_indices(),
                vs.bit_array_by_block_id(bid).true_indices(),
                vs.bit_array_by_block_id(block_id(s, 7)) is None,
                vs.bit_array().to_proto(), str(vs.bit_array()))
    assert both(case)[:3] == ([1], [1], True)


def test_vote_set_consumes_preverified():
    """tests/test_votestream.py's VoteSet consumption case: a verdict for
    another triple is ignored (inline verify accepts), a matching False
    rejects, and without the marker the vote is valid."""
    from concurrent.futures import Future

    def case(s):
        vals, privs = make_valset(s, 3)
        vs = s.vs.VoteSet(CHAIN, 5, 0, s.vote.PREVOTE_TYPE, vals)
        bid = block_id(s)
        vote = signed_vote(s, privs[0], 0, s.vote.PREVOTE_TYPE, 5, 0, bid)
        f = Future()
        f.set_result(False)
        vote.preverified = s.stream.Preverified(b"\x07" * 32, b"x", b"y", f)
        rec = [vs.add_vote(vote), vote.preverified is None]
        vote2 = signed_vote(s, privs[1], 1, s.vote.PREVOTE_TYPE, 5, 0, bid)
        f2 = Future()
        f2.set_result(False)
        vote2.preverified = s.stream.Preverified(
            vals.validators[1].pub_key.bytes(), vote2.sign_bytes(CHAIN),
            vote2.signature, f2)
        rec.append(outcome(lambda: vs.add_vote(vote2)))
        vote2.preverified = None
        rec.append(vs.add_vote(vote2))
        return rec
    assert both(case) == [True, True, ("ErrVoteInvalidSignature",
                                       "invalid signature"), True]


# -- tests/test_libs.py's BitArray cases -------------------------------------

def test_bit_array_set_get():
    def case(s):
        ba = s.bits.BitArray(10)
        return (ba.get_index(3), ba.set_index(3, True), ba.get_index(3),
                ba.set_index(10, True), ba.get_index(-1), str(ba))
    assert both(case)[:5] == (False, True, True, False, False)


def test_bit_array_ops():
    def case(s):
        ba = s.bits.BitArray.from_bools
        a, b = ba([1, 1, 0, 0]), ba([0, 1, 1, 0])
        return [str(x) for x in (a.or_(b), a.and_(b), a.sub(b), a.not_(),
                                 ba([1, 1, 1]).sub(ba([0, 1])))]
    assert both(case) == ["BA{4:xxx_}", "BA{4:_x__}", "BA{4:x___}",
                          "BA{4:__xx}", "BA{3:x_x}"]


def test_bit_array_pick_random_full_empty():
    def case(s):
        ba = s.bits.BitArray(8)
        rec = [ba.pick_random()[1]]
        ba.set_index(5, True)
        rec.append(ba.pick_random())
        three = s.bits.BitArray(3)
        rec += [s.bits.BitArray(0).is_full(), three.is_empty(),
                three.is_full()]
        for i in range(3):
            three.set_index(i, True)
        rec += [three.is_full(), three.is_empty(), three.num_true()]
        return rec
    assert both(case) == [False, (5, True), True, True, False, True, False,
                          3]


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 130, 10_000])
def test_bit_array_proto_bytes(n):
    """Proto bytes equal for every third bit set and for a seeded random
    pattern; each package decodes the other's bytes."""
    rng = np.random.default_rng(n)
    for pattern in ([i % 3 == 0 for i in range(n)],
                    list(rng.random(n) < 0.5)):
        jb = jbits.BitArray.from_bools(pattern)
        tb = tbits.BitArray.from_bools(pattern)
        assert tb.to_proto() == jb.to_proto()
        assert str(tb) == str(jb)
        assert tbits.BitArray.from_proto(jb.to_proto()) == tb
        assert jbits.BitArray.from_proto(tb.to_proto()) == jb
    bad = jpw.Writer().int_field(1, tbits.MAX_PROTO_BITS + 1).bytes()
    for mod in (jbits, tbits):
        with pytest.raises(ValueError, match="out of range"):
            mod.BitArray.from_proto(bad)


# -- sign bytes and proto bytes -------------------------------------------------

def _bids(side):
    return [side.block.BlockID(), block_id(side, 9),
            side.block.BlockID(b"\xaa" * 32, side.block.PartSetHeader(
                70000, b"\xbb" * 32))]


TIMES = [(0, 0), (1, 0), (1_700_000_000, 123_456_789), (-5, 999_999_999)]


def test_sign_bytes_equal():
    """Vote, extension and proposal sign bytes over heights, rounds
    (negative too), nil and complete BlockIDs and timestamps."""
    for (h, r) in ((1, 0), (7, 3), (1 << 40, -1)):
        for jb, tb in zip(_bids(JAX), _bids(PORT)):
            for sec, ns in TIMES:
                jt, tt = jts.Timestamp(sec, ns), tts.Timestamp(sec, ns)
                for typ in (1, 2):
                    assert tcanon.vote_sign_bytes(CHAIN, typ, h, r, tb, tt) \
                        == jcanon.vote_sign_bytes(CHAIN, typ, h, r, jb, jt)
                for pol in (-1, 0, 2):
                    assert tcanon.proposal_sign_bytes(
                        CHAIN, h, r, pol, tb, tt) == \
                        jcanon.proposal_sign_bytes(CHAIN, h, r, pol, jb, jt)
            for ext in (b"", b"e", b"\x00" * 300):
                assert tcanon.vote_extension_sign_bytes(CHAIN, h, r, ext) \
                    == jcanon.vote_extension_sign_bytes(CHAIN, h, r, ext)
    assert (tcanon.PREVOTE, tcanon.PRECOMMIT, tcanon.PROPOSAL) == (
        jcanon.PREVOTE, jcanon.PRECOMMIT, jcanon.PROPOSAL)


def _vote(side, **kw):
    base = dict(type=side.vote.PRECOMMIT_TYPE, height=12, round=2,
                block_id=block_id(side, 4),
                timestamp=side.ts.Timestamp(1_700_000_001, 42),
                validator_address=b"\x11" * 20, validator_index=3,
                signature=b"\x22" * 64, extension=b"ext",
                extension_signature=b"\x33" * 64)
    base.update(kw)
    return side.vote.Vote(**base)


VOTE_VARIANTS = [
    {}, {"type": 1, "extension": b"", "extension_signature": b""},
    {"validator_index": 0}, {"validator_index": -1}, {"round": -1},
    {"height": 0}, {"block_id": None}, {"validator_address": b"\x11" * 19},
    {"signature": b""}, {"signature": b"\x01" * 65}, {"type": 5},
    {"extension_signature": b""}, {"extension_signature": b"\x01" * 65},
    {"type": 1}, {"block_id": "incomplete"},
]


def _variant(side, kw):
    kw = dict(kw)
    if kw.get("block_id") is None and "block_id" in kw:
        kw["block_id"] = side.block.BlockID()
    elif kw.get("block_id") == "incomplete":
        kw["block_id"] = side.block.BlockID(b"\x01" * 31)
    return _vote(side, **kw)


@pytest.mark.parametrize("kw", VOTE_VARIANTS)
def test_vote_bytes_and_rules(kw):
    """One vote shape: sign bytes, extension sign bytes and proto bytes
    equal, both decoders agree on both encodings, and validate_basic
    gives the same verdict and message."""
    jv, tv = _variant(JAX, kw), _variant(PORT, kw)
    assert tv.sign_bytes(CHAIN) == jv.sign_bytes(CHAIN)
    assert tv.extension_sign_bytes(CHAIN) == jv.extension_sign_bytes(CHAIN)
    assert tv.to_proto() == jv.to_proto()
    back = tvote.Vote.from_proto(jv.to_proto())
    assert back.to_proto() == jv.to_proto()
    assert jvote.Vote.from_proto(tv.to_proto()).to_proto() == tv.to_proto()
    assert outcome(tv.validate_basic) == outcome(jv.validate_basic)
    assert tv.is_nil() == jv.is_nil()


@pytest.mark.parametrize("kw", [
    {}, {"pol_round": 0}, {"pol_round": 3}, {"pol_round": -2},
    {"round": -1}, {"height": 0}, {"type": 1}, {"signature": b""},
    {"signature": b"\x01" * 65}, {"block_id": "nil"}])
def test_proposal_bytes_and_rules(kw):
    def make(side):
        base = dict(height=9, round=2, pol_round=-1, block_id=block_id(
            side, 5), timestamp=side.ts.Timestamp(10, 20),
            signature=b"\x44" * 64)
        base.update(kw)
        if base["block_id"] == "nil":
            base["block_id"] = side.block.BlockID()
        return side.vote.Proposal(**base)
    jp, tp = make(JAX), make(PORT)
    assert tp.sign_bytes(CHAIN) == jp.sign_bytes(CHAIN)
    assert tp.to_proto() == jp.to_proto()
    assert tvote.Proposal.from_proto(jp.to_proto()) == tp
    assert outcome(tp.validate_basic) == outcome(jp.validate_basic)


def _commit_pair(n, ext):
    """The same commit (or extended commit) built on both sides from
    scalars: commit, nil and absent signatures in a seeded order."""
    rng = np.random.default_rng(n + 17 * ext)
    out = []
    flags = rng.integers(1, 4, n)
    for side in SIDES:
        sigs = []
        for i, f in enumerate(flags):
            if f == 1:
                sigs.append((side.block.ExtendedCommitSig if ext
                             else side.block.CommitSig)())
                continue
            kw = dict(block_id_flag=int(f),
                      validator_address=bytes([i % 251]) * 20,
                      timestamp=side.ts.Timestamp(1000 + i, 7 * i),
                      signature=bytes([i % 256]) * 64)
            if ext:
                if f == 2:
                    kw.update(extension=b"x%d" % i,
                              extension_signature=b"\x05" * 64)
                sigs.append(side.block.ExtendedCommitSig(**kw))
            else:
                sigs.append(side.block.CommitSig(**kw))
        cls = side.block.ExtendedCommit if ext else side.block.Commit
        out.append(cls(44, 1, block_id(side, 6), sigs))
    return out


@pytest.mark.parametrize("n", [1, 4, 150])
def test_commit_bytes(n):
    jc, tc = _commit_pair(n, False)
    assert tc.to_proto() == jc.to_proto()
    assert tc.hash() == jc.hash()
    assert tblock.Commit.from_proto(jc.to_proto()) == tc
    assert tc.vote_sign_bytes_all(CHAIN) == jc.vote_sign_bytes_all(CHAIN)
    assert outcome(tc.validate_basic) == outcome(jc.validate_basic)
    je, te = _commit_pair(n, True)
    assert te.to_proto() == je.to_proto()
    assert tblock.ExtendedCommit.from_proto(je.to_proto()) == te
    assert te.to_commit().to_proto() == je.to_commit().to_proto()
    assert str(te.bit_array()) == str(je.bit_array())
    for flag in (False, True):
        assert outcome(lambda: te.ensure_extensions(flag)) == outcome(
            lambda: je.ensure_extensions(flag))
    assert outcome(te.validate_basic) == outcome(je.validate_basic)
    jb, tb = block_id(JAX, 6), block_id(PORT, 6)
    assert tb.key() == jb.key() and tb.to_proto() == jb.to_proto()
    assert tblock.BlockID.from_proto(jb.to_proto()) == tb
    assert tb.is_complete() == jb.is_complete()


def test_duplicate_vote_evidence_bytes():
    """DuplicateVoteEvidence.new orders the votes by BlockID key; proto
    bytes, hash, the wrapped oneof codec and validate_basic agree."""
    recs = []
    for side in SIDES:
        vals, privs = make_valset(side, 4)
        a = signed_vote(side, privs[2], 2, side.vote.PREVOTE_TYPE, 8, 1,
                        block_id(side, 9))
        b = signed_vote(side, privs[2], 2, side.vote.PREVOTE_TYPE, 8, 1,
                        block_id(side, 3))
        ev = side.evidence.DuplicateVoteEvidence.new(
            a, b, side.ts.Timestamp(77, 5), vals)
        wrapped = side.evidence.evidence_to_proto_wrapped(ev)
        back = side.evidence.evidence_from_proto_wrapped(wrapped)
        side.evverify.verify_duplicate_vote(ev, CHAIN, vals)
        ev.verify(CHAIN, vals.validators[2].pub_key)
        recs.append((ev.to_proto(), ev.hash(), wrapped, back.to_proto(),
                     ev.vote_a.block_id.key() < ev.vote_b.block_id.key(),
                     ev.height(), ev.total_voting_power, ev.validator_power,
                     outcome(ev.validate_basic)))
        swapped = side.evidence.DuplicateVoteEvidence(
            ev.vote_b, ev.vote_a, ev.total_voting_power, ev.validator_power,
            ev.timestamp)
        recs.append(outcome(swapped.validate_basic))
        recs.append(outcome(lambda: side.evverify.verify_duplicate_vote(
            swapped, CHAIN, vals)))
    assert recs[:3] == recs[3:]
    assert recs[0][4] and recs[0][8] == ("ok", None)
    assert tevidence.DuplicateVoteEvidence.from_proto(recs[0][0]) \
        .to_proto() == recs[0][0]


@pytest.mark.parametrize("fault", ["power", "total", "same_block", "height",
                                   "stranger", "bad_sig_a", "bad_sig_b"])
def test_verify_duplicate_vote_rejects(fault):
    def case(s):
        vals, privs = make_valset(s, 4)
        a = signed_vote(s, privs[0], 0, s.vote.PRECOMMIT_TYPE, 3, 0,
                        block_id(s, 1))
        b = signed_vote(s, privs[0], 0, s.vote.PRECOMMIT_TYPE, 3, 0,
                        block_id(s, 3))
        ev = s.evidence.DuplicateVoteEvidence.new(a, b, s.ts.Timestamp(1, 0),
                                                  vals)
        if fault == "power":
            ev.validator_power += 1
        elif fault == "total":
            ev.total_voting_power += 1
        elif fault == "same_block":
            ev.vote_b = ev.vote_a
        elif fault == "height":
            ev.vote_b = dataclasses.replace(ev.vote_b, height=4)
        elif fault == "stranger":
            ev.vote_a = dataclasses.replace(
                ev.vote_a, validator_address=b"\x09" * 20)
        elif fault == "bad_sig_a":
            ev.vote_a = dataclasses.replace(ev.vote_a, signature=bytes(64))
        else:
            ev.vote_b = dataclasses.replace(ev.vote_b, signature=bytes(64))
        return outcome(lambda: s.evverify.verify_duplicate_vote(
            ev, CHAIN, vals))
    got = both(case)
    assert got[0] == "EvidenceVerificationError"


# -- the protobuf reader and Timestamp -----------------------------------------

@pytest.mark.parametrize("buf", [
    b"", b"\x80", b"\x01", b"\xff" * 9 + b"\x01", b"\xff" * 10 + b"\x01",
    b"\xff" * 9 + b"\x02", b"\x96\x01", b"\x05hello", b"\x05hel",
    b"\x08\x96\x01\x12\x03abc\x19" + b"\x01" * 8 + b"\x25" + b"\x02" * 4,
    b"\x0b", b"\x19\x01"])
def test_protowire_reader(buf):
    """decode_uvarint, (try_)unmarshal_delimited and a Reader walk give
    the JAX package's values and errors on well-formed, truncated and
    overlong input."""
    assert outcome(lambda: tpw.decode_uvarint(buf)) == outcome(
        lambda: jpw.decode_uvarint(buf))
    assert outcome(lambda: tpw.unmarshal_delimited(buf)) == outcome(
        lambda: jpw.unmarshal_delimited(buf))
    assert outcome(lambda: tpw.try_unmarshal_delimited(buf, max_frame=4)) \
        == outcome(lambda: jpw.try_unmarshal_delimited(buf, max_frame=4))

    def walk(pw):
        r, out = pw.Reader(buf), []
        while not r.at_end():
            f, w = r.read_tag()
            if w == pw.BYTES:
                out.append((f, r.read_bytes()))
            elif w == pw.VARINT:
                out.append((f, r.read_int()))
            else:
                r.skip(w)
                out.append((f, w))
        return out
    assert outcome(lambda: walk(tpw)) == outcome(lambda: walk(jpw))
    assert tpw.sint_from_uvarint(2**64 - 3) == jpw.sint_from_uvarint(
        2**64 - 3) == -3


@pytest.mark.parametrize("sec,ns", TIMES + [(253402300799, 1)])
def test_timestamp_proto(sec, ns):
    jt, tt = jts.Timestamp(sec, ns), tts.Timestamp(sec, ns)
    assert tts.Timestamp.from_proto(jt.to_proto()) == tt
    assert tt.rfc3339() == jt.rfc3339()
    other_j, other_t = jts.Timestamp(3, 5), tts.Timestamp(3, 5)
    assert tt.diff_ns(other_t) == jt.diff_ns(other_j)
    assert tpw.decode_timestamp(jt.to_proto()) == jpw.decode_timestamp(
        jt.to_proto())


# -- the slice as a whole --------------------------------------------------------

N_SLICE = 7
SLICE_H = 21


def _round(side, stream):
    """One round at 7 validators as a consensus reactor runs it: every
    vote submitted to the stream, the Preverified attached, then
    VoteSet.add_vote.  One precommit is tampered; validator 4 also signs
    a second prevote for another block, and the conflict becomes
    duplicate-vote evidence."""
    vals, privs = make_valset(side, N_SLICE)
    bid, other = block_id(side, 30), block_id(side, 31)
    votes = []
    for t in (side.vote.PREVOTE_TYPE, side.vote.PRECOMMIT_TYPE):
        for i, p in enumerate(privs):
            ts = side.ts.Timestamp(1_700_000_000 + i, 1000 * i + 7)
            votes.append(signed_vote(side, p, i, t, SLICE_H, 0, bid, ts=ts))
    bad = N_SLICE + 2
    sig = votes[bad].signature
    votes[bad].signature = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
    twin = signed_vote(side, privs[4], 4, side.vote.PREVOTE_TYPE, SLICE_H, 0,
                       other, ts=side.ts.Timestamp(1_700_000_050, 3))
    votes.append(twin)
    futs = []
    for v in votes:
        pk = vals.validators[v.validator_index].pub_key.bytes()
        sb = v.sign_bytes(CHAIN)
        f = stream.submit(pk, sb, v.signature)
        v.preverified = side.stream.Preverified(pk, sb, v.signature, f)
        futs.append(f)
    verdicts = [f.result(timeout=120) for f in futs]
    sets = {t: side.vs.VoteSet(CHAIN, SLICE_H, 0, t, vals)
            for t in (side.vote.PREVOTE_TYPE, side.vote.PRECOMMIT_TYPE)}
    added, evidence = [], None
    for v in votes:
        try:
            added.append(("ok", sets[v.type].add_vote(v)))
        except side.vs.VoteSetError as e:
            added.append((type(e).__name__, str(e)))
            if isinstance(e, side.vs.ErrVoteConflictingVotes):
                evidence = side.evidence.DuplicateVoteEvidence.new(
                    e.vote_a, e.vote_b, side.ts.Timestamp(1_700_000_100, 0),
                    vals)
    side.evverify.verify_duplicate_vote(evidence, CHAIN, vals)
    pre, com = sets[side.vote.PREVOTE_TYPE], sets[side.vote.PRECOMMIT_TYPE]
    commit = com.make_commit()
    side.verify_commit(vals, bid, SLICE_H, commit)
    return {"verdicts": verdicts, "added": added,
            "commit": commit.to_proto(), "commit_hash": commit.hash(),
            "bits": [str(pre.bit_array()), str(com.bit_array()),
                     str(com.bit_array_by_block_id(bid))],
            "evidence": evidence.to_proto(), "evidence_hash": evidence.hash(),
            "maj23": [pre.has_two_thirds_majority(),
                      com.has_two_thirds_majority()]}


def test_slice_round_against_jax():
    jsv = jstream.StreamingVerifier(flush_interval=0.05, warmup=False)
    jsv.start()
    try:
        want = _round(JAX, jsv)
    finally:
        jsv.stop()
    sigcache.set_enabled(False)        # every vote reaches the window
    with vd.VerifyPipeline(device=CPU, host_workers=1) as pipe:
        tsv = tstream.StreamingVerifier(flush_interval=0.2,
                                        device_threshold=2, pipeline=pipe,
                                        device=CPU)
        tsv.start()
        try:
            got = _round(PORT, tsv)
        finally:
            tsv.stop()
    assert got == want
    bad = N_SLICE + 2
    assert got["verdicts"] == [i != bad for i in range(2 * N_SLICE + 1)]
    assert got["added"][bad] == ("ErrVoteInvalidSignature",
                                 "invalid signature")
    assert got["added"][-1][0] == "ErrVoteConflictingVotes"
    assert got["maj23"] == [True, True]
    assert tsv.path_votes["device"] == tsv.verified and \
        tsv.path_votes["host"] == 0
    assert set(tsv.window_paths) == {"device"}
