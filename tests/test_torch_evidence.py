"""The port's evidence verification and pool (evidence/verify.py,
evidence/pool.py) against the JAX package's, on the CPU.

Both packages build the same 12-block kvstore chain
(test_torch_execution.build_chain: 4 validators, a fifth from height 7)
and judge the same evidence against their own state and block stores:
duplicate votes (valid, from an outsider, a forged signature, one block,
unsorted votes, wrong powers, a wrong time, votes of two heights,
expired) and light-client attacks (lunatic, equivocation and amnesia,
then a tampered signature, the canonical header, an accused validator
that did not sign, a wrong total power, a common height past the
store).  Verdicts and error types and messages must be the same; so must
the pool's add, pending, check_evidence and update (committed evidence,
conflicting votes reported by consensus, expiry).  The port runs on
device="cpu": its commits of 4-5 signatures stay on the host loop."""

import dataclasses
import gc
import types

import pytest
import torch

from cometbft_tpu.evidence import pool as jpool
from cometbft_tpu.evidence import verify as jverify
from cometbft_tpu.light import types as jlt
from cometbft_tpu.types import evidence as jev
from cometbft_tpu.types import vote as jvote
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.evidence import pool as tpool
from cometbft_tpu_torch.evidence import verify as tverify
from cometbft_tpu_torch.light import types as tlt
from cometbft_tpu_torch.types import evidence as tev
from cometbft_tpu_torch.types import vote as tvote
from test_torch_execution import CHAIN, build_chain, chain_spec, host_side
from test_torch_execution import JAX as XJAX
from test_torch_execution import PORT as XPORT

# test_torch_execution's package namespaces, with the evidence modules
JAX = types.SimpleNamespace(**vars(XJAX), pool=jpool, verify=jverify,
                            lt=jlt, ev=jev, vote=jvote)
PORT = types.SimpleNamespace(**vars(XPORT), pool=tpool, verify=tverify,
                             lt=tlt, ev=tev, vote=tvote)


def _kw(ns):
    return {"device": "cpu"} if ns.port else {}


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
def _port_cache():
    sigcache.reset()
    yield
    sigcache.reset()
    sigcache.set_enabled(None)


@pytest.fixture(scope="module")
def chains():
    spec = chain_spec()
    return build_chain(JAX, spec), build_chain(PORT, spec)


def _vote(ns, n, priv, h, tag, round_=0):
    vals = n.sstore.load_validators(h)
    idx, _ = vals.get_by_address(priv.pub_key().address())
    b = ns.block
    v = ns.vote.Vote(type=ns.vote.PRECOMMIT_TYPE, height=h, round=round_,
                     block_id=b.BlockID(bytes([tag]) * 32,
                                        b.PartSetHeader(1, bytes([tag + 1]) * 32)),
                     timestamp=ns.ts.Timestamp(1_700_000_100, 0),
                     validator_address=priv.pub_key().address(),
                     validator_index=max(idx, 0))
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


def _dup(ns, n, case):
    """A DuplicateVoteEvidence for `case`."""
    h = 9 if case == "joiner" else 3
    who = n.privs[4] if case in ("joiner", "outsider") else n.privs[1]
    vals = n.sstore.load_validators(h)
    va, vb = _vote(ns, n, who, h, 10), _vote(ns, n, who, h, 12)
    t = n.bstore.load_block_meta(h).header.time
    if case == "two_heights":
        vb = _vote(ns, n, who, h + 1, 12)
    if case == "outsider":
        return ns.ev.DuplicateVoteEvidence(va, vb, 40, 10, t)
    ev = ns.ev.DuplicateVoteEvidence.new(va, vb, t, vals)
    if case == "forged":
        ev.vote_b.signature = bytes(64)
    elif case == "same_block":
        ev.vote_b = ev.vote_a
    elif case == "unsorted":
        ev.vote_a, ev.vote_b = ev.vote_b, ev.vote_a
    elif case == "power":
        ev.validator_power = 11
    elif case == "total":
        ev.total_voting_power = 41
    elif case == "time":
        ev.timestamp = t.add_ns(1)
    return ev


def _commit(ns, n, header, vals, round_=0, skip=(), tamper=()):
    """vals' precommits for header, the validators in `skip` absent."""
    b = ns.block
    parts = b.PartSetHeader(1, b"\x33" * 32)
    bid = b.BlockID(header.hash(), parts)
    ts = header.time.add_ns(1_000_000_000)
    by_addr = {p.pub_key().address(): p for p in n.privs}
    sigs = []
    for i, v in enumerate(vals.validators):
        if i in skip:
            sigs.append(b.CommitSig(b.BLOCK_ID_FLAG_ABSENT, b"",
                                    ns.ts.Timestamp.zero(), b""))
            continue
        sb = ns.canonical.vote_sign_bytes(CHAIN, ns.canonical.PRECOMMIT,
                                          header.height, round_, bid, ts)
        sig = by_addr[v.address].sign(sb)
        if i in tamper:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        sigs.append(b.CommitSig(b.BLOCK_ID_FLAG_COMMIT, v.address, ts, sig))
    return b.Commit(header.height, round_, bid, sigs)


def _attack(ns, n, case):
    """A LightClientAttackEvidence for `case`."""
    h = 10
    header = ns.block.Header.from_proto(n.blocks[h - 1].header.to_proto())
    vals = n.sstore.load_validators(h)
    common = 8
    round_, skip, tamper = 0, (), ()
    if case in ("lunatic", "tampered", "not_signer", "total", "common_past"):
        header.app_hash = b"\x07" * 8
    elif case == "equivocation":
        common = h
        header.last_results_hash = b"\x05" * 32
    elif case == "amnesia":
        common = h
        header.data_hash = b"\x06" * 32
        round_ = 1
    if case == "tampered":
        tamper = (0, 1, 2, 3, 4)
    if case == "not_signer":
        skip = (2,)
    commit = _commit(ns, n, header, vals, round_, skip, tamper)
    byz = [v.copy() if hasattr(v, "copy") else v
           for v in vals.validators]
    if case == "equivocation":
        byz = byz[:2]
    elif case == "amnesia":
        byz = []
    total = vals.total_voting_power() + (1 if case == "total" else 0)
    if case == "common_past":
        common = 50
    lb = ns.lt.LightBlock(ns.lt.SignedHeader(header, commit), vals)
    return ns.ev.LightClientAttackEvidence(lb, common, byz, total,
                                           header.time)


def _verdict(fn):
    try:
        fn()
        return "ok"
    except Exception as e:               # noqa: BLE001
        return (type(e).__name__, str(e))


DUP_CASES = ["valid", "joiner", "outsider", "forged", "same_block",
             "unsorted", "power", "total", "time", "two_heights"]
ATTACK_CASES = ["lunatic", "equivocation", "amnesia", "tampered",
                "canonical", "not_signer", "total", "common_past"]


def _judge(ns, n, ev, state=None):
    with host_side(ns):
        return _verdict(lambda: ns.verify.verify_evidence(
            ev, state or n.state, n.sstore, n.bstore, **_kw(ns)))


@pytest.mark.parametrize("case", DUP_CASES)
def test_duplicate_vote_verdicts(chains, case):
    got = [_judge(ns, n, _dup(ns, n, case))
           for ns, n in zip((JAX, PORT), chains)]
    assert got[0] == got[1]
    assert (got[0] == "ok") == (case in ("valid", "joiner"))


def test_expired_duplicate_vote(chains):
    got = []
    for ns, n in zip((JAX, PORT), chains):
        state = dataclasses.replace(n.state)
        state.consensus_params = ns.params.ConsensusParams.from_proto(
            n.state.consensus_params.to_proto())
        state.consensus_params.evidence.max_age_num_blocks = 1
        state.consensus_params.evidence.max_age_duration_ns = 1
        got.append(_judge(ns, n, _dup(ns, n, "valid"), state))
    assert got[0] == got[1] and "too old" in got[0][1]


@pytest.mark.parametrize("case", ATTACK_CASES)
def test_light_client_attack_verdicts(chains, case):
    got = []
    for ns, n in zip((JAX, PORT), chains):
        if case == "canonical":
            h = 10
            header = n.blocks[h - 1].header
            vals = n.sstore.load_validators(h)
            meta = n.bstore.load_block_meta(h)
            commit = n.bstore.load_block(h + 1).last_commit
            assert commit.block_id.hash == meta.block_id.hash
            ev = ns.ev.LightClientAttackEvidence(
                ns.lt.LightBlock(ns.lt.SignedHeader(header, commit), vals),
                8, list(vals.validators), vals.total_voting_power(),
                header.time)
        else:
            ev = _attack(ns, n, case)
        with host_side(ns):
            got.append(_verdict(lambda: ns.verify.verify_light_client_attack(
                ev, n.state, n.sstore, n.bstore, **_kw(ns))))
            got.append(_judge(ns, n, ev))
    assert got[0:2] == got[2:4]
    ok = case in ("lunatic", "equivocation", "amnesia")
    assert (got[0] == "ok") == ok, got


def _pool_run(ns, n):
    pool = ns.pool.EvidencePool(ns.kvdb.MemDB(), n.sstore, n.bstore,
                                **_kw(ns))
    log = []

    def pending(max_bytes=-1):
        evs, size = pool.pending_evidence(max_bytes)
        return ([e.hash().hex() for e in evs], size)

    good = _dup(ns, n, "valid")
    joiner = _dup(ns, n, "joiner")
    attack = _attack(ns, n, "lunatic")
    with host_side(ns):
        log.append(_verdict(lambda: pool.add_evidence(good)))
        log.append(_verdict(lambda: pool.add_evidence(good)))
        log.append(pending())
        log.append(pending(10))
        log.append(_verdict(lambda: pool.add_evidence(_dup(ns, n, "forged"))))
        log.append(_verdict(lambda: pool.check_evidence([joiner, attack])))
        log.append(pending())
        log.append(_verdict(lambda: pool.check_evidence([good, good])))
        log.append(_verdict(lambda: pool.check_evidence(
            [_dup(ns, n, "power")])))
        # consensus reports a conflicting pair; a block commits `good`
        va, vb = _vote(ns, n, n.privs[2], 5, 20), _vote(ns, n, n.privs[2],
                                                         5, 22)
        pool.report_conflicting_votes(va, vb)
        later = dataclasses.replace(
            n.state, last_block_height=n.state.last_block_height + 1)
        log.append(_verdict(lambda: pool.update(later, [good])))
        log.append(pending())
        log.append(_verdict(lambda: pool.check_evidence([good])))
        log.append(_verdict(lambda: pool.update(later, [])))
        # far later: everything pending and committed has expired
        params = ns.params.ConsensusParams.from_proto(
            n.state.consensus_params.to_proto())
        params.evidence.max_age_num_blocks = 2
        params.evidence.max_age_duration_ns = 1
        much_later = dataclasses.replace(
            n.state, last_block_height=n.state.last_block_height + 40,
            last_block_time=n.state.last_block_time.add_ns(10**12),
            consensus_params=params)
        log.append(_verdict(lambda: pool.update(much_later, [])))
        log.append(pending())
        log.append(sorted(k.hex() for k, _ in pool.db.iterate()))
    return log


def test_pool_add_pending_check_update(chains):
    j, t = (_pool_run(ns, n) for ns, n in zip((JAX, PORT), chains))
    assert t == j
    assert t[0] == "ok" and len(t[2][0]) == 1 and t[3] == ([], 0)
    assert t[4][0] == "EvidenceVerificationError"
    assert len(t[6][0]) == 3
    assert t[7][0] == "ErrInvalidEvidence"
    # `good` left pending; the reported pair became pending evidence
    assert len(t[10][0]) == 3 and t[2][0][0] not in t[10][0]
    assert t[11][0] == "ErrInvalidEvidence"
    assert t[12][0] == "EvidenceError"
    assert t[14] == ([], 0) and t[15] == []


def test_pool_needs_a_card_unless_told_cpu(chains):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    n = chains[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpool.EvidencePool(PORT.kvdb.MemDB(), n.sstore, n.bstore)
