"""The port's ValidatorSet against the JAX package on the CPU: the same
seeded keys and change sets (adds, power changes, removals) applied to
both packages, and each rejected change set (a duplicate, a negative
power, removing an absent validator, a power or total over the limit);
after every step the order, priorities, proposer, total power, hash()
and proto bytes must be equal, also after increment_proposer_priority(k)
for several k, and a rejected set must raise the same exception class
and message and leave both sets as they were.  Sets cross between the
packages as proto bytes (convert.validator_set_from_proto), both ways."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.types import validator_set as jvset
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.types import validator_set as tvset

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keys(rng, n, secp_every=0):
    """n seeded public keys as (jax key, port key) pairs; every
    secp_every-th one a secp256k1 key (33 bytes, parity prefix)."""
    out = []
    for i in range(n):
        if secp_every and i % secp_every == secp_every - 1:
            raw = bytes([2 + (i & 1)]) + rng.bytes(32)
            out.append((jsecp.PubKey(raw), tsecp.PubKey(raw)))
        else:
            raw = rng.bytes(32)
            out.append((jed.PubKey(raw), ted.PubKey(raw)))
    return out


def vals(pairs, powers, prios=None):
    prios = prios or [0] * len(pairs)
    return ([jvset.Validator(j, p, q) for (j, _), p, q
             in zip(pairs, powers, prios)],
            [tvset.Validator(t, p, q) for (_, t), p, q
             in zip(pairs, powers, prios)])


def state(vs):
    prop = vs.proposer
    return ([(v.address, v.voting_power, v.proposer_priority)
             for v in vs.validators],
            None if prop is None else (prop.address, prop.proposer_priority),
            vs.total_voting_power(), vs.to_proto())


def same(js, ts):
    assert state(ts) == state(js)
    assert ts.hash(device=CPU) == js.hash()
    assert [v.to_proto() for v in ts.validators] == \
        [v.to_proto() for v in js.validators]


def outcome(fn):
    try:
        fn()
    except Exception as e:                       # noqa: BLE001
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_constructor_and_priority_walk(seed):
    rng = np.random.default_rng(seed)
    pairs = keys(rng, 9, secp_every=4)
    powers = [int(p) for p in rng.integers(1, 1000, size=9)]
    jl, tl = vals(pairs, powers)
    js, ts = jvset.ValidatorSet(jl), tvset.ValidatorSet(tl)
    same(js, ts)
    assert ts.get_proposer().address == js.get_proposer().address
    for k in (1, 2, 5, 17, 64):
        js.increment_proposer_priority(k)
        ts.increment_proposer_priority(k)
        same(js, ts)
    # rescale: a priority spread far over 2 x total power
    for js_v, ts_v in zip(js.validators, ts.validators):
        js_v.proposer_priority = ts_v.proposer_priority = \
            int(rng.integers(-10**12, 10**12))
    js.rescale_priorities(2 * js.total_voting_power())
    ts.rescale_priorities(2 * ts.total_voting_power())
    same(js, ts)
    js.increment_proposer_priority(3)
    ts.increment_proposer_priority(3)
    same(js, ts)


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_random_change_sets(seed):
    rng = np.random.default_rng(seed)
    pairs = keys(rng, 12)
    jl, tl = vals(pairs, [10] * 12)
    js, ts = jvset.ValidatorSet(jl), tvset.ValidatorSet(tl)
    spare = keys(rng, 20)
    for step in range(6):
        members = [v.address for v in js.validators]
        changes_j, changes_t = [], []
        # removals
        for a in rng.choice(members, size=int(rng.integers(0, 3)),
                            replace=False):
            _, jv = js.get_by_address(bytes(a))
            _, tv = ts.get_by_address(bytes(a))
            changes_j.append(jvset.Validator(jv.pub_key, 0))
            changes_t.append(tvset.Validator(tv.pub_key, 0))
        gone = {c.address for c in changes_j}
        # power changes of members that stay
        for a in members:
            if a not in gone and rng.random() < 0.25:
                p = int(rng.integers(1, 500))
                _, jv = js.get_by_address(a)
                _, tv = ts.get_by_address(a)
                changes_j.append(jvset.Validator(jv.pub_key, p))
                changes_t.append(tvset.Validator(tv.pub_key, p))
        # adds
        for _ in range(int(rng.integers(0, 3))):
            j, t = spare.pop()
            p = int(rng.integers(1, 500))
            changes_j.append(jvset.Validator(j, p))
            changes_t.append(tvset.Validator(t, p))
        order = rng.permutation(len(changes_j))
        js.update_with_change_set([changes_j[i] for i in order])
        ts.update_with_change_set([changes_t[i] for i in order])
        same(js, ts)
        k = int(rng.integers(1, 9))
        js.increment_proposer_priority(k)
        ts.increment_proposer_priority(k)
        same(js, ts)


def _rejected_cases(js, ts, pairs, spare):
    """(label, jax changes, port changes) of each rejected change set."""
    (j0, t0), (j1, t1) = pairs[0], pairs[1]
    big = tvset.MAX_TOTAL_VOTING_POWER
    return [
        ("duplicate", [jvset.Validator(j0, 5), jvset.Validator(j0, 7)],
         [tvset.Validator(t0, 5), tvset.Validator(t0, 7)]),
        ("negative", [jvset.Validator(j1, -1)], [tvset.Validator(t1, -1)]),
        ("absent removal", [jvset.Validator(spare[0][0], 0)],
         [tvset.Validator(spare[0][1], 0)]),
        ("power too high", [jvset.Validator(spare[1][0], big + 1)],
         [tvset.Validator(spare[1][1], big + 1)]),
        ("total overflow", [jvset.Validator(spare[2][0], big - 1),
                            jvset.Validator(spare[3][0], big - 1)],
         [tvset.Validator(spare[2][1], big - 1),
          tvset.Validator(spare[3][1], big - 1)]),
    ]


def test_rejected_change_sets():
    rng = np.random.default_rng(11)
    pairs = keys(rng, 6)
    jl, tl = vals(pairs, [10, 20, 30, 40, 50, 60])
    js, ts = jvset.ValidatorSet(jl), tvset.ValidatorSet(tl)
    spare = keys(rng, 4)
    seen = set()
    for label, cj, ct in _rejected_cases(js, ts, pairs, spare):
        before = state(js)
        got_j = outcome(lambda: js.update_with_change_set(cj))
        got_t = outcome(lambda: ts.update_with_change_set(ct))
        assert got_j is not None, label
        assert got_t == got_j, label
        seen.add(got_j[0])
        assert state(js) == before
        same(js, ts)
    assert seen == {"ValueError", "OverflowError"}
    # the constructor refuses a zero power and a duplicate the same way
    (j0, t0), (j1, t1) = pairs[:2]
    assert outcome(lambda: tvset.ValidatorSet([tvset.Validator(t0, 0)])) == \
        outcome(lambda: jvset.ValidatorSet([jvset.Validator(j0, 0)]))
    assert outcome(lambda: tvset.ValidatorSet(
        [tvset.Validator(t1, 1), tvset.Validator(t1, 2)])) == outcome(
        lambda: jvset.ValidatorSet([jvset.Validator(j1, 1),
                                    jvset.Validator(j1, 2)]))


def test_proto_both_ways_and_accessors():
    rng = np.random.default_rng(12)
    pairs = keys(rng, 7, secp_every=3)
    jl, tl = vals(pairs, [int(p) for p in rng.integers(1, 90, size=7)])
    js = jvset.ValidatorSet(jl)
    js.increment_proposer_priority(4)
    ts = convert.validator_set_from_proto(js)
    same(js, ts)
    back = jvset.ValidatorSet.from_proto(ts.to_proto())
    assert back.to_proto() == js.to_proto() == ts.to_proto()
    # copies are independent, from_validated keeps priorities as given
    tc, jc = ts.copy(), js.copy()
    tc.increment_proposer_priority(1)
    jc.increment_proposer_priority(1)
    same(js, ts)
    same(jc, tc)
    jv = [v.copy() for v in js.validators]
    tv = [v.copy() for v in ts.validators]
    same(jvset.ValidatorSet.from_validated(jv),
         tvset.ValidatorSet.from_validated(tv))
    for (j, t) in pairs:
        assert ts.has_address(t.address()) == js.has_address(j.address())
    assert ts.has_address(b"\x00" * 20) is False
    assert tvset.ValidatorSet().is_nil_or_empty() and \
        not ts.is_nil_or_empty()
    ts.validate_basic()
    js.validate_basic()
    for bad_j, bad_t in (
            (jvset.ValidatorSet(), tvset.ValidatorSet()),
            (jvset.ValidatorSet.from_validated(
                [jvset.Validator(pairs[0][0], -3)]),
             tvset.ValidatorSet.from_validated(
                [tvset.Validator(pairs[0][1], -3)]))):
        assert outcome(bad_t.validate_basic) == outcome(bad_j.validate_basic)
    # compare_proposer_priority: priority, then the lower address
    a_j, b_j = js.validators[0].copy(), js.validators[1].copy()
    a_t, b_t = ts.validators[0].copy(), ts.validators[1].copy()
    for pa, pb in ((5, 3), (3, 5), (4, 4)):
        a_j.proposer_priority = a_t.proposer_priority = pa
        b_j.proposer_priority = b_t.proposer_priority = pb
        assert a_t.compare_proposer_priority(b_t).address == \
            a_j.compare_proposer_priority(b_j).address
    assert outcome(lambda: a_t.compare_proposer_priority(a_t.copy())) == \
        outcome(lambda: a_j.compare_proposer_priority(a_j.copy()))
    for v_j, v_t in zip(js.validators, ts.validators):
        assert tvset.Validator.from_proto(v_j.to_proto()).to_proto() == \
            v_j.to_proto()
        assert outcome(v_t.validate_basic) == outcome(v_j.validate_basic)
