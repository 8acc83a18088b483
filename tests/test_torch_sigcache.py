"""The port's signature-verdict cache (crypto/sigcache.py), its call
sites (crypto/batch.safe_verify, the batch verifiers' inserts,
types/validation's partitions) and the trimmed lock-rank checker
(libs/lockrank.py), against the JAX package.

The cache mechanics are the JAX package's tests/test_sigcache.py cases
that need no pipeline, vote stream or metrics registry, run against the
port; key() digests equal the JAX package's for every key type; a
commit's error is the same hot, cold and with the cache off, in both
packages, and a hot pass reaches no verifier.  The port runs with
device="cpu"."""

import pytest
import torch

from cometbft_tpu.crypto import sigcache as jsigcache
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import secp256k1 as jsk
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.validator_set import (Validator as JValidator,
                                              ValidatorSet as JValidatorSet)
from cometbft_tpu_torch.crypto import batch as cb
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import secp256k1 as tsk
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.libs import lockrank
from cometbft_tpu_torch.types import block, canonical, validation
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

torch.set_num_threads(1)

CHAIN_ID = "sigcache-chain"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_sigcache():
    """The port's cache is process-wide: every test starts and ends with
    an empty cache in the default state (the JAX package's is reset by
    tests/conftest.py)."""
    sigcache.reset()
    sigcache.set_enabled(None)
    yield
    sigcache.reset()
    sigcache.set_enabled(None)


@pytest.fixture(autouse=True)
def _cpu_provider(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_PROVIDER", "cpu")


def _triple(i: int, good: bool = True, salt: int = 0):
    """Deterministic (PubKey, msg, sig); bad triples corrupt the sig."""
    priv = ted.PrivKey.generate(
        bytes([salt & 0xFF, i & 0xFF, (i >> 8) & 0xFF]) + b"\x11" * 29)
    msg = b"sigcache-item-" + i.to_bytes(4, "little")
    sig = priv.sign(msg)
    if not good:
        sig = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
    return priv.pub_key(), msg, sig


def _commit_fixture(powers=(10, 20, 30, 40), height=5, bad=()):
    """The same valset + commit in both packages, every validator signed;
    indices in `bad` carry an all-zero (cleanly invalid) signature."""
    privs = [jed.PrivKey.generate(bytes([i + 1]) * 32)
             for i in range(len(powers))]
    jvs = JValidatorSet([JValidator(p.pub_key(), pw)
                         for p, pw in zip(privs, powers)])
    tvs = ValidatorSet([Validator(ted.PubKey(p.pub_key().bytes()), pw)
                        for p, pw in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = block.BlockID(b"\xab" * 32, block.PartSetHeader(1, b"\xcd" * 32))
    jbid = jblock.BlockID(b"\xab" * 32, jblock.PartSetHeader(1, b"\xcd" * 32))
    sigs, jsigs = [], []
    for i, val in enumerate(tvs.validators):
        ts = Timestamp(1000 + i, 0)
        sb = canonical.vote_sign_bytes(CHAIN_ID, 2, height, 0, bid, ts)
        sig = bytes(64) if i in bad else by_addr[val.address].sign(sb)
        sigs.append(block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, val.address,
                                    ts, sig))
        jsigs.append(jblock.CommitSig(jblock.BLOCK_ID_FLAG_COMMIT,
                                      val.address, JTimestamp(1000 + i, 0),
                                      sig))
    return (tvs, bid, block.Commit(height, 0, bid, sigs),
            jvs, jbid, jblock.Commit(height, 0, jbid, jsigs))


# -- cache mechanics -----------------------------------------------------------

class TestCacheCore:
    def test_key_framing_and_type(self):
        pk, msg, sig = _triple(0)
        k1 = sigcache.key(pk, msg, sig)
        # length framing: shifting a byte across the msg/sig boundary
        # must change the digest
        assert sigcache.key(pk, msg + sig[:1], sig[1:]) != k1
        # raw key bytes and the key object address identically
        assert sigcache.key(pk.bytes(), msg, sig) == k1
        # the same raw bytes under another curve are a different fact
        assert sigcache.key(pk, msg, sig, key_type="secp256k1") != k1

    def test_lru_evicts_oldest_refreshes_on_hit(self):
        c = sigcache.SigVerdictCache(capacity=4, stripes=1)
        keys = [sigcache.key(*_triple(i)) for i in range(5)]
        for k in keys[:4]:
            assert c.store(k, True) == 0
        assert c.lookup(keys[0]) is True        # refresh key 0
        assert c.store(keys[4], True) == 1      # evicts the LRU entry
        assert c.lookup(keys[1]) is None        # ...which was key 1
        assert c.lookup(keys[0]) is True
        assert len(c) == 4

    def test_striping_spreads_and_bounds(self):
        c = sigcache.SigVerdictCache(capacity=64, stripes=16)
        keys = [sigcache.key(*_triple(i)) for i in range(64)]
        for k in keys:
            c.store(k, bool(k[1] % 2))
        assert len({k[0] % 16 for k in keys}) > 1
        assert 0 < len(c) <= 64
        for k in keys:
            got = c.lookup(k)
            assert got is None or got == bool(k[1] % 2)
        c.clear()
        assert len(c) == 0

    def test_negative_verdicts_cached_and_counted(self):
        sigcache.set_enabled(True)
        pk, msg, sig = _triple(1, good=False)
        assert sigcache.get(pk, msg, sig) is None
        sigcache.insert(pk, msg, sig, False)
        assert sigcache.get(pk, msg, sig) is False
        st = sigcache.cache().stats()
        assert (st["misses"], st["hits"], st["negative_hits"]) == (1, 1, 1)
        assert st["insertions"] == 1 and st["hit_rate"] == 0.5

    def test_disabled_is_inert(self, monkeypatch):
        sigcache.set_enabled(False)
        pk, msg, sig = _triple(2)
        sigcache.insert(pk, msg, sig, True)
        assert sigcache.get(pk, msg, sig) is None
        verdicts, miss = sigcache.partition([(pk, msg, sig)])
        assert verdicts == [None] and miss == [0]
        sigcache.insert_many([(pk, msg, sig)], [True])
        assert len(sigcache.cache()) == 0
        # the variable applies when no override is set, read per call
        sigcache.set_enabled(None)
        monkeypatch.setenv("COMETBFT_TPU_SIGCACHE", "0")
        assert not sigcache.enabled()
        monkeypatch.setenv("COMETBFT_TPU_SIGCACHE", "1")
        assert sigcache.enabled()
        monkeypatch.delenv("COMETBFT_TPU_SIGCACHE")
        assert sigcache.enabled()                   # default on

    def test_partition_and_insert_many_roundtrip(self):
        sigcache.set_enabled(True)
        items = [_triple(i) for i in range(6)]
        verdicts, miss = sigcache.partition(items)
        assert verdicts == [None] * 6 and miss == list(range(6))
        sigcache.insert_many(items[:3], [True, True, False])
        verdicts, miss = sigcache.partition(items)
        assert verdicts[:3] == [True, True, False]
        assert miss == [3, 4, 5]
        st = sigcache.cache().stats()
        assert (st["hits"], st["negative_hits"], st["misses"]) == (3, 1, 9)
        sigcache.partition(items, count_misses=False)
        assert sigcache.cache().stats()["misses"] == 9

    def test_reset_capacity_and_registry_match_jax(self):
        assert sigcache.reset(capacity=5).capacity == 16   # >= stripes
        assert sigcache.reset().capacity == jsigcache.DEFAULT_CAPACITY
        assert sigcache.CONSUMERS == jsigcache.CONSUMERS
        assert sigcache.LANES == jsigcache.LANES
        for label in sorted(sigcache.CONSUMERS) + ["pipeline"]:
            assert sigcache.lane_priority(label) == \
                jsigcache.lane_priority(label)
        assert sigcache.current_consumer() == "crypto"
        with sigcache.consumer("blocksync"):
            with sigcache.consumer("light"):
                assert sigcache.current_consumer() == "light"
            assert sigcache.current_consumer() == "blocksync"
        assert sigcache.current_consumer() == "crypto"


# -- key() against the JAX package ---------------------------------------------

def _typed_triples():
    """(port key, JAX key, msg, sig) for each key type."""
    msg = b"sigcache-typed"
    out = []
    for port, jax_mod, seed in ((ted, jed, b"\x21" * 32),
                                (tsk, jsk, b"\x22" * 32),
                                (tsr, jsr, b"\x23" * 32)):
        jpriv = jax_mod.PrivKey.generate(seed)
        out.append((port.PubKey(jpriv.pub_key().bytes()), jpriv.pub_key(),
                    msg, jpriv.sign(msg)))
    return out


@pytest.mark.parametrize("kind", ["ed25519", "secp256k1", "sr25519"])
def test_key_digest_equals_jax(kind):
    tpk, jpk, msg, sig = next(t for t in _typed_triples()
                              if t[0].type() == kind)
    assert tpk.type() == jpk.type() == kind
    want = jsigcache.key(jpk, msg, sig)
    assert sigcache.key(tpk, msg, sig) == want
    assert sigcache.key(tpk.bytes(), msg, sig, key_type=kind) == want
    # the same raw bytes under each other type: digests of their own,
    # equal across the packages
    for other in ("ed25519", "secp256k1", "sr25519"):
        got = sigcache.key(tpk.bytes(), msg, sig, key_type=other)
        assert got == jsigcache.key(jpk.bytes(), msg, sig, key_type=other)
        assert (got == want) == (other == kind)


# -- consumer seams ------------------------------------------------------------

class TestSafeVerifyCaching:
    def test_first_seen_verify_then_hits(self):
        sigcache.set_enabled(True)
        pk, msg, sig = _triple(4)
        assert cb.safe_verify(pk, msg, sig) is True     # miss + insert
        st0 = sigcache.cache().stats()
        assert st0["misses"] == 1 and st0["insertions"] == 1
        assert cb.safe_verify(pk, msg, sig) is True     # pure hit
        st1 = sigcache.cache().stats()
        assert st1["hits"] == st0["hits"] + 1
        assert st1["misses"] == st0["misses"]           # no re-verify

    def test_hostile_triple_rejected_identically_all_modes(self):
        pk, msg, sig = _triple(5, good=False)
        sigcache.set_enabled(False)
        assert cb.safe_verify(pk, msg, sig) is False    # disabled
        sigcache.set_enabled(True)
        sigcache.reset()
        assert cb.safe_verify(pk, msg, sig) is False    # miss
        assert sigcache.get(pk, msg, sig) is False      # cached negative
        assert cb.safe_verify(pk, msg, sig) is False    # negative hit

    def test_backend_error_is_a_cached_reject(self):
        class Broken:
            def type(self):
                return "bls12_381"

            def bytes(self):
                return b"\x07" * 48

            def verify_signature(self, msg, sig):
                raise RuntimeError("backend unavailable")

        sigcache.set_enabled(True)
        assert cb.safe_verify(Broken(), b"m", b"s") is False
        assert sigcache.get(Broken(), b"m", b"s") is False


@pytest.fixture
def dispatches(monkeypatch):
    """Count the batch verifiers the validation seams build."""
    made = []
    real = cb.create_batch_verifier

    def spy(*a, **k):
        made.append(a[0] if a else k.get("key_type"))
        return real(*a, **k)
    monkeypatch.setattr(cb, "create_batch_verifier", spy)
    return made


class TestCommitParity:
    """validation._verify's batch path and DeferredSigBatch: hot, cold
    and disabled give the same errors and acceptance, equal to the JAX
    package's; a hot pass reaches no verifier."""

    def _error(self, verify) -> str:
        with pytest.raises(Exception) as ei:
            verify()
        return type(ei.value).__name__, str(ei.value)

    def test_bad_commit_error_byte_identical_hot_cold_disabled(
            self, dispatches):
        tvs, bid, commit, jvs, jbid, jcommit = _commit_fixture(bad=(1,))
        run = lambda: validation.verify_commit(  # noqa: E731
            CHAIN_ID, tvs, bid, 5, commit, device=CPU)
        jsigcache.set_enabled(False)
        want = self._error(lambda: jval.verify_commit(CHAIN_ID, jvs, jbid, 5,
                                                      jcommit))
        sigcache.set_enabled(False)
        msg_disabled = self._error(run)
        sigcache.set_enabled(True)
        sigcache.reset()
        msg_cold = self._error(run)
        st_cold, n_cold = sigcache.cache().stats(), len(dispatches)
        msg_hot = self._error(run)
        st_hot = sigcache.cache().stats()
        assert msg_disabled == msg_cold == msg_hot == want
        assert want[0] == "ErrInvalidSignature"
        # the hot pass resolved without a single new verification
        assert st_hot["misses"] == st_cold["misses"]
        assert st_hot["negative_hits"] > st_cold["negative_hits"]
        assert len(dispatches) == n_cold == 2

    def test_good_commit_reverify_is_all_hits(self, dispatches):
        tvs, bid, commit, *_ = _commit_fixture()
        sigcache.set_enabled(True)
        validation.verify_commit(CHAIN_ID, tvs, bid, 5, commit, device=CPU)
        st0 = sigcache.cache().stats()
        assert st0["insertions"] == len(commit.signatures)
        validation.verify_commit(CHAIN_ID, tvs, bid, 5, commit, device=CPU)
        st1 = sigcache.cache().stats()
        assert st1["misses"] == st0["misses"]       # zero new verifies
        assert st1["hits"] >= st0["hits"] + len(commit.signatures)
        assert dispatches == ["ed25519"]

    def test_deferred_batch_negative_hit_same_error_and_ctx(self,
                                                            dispatches):
        tvs, bid, commit, jvs, jbid, jcommit = _commit_fixture(bad=(2,))

        def run(validation, vals, bid, commit, **kw):
            batch = validation.DeferredSigBatch()
            validation.verify_commit_light(CHAIN_ID, vals, bid, 5, commit,
                                           defer_to=batch, **kw)
            with pytest.raises(validation.ErrInvalidSignature) as ei:
                batch.verify(**kw)
            return str(ei.value), ei.value.failed_ctx

        jsigcache.set_enabled(False)
        want = run(jval, jvs, jbid, jcommit)
        sigcache.set_enabled(False)
        got_disabled = run(validation, tvs, bid, commit, device=CPU)
        sigcache.set_enabled(True)
        sigcache.reset()
        got_cold = run(validation, tvs, bid, commit, device=CPU)
        st_cold = sigcache.cache().stats()
        got_hot = run(validation, tvs, bid, commit, device=CPU)
        assert got_disabled == got_cold == got_hot == want
        assert got_hot[1] == 5
        st_hot = sigcache.cache().stats()
        assert st_hot["insertions"] == st_cold["insertions"]
        assert st_hot["negative_hits"] > st_cold["negative_hits"]
        assert dispatches == []                   # below the device threshold

    def test_deferred_window_partial_hits_dispatch_only_misses(
            self, monkeypatch):
        """A window whose first commit was verified before: only the
        second commit's signatures reach the verifier."""
        monkeypatch.setattr(validation.DeferredSigBatch, "DEVICE_THRESHOLD",
                            2)
        sizes = []
        real = cb.MixedBatchVerifier.verify

        def spy(self):
            sizes.append(self.count())
            return real(self)
        monkeypatch.setattr(cb.MixedBatchVerifier, "verify", spy)
        sigcache.set_enabled(True)
        tvs, bid, c5, *_ = _commit_fixture(height=5)
        _, bid6, c6, *_ = _commit_fixture(height=6)
        validation.verify_commit(CHAIN_ID, tvs, bid, 5, c5, device=CPU)
        batch = validation.DeferredSigBatch()
        for h, b, c in ((5, bid, c5), (6, bid6, c6)):
            validation.verify_commit_light(CHAIN_ID, tvs, b, h, c,
                                           defer_to=batch, device=CPU)
        n5 = batch.count() // 2
        batch.verify(device=CPU)
        assert sizes == [n5]
        batch = validation.DeferredSigBatch()
        for h, b, c in ((5, bid, c5), (6, bid6, c6)):
            validation.verify_commit_light(CHAIN_ID, tvs, b, h, c,
                                           defer_to=batch, device=CPU)
        batch.verify(device=CPU)                  # every triple a hit
        assert sizes == [n5]


class TestBatchVerifierInserts:
    @staticmethod
    def _secp_triple(i: int, good: bool = True):
        priv = tsk.PrivKey.generate(bytes([40 + i]) * 4)
        msg = b"sigcache-secp-" + i.to_bytes(4, "little")
        sig = priv.sign(msg)
        if not good:
            sig = sig[:6] + bytes([sig[6] ^ 1]) + sig[7:]
        return priv.pub_key(), msg, sig

    def test_mixed_batch_inserts_both_curves_then_all_hits(self):
        sigcache.set_enabled(True)
        eds = [_triple(i) for i in range(3)]
        secps = [self._secp_triple(i, good=(i != 1)) for i in range(3)]
        bv = cb.MixedBatchVerifier(provider="cpu", device=CPU)
        for pk, msg, sig in eds + secps:
            bv.add(pk, msg, sig)
        ok, verdicts = bv.verify()
        assert not ok
        assert verdicts == [True, True, True, True, False, True]
        got, miss = sigcache.partition(eds + secps)
        assert miss == [] and got == verdicts
        assert sigcache.cache().stats()["insertions"] >= 6

    def test_key_type_partitions_identical_raw_bytes(self):
        sigcache.set_enabled(True)
        pk, msg, sig = _triple(7)
        raw = pk.bytes()
        sigcache.insert(raw, msg, sig, True, key_type="ed25519")
        assert sigcache.get(raw, msg, sig, key_type="ed25519") is True
        assert sigcache.get(raw, msg, sig, key_type="secp256k1") is None
        sigcache.insert(raw, msg, sig, False, key_type="secp256k1")
        assert sigcache.get(raw, msg, sig,
                            key_type="secp256k1") is False
        assert sigcache.get(raw, msg, sig, key_type="ed25519") is True

    @pytest.mark.parametrize("provider", ["cpu", "tpu"])
    def test_sr25519_verdicts_inserted_under_their_type(self, provider):
        """Both sr25519 verifiers insert under "sr25519": the sr25519 key
        object hits, the same raw bytes read as ed25519 miss."""
        sigcache.set_enabled(True)
        items = []
        for i in range(3):
            priv = tsr.PrivKey.generate(bytes([50 + i]) * 32)
            m = b"sigcache-sr-%d" % i
            sig = priv.sign(m)
            items.append((priv.pub_key(), m + (b"!" if i == 2 else b""),
                          sig))
        bv = cb.create_batch_verifier("sr25519", device=CPU,
                                      provider=provider)
        for it in items:
            bv.add(*it)
        assert bv.verify() == (False, [True, True, False])
        assert sigcache.partition(items) == ([True, True, False], [])
        pk, m, s = items[0]
        assert sigcache.get(pk.bytes(), m, s) is None          # as ed25519
        assert sigcache.get(pk.bytes(), m, s, key_type="sr25519") is True


# -- lock ranks ----------------------------------------------------------------

@pytest.fixture
def checker():
    yield lockrank.enable("raise")
    lockrank.disable()


def test_lockrank_table_is_the_jax_packages():
    from cometbft_tpu.libs import lockrank as jlockrank

    for name, rank in lockrank.LOCK_RANKS.items():
        assert jlockrank.LOCK_RANKS[name] == rank
        assert (name in lockrank.MULTI_OK) == (name in jlockrank.MULTI_OK)
    with pytest.raises(ValueError):
        lockrank.RankedLock("dispatch.cv")
    assert isinstance(ted.ATableCache()._lock, lockrank.RankedLock)
    assert ted.ATableCache()._lock.name == "ed25519.atable"
    assert tsk.QTableCache()._lock.name == "secp256k1.qtable"


def test_inverted_acquisition_raises(checker):
    stripe = sigcache.SigVerdictCache(stripes=2)._locks
    atable = ted.ATableCache()._lock
    with atable:                                  # declared order: fine
        with stripe[0]:
            with stripe[1]:                       # peers of a multi lock
                pass
    with stripe[0]:
        with pytest.raises(lockrank.LockRankError,
                           match="rank inversion: acquiring "
                                 "'ed25519.atable'"):
            atable.acquire()
        assert not atable.locked()                # raised before blocking
        assert atable.acquire(blocking=False)     # a try-lock cannot wait
        atable.release()
    assert lockrank.violations() == []


def test_warn_mode_records_and_carries_on():
    lockrank.enable("warn")
    try:
        qtable = tsk.QTableCache()._lock
        with sigcache._cache_lock:
            with qtable:
                pass
        v = lockrank.violations()
        assert len(v) == 1 and "acquiring 'secp256k1.qtable'" in v[0]
    finally:
        lockrank.disable()
    assert lockrank.violations() == []


def test_three_type_batch_runs_clean_in_raise_mode(checker, monkeypatch):
    """A MixedBatchVerifier batch of ed25519, sr25519 and secp256k1 on
    the device programs (plain versions), twice, with the cache on: the
    A-table cache (MIN_K lowered, so its lock is taken and its second
    sighting builds), the key-table cache and the cache stripes, in three
    threads, never invert."""
    monkeypatch.setattr(ted.ATableCache, "MIN_K", 1)
    monkeypatch.setattr(ted, "_A_TABLE_CACHE", ted.ATableCache())
    monkeypatch.setattr(tsk, "_Q_CACHE", tsk.QTableCache())
    sigcache.set_enabled(True)
    items, want = [], []
    for i, (mod, seed) in enumerate(((ted, 0x31), (ted, 0x32), (tsr, 0x33),
                                     (tsr, 0x34), (tsk, 0x35),
                                     (tsk, 0x36))):
        priv = mod.PrivKey.generate(bytes([seed]) * 32)
        m = b"lockrank-%d" % i
        items.append((priv.pub_key(), m, priv.sign(m)))
        want.append(True)
    for _ in range(2):
        bv = cb.MixedBatchVerifier(provider="tpu", device=CPU)
        for it in items:
            bv.add(*it)
        assert bv.verify() == (True, want)
    assert ted._A_TABLE_CACHE.misses == 2        # ed25519's and sr25519's
    assert tsk._Q_CACHE.misses == 1 and tsk._Q_CACHE.hits == 1
    assert lockrank.violations() == []
