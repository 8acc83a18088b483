"""The port's Merkle proofs and block part sets held against the JAX
package: crypto/merkle.Proof and proofs_from_byte_slices, types/part_set
(Part, PartSet, SerializedBlockCache) and the BlockStore's encode-once
cache, byte for byte.  Everything here hashes on the host."""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.types import part_set as jps
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.store.kv import MemDB
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import part_set as tps

torch.set_num_threads(1)


def _items(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return [rng.bytes(int(rng.integers(0, 70))) for _ in range(n)]


def _sha(b):
    return hashlib.sha256(b).digest()


@pytest.mark.parametrize("n", list(range(0, 34)))
def test_proofs_equal_jax(n):
    items = _items(n)
    troot, tproofs = tmerkle.proofs_from_byte_slices(items)
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert troot == jroot == tmerkle.hash_from_byte_slices(items)
    assert len(tproofs) == len(jproofs) == n
    for i, (tp, jp) in enumerate(zip(tproofs, jproofs)):
        assert (tp.total, tp.index, tp.leaf_hash, tp.aunts) == \
            (jp.total, jp.index, jp.leaf_hash, jp.aunts)
        assert tp.to_proto() == jp.to_proto()
        assert tmerkle.Proof.from_proto(jp.to_proto()) == tp
        assert tp.compute_root_hash() == jp.compute_root_hash() == troot
        tp.verify(troot, items[i])


def _verify_error(proof, root, leaf):
    try:
        proof.verify(root, leaf)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33])
def test_tampered_proofs_fail_as_jax(n):
    items = _items(n, seed=7)
    root, _ = tmerkle.proofs_from_byte_slices(items)
    _, jproofs = jmerkle.proofs_from_byte_slices(items)
    cases = []
    for jp in jproofs:
        i = jp.index
        cases.append((jp, root, items[i] + b"x"))                # leaf
        cases.append((jp, _sha(b"other root"), items[i]))          # root
        if jp.aunts:
            cases.append((jmerkle.Proof(jp.total, i, jp.leaf_hash,
                                        [bytes(32)] + jp.aunts[1:]),
                          root, items[i]))                         # aunt
            cases.append((jmerkle.Proof(jp.total, i, jp.leaf_hash,
                                        jp.aunts[:-1]), root, items[i]))
        cases.append((jmerkle.Proof(jp.total, jp.total, jp.leaf_hash,
                                    jp.aunts), root, items[i]))    # index
        cases.append((jmerkle.Proof(-1, i, jp.leaf_hash, jp.aunts),
                      root, items[i]))                             # total
    for jp, r, leaf in cases:
        tp = tmerkle.Proof.from_proto(jp.to_proto()) if jp.total >= 0 \
            else tmerkle.Proof(jp.total, jp.index, jp.leaf_hash, jp.aunts)
        want = _verify_error(jp, r, leaf)
        assert want is not None
        assert _verify_error(tp, r, leaf) == want
        assert tp.compute_root_hash() == jp.compute_root_hash()


def test_merkle_goldens():
    assert tmerkle.hash_from_byte_slices([]) == _sha(b"")
    assert tmerkle.hash_from_byte_slices([b"abc"]) == _sha(b"\x00abc")
    assert tmerkle.hash_from_byte_slices([b"a", b"b"]) == _sha(
        b"\x01" + _sha(b"\x00a") + _sha(b"\x00b"))
    l0, l1, l2 = (_sha(b"\x00" + x) for x in (b"a", b"b", b"c"))
    assert tmerkle.hash_from_byte_slices([b"a", b"b", b"c"]) == \
        _sha(b"\x01" + _sha(b"\x01" + l0 + l1) + l2)
    assert [tmerkle.split_point(n) for n in (2, 3, 4, 5, 8, 9)] == \
        [1, 2, 2, 4, 4, 8]


@pytest.mark.parametrize("size", [0, 100, 65536, 65537, 140000])
def test_part_set_from_data_equals_jax(size):
    data = np.random.default_rng(size).bytes(size)
    tp = tps.PartSet.from_data(data)
    jp = jps.PartSet.from_data(data)
    assert tp.header.to_proto() == jp.header.to_proto()
    assert (tp.count, tp.byte_size) == (jp.count, jp.byte_size)
    assert tp.header.total == max(1, -(-size // tps.BLOCK_PART_SIZE))
    assert [p.to_proto() for p in tp.parts] == \
        [p.to_proto() for p in jp.parts]
    assert tp.bit_array() == jp.bit_array()
    assert tp.assemble() == data


@pytest.mark.parametrize("size", [100, 140000])
def test_add_part_and_assemble_round_trip(size):
    data = np.random.default_rng(3).bytes(size)
    src = tps.PartSet.from_data(data)
    jsrc = jps.PartSet.from_data(data)
    dst = tps.PartSet.new_from_header(src.header)
    jdst = jps.PartSet.new_from_header(jsrc.header)
    assert not dst.is_complete()
    with pytest.raises(tps.PartSetError, match="incomplete part set"):
        dst.assemble()
    for part, jpart in reversed(list(zip(src.parts, jsrc.parts))):
        wire = tps.Part.from_proto(jpart.to_proto())
        assert dst.add_part(wire) is True
        assert jdst.add_part(jpart) is True
        assert dst.add_part(wire) is False          # duplicate
        assert dst.bit_array() == jdst.bit_array()
    assert dst.is_complete() and dst.assemble() == data
    assert dst.byte_size == jdst.byte_size == size


def test_add_part_rejects_as_jax():
    data = np.random.default_rng(4).bytes(140000)
    src = tps.PartSet.from_data(data)
    jsrc = jps.PartSet.from_data(data)
    bad = tps.Part(0, src.parts[0].bytes_[:-1] + b"\x00",
                   src.parts[0].proof)
    jbad = jps.Part(0, jsrc.parts[0].bytes_[:-1] + b"\x00",
                    jsrc.parts[0].proof)
    far = tps.Part(5, b"", src.parts[0].proof)
    jfar = jps.Part(5, b"", jsrc.parts[0].proof)
    for t, j in ((bad, jbad), (far, jfar)):
        with pytest.raises(jps.PartSetError) as je:
            jps.PartSet.new_from_header(jsrc.header).add_part(j)
        with pytest.raises(tps.PartSetError) as te:
            tps.PartSet.new_from_header(src.header).add_part(t)
        assert str(te.value) == str(je.value)
    with pytest.raises(tps.PartSetError, match="part missing proof"):
        tps.Part.from_proto(b"\x08\x01")


class TestSerializedBlockCache:
    def test_put_get_and_counters(self):
        c = tps.SerializedBlockCache(capacity=4)
        c.put(1, b"block-one", [b"p0", b"p1"])
        assert len(c) == 1
        assert c.get_block_bytes(1) == b"block-one"
        assert c.get_part_proto(1, 1) == b"p1"
        assert c.get_block_bytes(2) is None
        assert c.get_part_proto(1, 2) is None
        assert c.get_part_proto(1, -1) is None
        assert (c.hits, c.misses) == (4, 1)

    def test_lru_eviction_bound_and_recency(self):
        c = tps.SerializedBlockCache(capacity=3)
        for h in (1, 2, 3):
            c.put(h, bytes([h]), [])
        assert c.get_block_bytes(1) == b"\x01"
        c.put(4, b"\x04", [])
        assert len(c) == 3 and c.evictions == 1
        assert c.get_block_bytes(2) is None
        assert c.get_block_bytes(1) == b"\x01"

    def test_invalidate_and_invalidate_below(self):
        c = tps.SerializedBlockCache(capacity=8)
        for h in range(1, 6):
            c.put(h, bytes([h]), [])
        assert c.invalidate(5) is True
        assert c.invalidate(5) is False
        assert c.invalidate_below(4) == 3
        assert len(c) == 1 and c.evictions == 4

    def test_capacity_zero_disables(self):
        assert tps.SerializedBlockCache().capacity == 64
        c = tps.SerializedBlockCache(capacity=0)
        c.put(1, b"x", [])
        assert len(c) == 0 and c.get_block_bytes(1) is None

    def test_same_sequence_as_jax(self):
        t, j = tps.SerializedBlockCache(3), jps.SerializedBlockCache(3)
        rng = np.random.default_rng(11)
        for _ in range(60):
            h = int(rng.integers(1, 8))
            op = int(rng.integers(0, 4))
            for c in (t, j):
                if op == 0:
                    c.put(h, bytes([h]) * 3, [bytes([h])])
                elif op == 1:
                    c.get_block_bytes(h)
                elif op == 2:
                    c.get_part_proto(h, 0)
                else:
                    c.invalidate_below(h) if h % 2 else c.invalidate(h)
            assert (t.hits, t.misses, t.evictions, len(t)) == \
                (j.hits, j.misses, j.evictions, len(j))


def _stored_blocks(n, db=None):
    bs = BlockStore(db if db is not None else MemDB())
    blocks, last = [], tblock.Commit()
    for h in range(1, n + 1):
        b = tblock.Block(tblock.Header(chain_id="c", height=h,
                                       validators_hash=_sha(b"v")),
                         tblock.Data([b"tx-%d" % h, b"x" * (h * 30000)]),
                         last_commit=last)
        b.fill_header()
        parts = tps.PartSet.from_data(b.to_proto())
        last = tblock.Commit(h, 0, tblock.BlockID(b.hash(), parts.header),
                             [])
        bs.save_block(b, parts, last)
        blocks.append(b)
    return bs, blocks


def test_block_store_serves_encode_once_bytes():
    db = MemDB()
    bs, blocks = _stored_blocks(3, db)
    for h, b in enumerate(blocks, start=1):
        assert bs.load_block_bytes(h) == b.to_proto()
        assert bs.load_block(h).hash() == b.hash()
    assert (bs._block_cache.hits, bs._block_cache.misses) == (6, 0)
    cold = BlockStore(db)
    assert cold.load_block_bytes(3) == blocks[2].to_proto()
    assert cold.load_block_bytes(3) == blocks[2].to_proto()
    assert (cold._block_cache.hits, cold._block_cache.misses) == (1, 1)
    assert cold.load_block_part(3, 1).to_proto() == \
        bs.load_block_part(3, 1).to_proto()
    assert bs.prune_blocks(3) == 2 and bs.load_block(1) is None
    bs.delete_latest_block()
    assert bs.load_block_bytes(3) is None and bs._block_cache.evictions == 3
