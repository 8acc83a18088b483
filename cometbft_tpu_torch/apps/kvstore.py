"""In-memory key=value store app (the port's copy of
`cometbft_tpu.apps.kvstore`; CometBFT abci/example/kvstore/kvstore.go).

Exercises the full ABCI surface the way the reference example does:
- txs are "key=value" strings; CheckTx validates the shape
- "val:<base64 pubkey>!<power>" txs update the validator set
- app hash = 8-byte big-endian running tx count (deterministic, cheap)
- Query supports path "/key" lookups
- state snapshots at every height for statesync testing

State persists across Commit only in memory (height, app_hash, kv) —
the durable variant would write through a KVStore; the reference's
example is likewise memory-backed by default.
"""

from __future__ import annotations

import base64
import json

from ..abci import types as at
from ..abci.application import BaseApplication
from ..crypto.hash import sum_sha256
from ..libs import lockrank

VALIDATOR_TX_PREFIX = "val:"

CODE_OK = 0
CODE_INVALID_TX_FORMAT = 1
CODE_UNKNOWN_ERROR = 2


class KVStoreApplication(BaseApplication):
    def __init__(self, snapshot_interval: int = 1,
                 snapshot_keep: int = 10):
        """snapshot_interval: take a snapshot every N heights (the
        reference kvstore's --snapshot-interval); snapshot_keep: how
        many to retain.  keep * interval is the serving WINDOW — a
        statesyncing peer must fetch all chunks before the chain
        advances past it, so fast chains want interval > 1."""
        self._lock = lockrank.RankedRLock("apps.kvstore")
        self.kv: dict[str, str] = {}
        self.height = 0
        self.app_hash = b"\x00" * 8
        self.tx_count = 0
        self.validator_updates: dict[str, int] = {}  # b64 pubkey -> power
        self._staged: list[tuple[str, str]] = []
        self._staged_vals: list[at.ValidatorUpdate] = []
        self._snapshots: dict[int, bytes] = {}
        self.snapshot_interval = max(1, snapshot_interval)
        self.snapshot_keep = max(1, snapshot_keep)

    # -- info/query --------------------------------------------------------

    def info(self, req):
        with self._lock:
            return at.InfoResponse(
                data=json.dumps({"size": len(self.kv)}),
                version="kvstore-tpu-0.1",
                app_version=1,
                last_block_height=self.height,
                last_block_app_hash=self.app_hash)

    def query(self, req):
        with self._lock:
            key = req.data.decode()
            value = self.kv.get(key)
            if value is None:
                return at.QueryResponse(code=CODE_OK, key=req.data,
                                        log="does not exist",
                                        height=self.height)
            return at.QueryResponse(code=CODE_OK, key=req.data,
                                    value=value.encode(), log="exists",
                                    height=self.height)

    # -- mempool -----------------------------------------------------------

    def check_tx(self, req):
        if self._parse_tx(req.tx) is None:
            return at.CheckTxResponse(
                code=CODE_INVALID_TX_FORMAT,
                log="tx must be key=value or val:pubkey!power")
        return at.CheckTxResponse(code=CODE_OK, gas_wanted=1)

    # -- consensus ---------------------------------------------------------

    def init_chain(self, req):
        with self._lock:
            for v in req.validators:
                b64 = base64.b64encode(v.pub_key_bytes).decode()
                self.validator_updates[b64] = v.power
            if req.initial_height:
                self.height = req.initial_height - 1
            return at.InitChainResponse(app_hash=self.app_hash)

    def process_proposal(self, req):
        for tx in req.txs:
            if self._parse_tx(tx) is None:
                return at.ProcessProposalResponse(
                    status=at.PROCESS_PROPOSAL_REJECT)
        return at.ProcessProposalResponse(status=at.PROCESS_PROPOSAL_ACCEPT)

    def finalize_block(self, req):
        """Deterministic and idempotent: all effects are STAGED here and
        applied in commit(), so crash-recovery re-execution of the same
        block (FinalizeBlock ran, Commit didn't) reproduces the same
        app_hash instead of double-counting."""
        with self._lock:
            self._staged = []
            self._staged_vals = []
            staged_count = 0
            results = []
            for tx in req.txs:
                parsed = self._parse_tx(tx)
                if parsed is None:
                    results.append(at.ExecTxResult(
                        code=CODE_INVALID_TX_FORMAT, log="invalid tx"))
                    continue
                kind, key, value = parsed
                if kind == "val":
                    power = int(value)
                    self._staged_vals.append(at.ValidatorUpdate(
                        power=power,
                        pub_key_bytes=base64.b64decode(key),
                        pub_key_type="ed25519"))
                else:
                    self._staged.append((key, value))
                staged_count += 1
                results.append(at.ExecTxResult(
                    code=CODE_OK,
                    events=[at.Event(type="app", attributes=[
                        at.EventAttribute("key", key, True),
                        at.EventAttribute("noindex_key", key, False),
                    ])]))
            new_hash = (self.tx_count + staged_count).to_bytes(8, "big")
            self._staged_count = staged_count
            self._pending_height = req.height
            self._pending_hash = new_hash
            return at.FinalizeBlockResponse(
                tx_results=results,
                validator_updates=list(self._staged_vals),
                app_hash=new_hash)

    def commit(self, req):
        with self._lock:
            for k, v in self._staged:
                self.kv[k] = v
            for vu in self._staged_vals:
                b64 = base64.b64encode(vu.pub_key_bytes).decode()
                self.validator_updates[b64] = vu.power
            self.tx_count += getattr(self, "_staged_count", 0)
            self._staged = []
            self._staged_vals = []
            self._staged_count = 0
            self.height = getattr(self, "_pending_height", self.height + 1)
            self.app_hash = getattr(self, "_pending_hash", self.app_hash)
            # clear so a commit without a preceding finalize_block falls
            # back to height+1 instead of replaying stale pending state
            for attr in ("_pending_height", "_pending_hash"):
                if hasattr(self, attr):
                    delattr(self, attr)
            if self.height % self.snapshot_interval == 0:
                self._snapshots[self.height] = self._snapshot_bytes()
                for h in sorted(self._snapshots)[:-self.snapshot_keep]:
                    del self._snapshots[h]
            return at.CommitResponse(retain_height=0)

    # -- statesync ---------------------------------------------------------

    SNAPSHOT_CHUNK = 65536

    def _snapshot_bytes(self) -> bytes:
        with self._lock:
            return json.dumps({
                "height": self.height,
                "app_hash": self.app_hash.hex(),
                "tx_count": self.tx_count,
                "kv": self.kv,
                "validators": self.validator_updates,
            }, sort_keys=True).encode()

    def list_snapshots(self, req):
        with self._lock:
            out = []
            for h, blob in sorted(self._snapshots.items()):
                n_chunks = max(1, (len(blob) + self.SNAPSHOT_CHUNK - 1)
                               // self.SNAPSHOT_CHUNK)
                out.append(at.Snapshot(height=h, format=1, chunks=n_chunks,
                                       hash=sum_sha256(blob)))
            return at.ListSnapshotsResponse(snapshots=out)

    def offer_snapshot(self, req):
        if req.snapshot.format != 1:
            return at.OfferSnapshotResponse(
                result=at.OFFER_SNAPSHOT_REJECT_FORMAT)
        self._restore = {"snapshot": req.snapshot, "chunks": {},
                         "app_hash": req.app_hash}
        return at.OfferSnapshotResponse(result=at.OFFER_SNAPSHOT_ACCEPT)

    def load_snapshot_chunk(self, req):
        blob = self._snapshots.get(req.height)
        if blob is None or req.format != 1:
            return at.LoadSnapshotChunkResponse()
        start = req.chunk * self.SNAPSHOT_CHUNK
        return at.LoadSnapshotChunkResponse(
            chunk=blob[start:start + self.SNAPSHOT_CHUNK])

    def apply_snapshot_chunk(self, req):
        rst = getattr(self, "_restore", None)
        if rst is None:
            return at.ApplySnapshotChunkResponse(
                result=at.APPLY_CHUNK_ABORT)
        rst["chunks"][req.index] = req.chunk
        snap = rst["snapshot"]
        if len(rst["chunks"]) < snap.chunks:
            return at.ApplySnapshotChunkResponse(
                result=at.APPLY_CHUNK_ACCEPT)
        blob = b"".join(rst["chunks"][i] for i in range(snap.chunks))
        if sum_sha256(blob) != snap.hash:
            self._restore = None
            return at.ApplySnapshotChunkResponse(
                result=at.APPLY_CHUNK_RETRY_SNAPSHOT)
        state = json.loads(blob)
        with self._lock:
            self.kv = dict(state["kv"])
            self.height = state["height"]
            self.app_hash = bytes.fromhex(state["app_hash"])
            self.tx_count = state["tx_count"]
            self.validator_updates = dict(state["validators"])
            self._snapshots[self.height] = blob
        self._restore = None
        return at.ApplySnapshotChunkResponse(result=at.APPLY_CHUNK_ACCEPT)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _parse_tx(tx: bytes):
        """-> ("kv", key, value) | ("val", b64_pubkey, power_str) | None."""
        try:
            s = tx.decode()
        except UnicodeDecodeError:
            return None
        if s.startswith(VALIDATOR_TX_PREFIX):
            rest = s[len(VALIDATOR_TX_PREFIX):]
            if "!" not in rest:
                return None
            b64, _, power = rest.rpartition("!")
            try:
                base64.b64decode(b64, validate=True)
                int(power)
            except Exception:  # noqa: BLE001
                return None
            return "val", b64, power
        if "=" not in s:
            return None
        key, _, value = s.partition("=")
        if not key or not value:
            return None
        return "kv", key, value
