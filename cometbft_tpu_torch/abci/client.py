"""ABCI clients (the port's copy of `cometbft_tpu.abci.client`;
CometBFT abci/client/).

LocalClient makes in-process calls under one mutex
(abci/client/local_client.go).  It exposes the blocking call surface
plus *_async returning a ReqRes future.  The socket client is not
ported yet.
"""

from __future__ import annotations

import threading

from ..libs import lockrank
from . import types as at
from .application import Application


class ABCIClientError(Exception):
    pass


class ReqRes:
    """A pending request's future (abci/client/client.go ReqRes)."""

    def __init__(self, method: str, req):
        self.method = method
        self.request = req
        self.response = None
        self._done = threading.Event()
        self._cb = None
        self._lock = lockrank.RankedLock("abci.reqres")

    def set_callback(self, cb) -> None:
        """cb(response); fires immediately if already done."""
        with self._lock:
            if self.response is not None:
                cb(self.response)
            else:
                self._cb = cb

    def complete(self, response) -> None:
        with self._lock:
            self.response = response
            cb = self._cb
        self._done.set()
        if cb is not None:
            cb(response)

    def wait(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise ABCIClientError(
                f"ABCI {self.method} timed out after {timeout}s")
        return self.response


class ABCIClient:
    """Blocking call surface; subclasses implement _do(method, req)."""

    def _do(self, method: str, req):
        raise NotImplementedError

    def _do_async(self, method: str, req) -> ReqRes:
        rr = ReqRes(method, req)
        rr.complete(self._do(method, req))
        return rr

    # -- sync surface ------------------------------------------------------
    def info(self, req=None) -> at.InfoResponse:
        return self._do("info", req or at.InfoRequest())

    def query(self, req) -> at.QueryResponse:
        return self._do("query", req)

    def flush(self) -> None:
        """Drain buffered requests: the in-process client buffers none
        (the JAX package's LocalClient answers Flush with nothing)."""

    def check_tx(self, req) -> at.CheckTxResponse:
        return self._do("check_tx", req)

    def check_tx_async(self, req) -> ReqRes:
        return self._do_async("check_tx", req)

    def init_chain(self, req) -> at.InitChainResponse:
        return self._do("init_chain", req)

    def prepare_proposal(self, req) -> at.PrepareProposalResponse:
        return self._do("prepare_proposal", req)

    def process_proposal(self, req) -> at.ProcessProposalResponse:
        return self._do("process_proposal", req)

    def finalize_block(self, req) -> at.FinalizeBlockResponse:
        return self._do("finalize_block", req)

    def extend_vote(self, req) -> at.ExtendVoteResponse:
        return self._do("extend_vote", req)

    def verify_vote_extension(self, req) -> at.VerifyVoteExtensionResponse:
        return self._do("verify_vote_extension", req)

    def commit(self) -> at.CommitResponse:
        return self._do("commit", at.CommitRequest())

    def list_snapshots(self, req) -> at.ListSnapshotsResponse:
        return self._do("list_snapshots", req)

    def offer_snapshot(self, req) -> at.OfferSnapshotResponse:
        return self._do("offer_snapshot", req)

    def load_snapshot_chunk(self, req) -> at.LoadSnapshotChunkResponse:
        return self._do("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req) -> at.ApplySnapshotChunkResponse:
        return self._do("apply_snapshot_chunk", req)

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class LocalClient(ABCIClient):
    """In-proc client; one mutex serializes app access
    (local_client.go). Pass shared_lock to mimic the reference's
    one-mutex-across-all-connections default."""

    def __init__(self, app: Application,
                 shared_lock: threading.Lock | None = None):
        self._app = app
        self._lock = shared_lock or lockrank.RankedLock("abci.client")

    def _do(self, method: str, req):
        with self._lock:
            return getattr(self._app, method)(req)
