"""The Application interface + no-op base (the port's copy of
`cometbft_tpu.abci.application`; CometBFT abci/types/application.go).

An application implements the replicated deterministic state machine.
All methods take and return the dataclasses in abci.types; consensus
calls them through a client (in-proc or socket), never directly.
"""

from __future__ import annotations

from . import types as at


class Application:
    """The ABCI++ surface."""

    # info/query connection
    def info(self, req: at.InfoRequest) -> at.InfoResponse: ...
    def query(self, req: at.QueryRequest) -> at.QueryResponse: ...

    # mempool connection
    def check_tx(self, req: at.CheckTxRequest) -> at.CheckTxResponse: ...

    # consensus connection
    def init_chain(self, req: at.InitChainRequest
                   ) -> at.InitChainResponse: ...
    def prepare_proposal(self, req: at.PrepareProposalRequest
                         ) -> at.PrepareProposalResponse: ...
    def process_proposal(self, req: at.ProcessProposalRequest
                         ) -> at.ProcessProposalResponse: ...
    def finalize_block(self, req: at.FinalizeBlockRequest
                       ) -> at.FinalizeBlockResponse: ...
    def extend_vote(self, req: at.ExtendVoteRequest
                    ) -> at.ExtendVoteResponse: ...
    def verify_vote_extension(self, req: at.VerifyVoteExtensionRequest
                              ) -> at.VerifyVoteExtensionResponse: ...
    def commit(self, req: at.CommitRequest) -> at.CommitResponse: ...

    # state sync connection
    def list_snapshots(self, req: at.ListSnapshotsRequest
                       ) -> at.ListSnapshotsResponse: ...
    def offer_snapshot(self, req: at.OfferSnapshotRequest
                       ) -> at.OfferSnapshotResponse: ...
    def load_snapshot_chunk(self, req: at.LoadSnapshotChunkRequest
                            ) -> at.LoadSnapshotChunkResponse: ...
    def apply_snapshot_chunk(self, req: at.ApplySnapshotChunkRequest
                             ) -> at.ApplySnapshotChunkResponse: ...


class BaseApplication(Application):
    """Accept-everything defaults (abci/types/application.go BaseApplication)."""

    def info(self, req):
        return at.InfoResponse()

    def query(self, req):
        return at.QueryResponse()

    def check_tx(self, req):
        return at.CheckTxResponse()

    def init_chain(self, req):
        return at.InitChainResponse()

    def prepare_proposal(self, req):
        # default: propose the raw mempool txs, trimmed to max_tx_bytes
        txs, total = [], 0
        for tx in req.txs:
            total += len(tx)
            if req.max_tx_bytes and total > req.max_tx_bytes:
                break
            txs.append(tx)
        return at.PrepareProposalResponse(txs=txs)

    def process_proposal(self, req):
        return at.ProcessProposalResponse(status=at.PROCESS_PROPOSAL_ACCEPT)

    def finalize_block(self, req):
        return at.FinalizeBlockResponse(
            tx_results=[at.ExecTxResult() for _ in req.txs])

    def extend_vote(self, req):
        return at.ExtendVoteResponse()

    def verify_vote_extension(self, req):
        return at.VerifyVoteExtensionResponse(
            status=at.VERIFY_VOTE_EXT_ACCEPT)

    def commit(self, req):
        return at.CommitResponse()

    def list_snapshots(self, req):
        return at.ListSnapshotsResponse()

    def offer_snapshot(self, req):
        return at.OfferSnapshotResponse()

    def load_snapshot_chunk(self, req):
        return at.LoadSnapshotChunkResponse()

    def apply_snapshot_chunk(self, req):
        return at.ApplySnapshotChunkResponse()
