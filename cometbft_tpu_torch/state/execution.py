"""BlockExecutor: validate + execute decided blocks against the app (the
port's copy of `cometbft_tpu.state.execution`; CometBFT
state/execution.go).

`BlockExecutor(device=)` (default "cuda") is the device of its block
validation (the LastCommit's verify_commit, K1-K4 on the card) and of
its validator-set hashes; without a card it raises unless given
device="cpu".  Consensus hands it the node's CListMempool and
EvidencePool; without them (a block-syncing node, a chain built in
tests) it takes _NopMempoolStub and NopEvidencePool.

apply_block's ordering is the crash-safety contract (execution.go:236):
FinalizeBlock -> SaveFinalizeBlockResponse -> update_state -> app Commit
(mempool locked) -> save state -> fire events (CometBFT also prunes
before the events; the port has no pruner yet).
"""

from __future__ import annotations

from dataclasses import replace

from ..abci import types as at
from ..crypto import encoding as key_encoding
from ..libs.fail import fail_point
from ..libs.protowire import delimited_field_size
from ..ops import device as devmod
from ..types import events as ev
from ..types.block import (
    BLOCK_ID_FLAG_ABSENT, Block, BlockID, Consensus, ExtendedCommit,
)
from ..types.evidence import evidence_to_abci
from ..types.validator_set import Validator, ValidatorSet
from .state import State, make_block, tx_results_hash
from .validation import InvalidBlockError, validate_block

# types/tx.go MaxBlockSizeBytes and overheads
MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MiB
MAX_OVERHEAD_FOR_BLOCK = 11
MAX_HEADER_BYTES = 626
MAX_COMMIT_OVERHEAD_BYTES = 94
MAX_COMMIT_SIG_BYTES = 109


def max_data_bytes(max_bytes: int, ev_size: int, n_vals: int) -> int:
    """types/block.go MaxDataBytes (panics on negative, as the
    reference does — it means block.max_bytes is misconfigured)."""
    cap_ = (max_bytes - MAX_OVERHEAD_FOR_BLOCK - MAX_HEADER_BYTES
            - MAX_COMMIT_OVERHEAD_BYTES
            - n_vals * MAX_COMMIT_SIG_BYTES - ev_size)
    if cap_ < 0:
        raise InvalidBlockError(
            f"negative MaxDataBytes: block.max_bytes {max_bytes} is too "
            f"small for {n_vals} validators + {ev_size} evidence bytes")
    return cap_


def tx_pre_check(state: State):
    """sm.TxPreCheck: reject txs larger than fits an empty block
    (state/tx_filter.go PreCheckMaxBytes)."""
    max_bytes = state.consensus_params.block.max_bytes
    if max_bytes == -1:
        max_bytes = MAX_BLOCK_SIZE_BYTES
    data_cap = max_data_bytes(max_bytes, 0, state.validators.size())

    def pre_check(tx: bytes) -> None:
        size = _proto_size(len(tx))
        if size > data_cap:
            raise ValueError(
                f"tx size {size} exceeds max data bytes {data_cap}")
    return pre_check


def tx_post_check(state: State):
    """sm.TxPostCheck: reject txs wanting more than the block gas
    (state/tx_filter.go PostCheckMaxGas)."""
    max_gas = state.consensus_params.block.max_gas

    def post_check(tx: bytes, res) -> None:
        if max_gas > -1 and res.gas_wanted > max_gas:
            raise ValueError(
                f"gas wanted {res.gas_wanted} exceeds block max gas "
                f"{max_gas}")
    return post_check


class NopEvidencePool:
    """Placeholder evidence pool (sm.EmptyEvidencePool analog)."""

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        return [], 0

    def check_evidence(self, evidence: list) -> None:
        pass

    def update(self, state: State, evidence: list) -> None:
        pass


class _NopMempoolStub:
    """The mempool seam of a node with no mempool (a block-syncing node,
    a chain built in tests): commit() locks and updates nothing.  A
    trimmed copy of `cometbft_tpu.consensus.replay._NopMempoolStub`,
    kept here until the port has consensus/replay.py."""

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return []

    def pre_update(self):
        pass

    def lock(self):
        pass

    def unlock(self):
        pass

    def flush_app_conn(self):
        pass

    def update(self, *a, **k):
        pass


class BlockExecutor:
    """state/execution.go:26-52."""

    def __init__(self, state_store, app_conn_consensus, mempool=None,
                 evidence_pool=None, block_store=None, event_bus=None,
                 device="cuda"):
        self.device = devmod.resolve(device)
        self.store = state_store
        self.proxy_app = app_conn_consensus
        self.mempool = mempool if mempool is not None else _NopMempoolStub()
        self.evpool = evidence_pool or NopEvidencePool()
        self.block_store = block_store
        self.event_bus = event_bus or ev.NopEventBus()
        self._last_validated_hash: bytes | None = None

    def set_event_bus(self, event_bus) -> None:
        self.event_bus = event_bus

    # -- proposal path -----------------------------------------------------
    def create_proposal_block(self, height: int, state: State,
                              last_ext_commit: ExtendedCommit,
                              proposer_addr: bytes) -> Block:
        """Reap mempool + evidence, consult the app's PrepareProposal
        (execution.go:113)."""
        max_bytes = state.consensus_params.block.max_bytes
        empty_max = max_bytes == -1
        if empty_max:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        max_gas = state.consensus_params.block.max_gas

        evidence, ev_size = self.evpool.pending_evidence(
            state.consensus_params.evidence.max_bytes)

        data_cap = max_data_bytes(max_bytes, ev_size,
                                  state.validators.size())
        reap_cap = -1 if empty_max else data_cap
        txs = self.mempool.reap_max_bytes_max_gas(reap_cap, max_gas)
        commit = last_ext_commit.to_commit()
        block = make_block(state, height, txs, commit, evidence,
                           proposer_addr, device=self.device)

        rpp = self.proxy_app.prepare_proposal(at.PrepareProposalRequest(
            max_tx_bytes=data_cap,
            txs=list(txs),
            local_last_commit=self._build_extended_commit_info(
                last_ext_commit, state),
            misbehavior=_misbehavior(evidence),
            height=block.header.height,
            time=block.header.time,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        ))
        new_txs = list(rpp.txs)
        total = sum(_proto_size(len(tx)) for tx in new_txs)
        if total > data_cap:
            raise InvalidBlockError(
                f"PrepareProposal returned {total} tx bytes > cap "
                f"{data_cap}")
        return make_block(state, height, new_txs, commit, evidence,
                          proposer_addr, timestamp=block.header.time,
                          device=self.device)

    def process_proposal(self, block: Block, state: State) -> bool:
        resp = self.proxy_app.process_proposal(at.ProcessProposalRequest(
            hash=block.hash(),
            height=block.header.height,
            time=block.header.time,
            txs=list(block.data.txs),
            proposed_last_commit=self._build_last_commit_info(block, state),
            misbehavior=_misbehavior(block.evidence),
            proposer_address=block.header.proposer_address,
            next_validators_hash=block.header.next_validators_hash,
        ))
        return resp.status == at.PROCESS_PROPOSAL_ACCEPT

    # -- validation --------------------------------------------------------
    def validate_block(self, state: State, block: Block) -> None:
        if self._last_validated_hash != block.hash():
            validate_block(state, block, device=self.device)
            self._last_validated_hash = block.hash()
        self.evpool.check_evidence(block.evidence)

    # -- apply -------------------------------------------------------------
    def apply_block(self, state: State, block_id: BlockID, block: Block,
                    syncing_to_height: int | None = None) -> State:
        if self._last_validated_hash != block.hash():
            validate_block(state, block, device=self.device)
            self._last_validated_hash = block.hash()
        return self._apply_block(state, block_id, block,
                                 syncing_to_height or block.header.height)

    def apply_verified_block(self, state: State, block_id: BlockID,
                             block: Block,
                             syncing_to_height: int | None = None) -> State:
        return self._apply_block(state, block_id, block,
                                 syncing_to_height or block.header.height)

    def _apply_block(self, state: State, block_id: BlockID, block: Block,
                     syncing_to_height: int) -> State:
        abci_response = self.proxy_app.finalize_block(
            at.FinalizeBlockRequest(
                hash=block.hash(),
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
                height=block.header.height,
                time=block.header.time,
                decided_last_commit=self._build_last_commit_info(
                    block, state),
                misbehavior=_misbehavior(block.evidence),
                txs=list(block.data.txs),
                syncing_to_height=syncing_to_height,
            ))
        if len(block.data.txs) != len(abci_response.tx_results):
            raise InvalidBlockError(
                f"expected {len(block.data.txs)} tx results, got "
                f"{len(abci_response.tx_results)}")

        fail_point("exec-after-finalize")

        # save results before commit (crash window covered by handshake)
        self.store.save_finalize_block_response(
            block.header.height, abci_response.to_proto())

        fail_point("exec-after-save-response")

        validator_updates = validate_validator_updates(
            abci_response.validator_updates,
            state.consensus_params.validator)

        new_state = update_state(state, block_id, block, abci_response,
                                 validator_updates)

        # lock mempool, commit app, update mempool (execution.go:405); the
        # app's retain height waits for a pruner, which the port lacks
        self.commit(new_state, block, abci_response)

        self.evpool.update(new_state, block.evidence)

        fail_point("exec-after-app-commit")

        new_state.app_hash = abci_response.app_hash
        self.store.save(new_state)

        fail_point("exec-after-state-save")

        self._fire_events(block, block_id, abci_response, validator_updates)
        return new_state

    def commit(self, state: State, block: Block,
               abci_response: at.FinalizeBlockResponse) -> int:
        """Lock mempool across app Commit, then update the mempool with
        the committed txs (execution.go:405-447)."""
        self.mempool.pre_update()
        self.mempool.lock()
        try:
            self.mempool.flush_app_conn()
            res = self.proxy_app.commit()
            self.mempool.update(block.header.height, list(block.data.txs),
                                abci_response.tx_results,
                                pre_check=tx_pre_check(state),
                                post_check=tx_post_check(state))
            return res.retain_height
        finally:
            self.mempool.unlock()

    # -- vote extensions ---------------------------------------------------
    def extend_vote(self, vote, block: Block, state: State) -> bytes:
        if block.hash() != vote.block_id.hash:
            raise ValueError("vote's hash does not match the block")
        if vote.height != block.header.height:
            raise ValueError("vote and block heights do not match")
        resp = self.proxy_app.extend_vote(at.ExtendVoteRequest(
            hash=vote.block_id.hash,
            height=vote.height,
            time=block.header.time,
            txs=list(block.data.txs),
            proposed_last_commit=self._build_last_commit_info(block, state),
            misbehavior=_misbehavior(block.evidence),
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        ))
        return resp.vote_extension

    def verify_vote_extension(self, vote) -> bool:
        resp = self.proxy_app.verify_vote_extension(
            at.VerifyVoteExtensionRequest(
                hash=vote.block_id.hash,
                validator_address=vote.validator_address,
                height=vote.height,
                vote_extension=vote.extension,
            ))
        return resp.status == at.VERIFY_VOTE_EXT_ACCEPT

    # -- helpers -----------------------------------------------------------
    def _load_validators(self, height: int, state: State) -> ValidatorSet:
        """Validators at an exact height: the live state when it lines
        up, the state store otherwise. Failing loudly on a miss matters —
        a wrong set here mis-attributes votes to the app
        (execution.go:480-486 panics too)."""
        if height == state.last_block_height and \
                state.last_validators is not None:
            return state.last_validators
        if self.store is None:
            raise InvalidBlockError(
                f"no state store to load validators at height {height}")
        return self.store.load_validators(height)

    def _build_last_commit_info(self, block: Block,
                                state: State) -> at.CommitInfo:
        """execution.go:491 BuildLastCommitInfo."""
        if block.header.height == state.initial_height:
            return at.CommitInfo()
        last_vals = self._load_validators(block.header.height - 1, state)
        commit = block.last_commit
        if commit.size() != last_vals.size():
            raise InvalidBlockError(
                f"commit size {commit.size()} != validator set size "
                f"{last_vals.size()} at height {block.header.height}")
        votes = [
            at.VoteInfo(
                validator=at.Validator(address=val.address,
                                       power=val.voting_power),
                block_id_flag=commit.signatures[i].block_id_flag)
            for i, val in enumerate(last_vals.validators)
        ]
        return at.CommitInfo(round=commit.round, votes=votes)

    def _build_extended_commit_info(self, ec: ExtendedCommit,
                                    state: State) -> at.ExtendedCommitInfo:
        """execution.go:553 BuildExtendedCommitInfo."""
        if ec.height < state.initial_height:
            return at.ExtendedCommitInfo()
        val_set = self._load_validators(ec.height, state)
        if val_set is None or ec.size() != val_set.size():
            got = val_set.size() if val_set is not None else 0
            raise InvalidBlockError(
                f"extended commit size {ec.size()} != validator set size "
                f"{got} at height {ec.height}")
        ext_enabled = state.consensus_params.vote_extensions_enabled(
            ec.height)
        votes = []
        for i, val in enumerate(val_set.validators):
            ecs = ec.extended_signatures[i]
            if ecs.block_id_flag != BLOCK_ID_FLAG_ABSENT and \
                    ecs.validator_address != val.address:
                raise InvalidBlockError(
                    f"extended commit sig {i} address mismatch at height "
                    f"{ec.height}")
            ecs.ensure_extension(ext_enabled)
            votes.append(at.ExtendedVoteInfo(
                validator=at.Validator(address=val.address,
                                       power=val.voting_power),
                vote_extension=ecs.extension,
                extension_signature=ecs.extension_signature,
                block_id_flag=ecs.block_id_flag))
        return at.ExtendedCommitInfo(round=ec.round, votes=votes)

    def _fire_events(self, block: Block, block_id: BlockID,
                     abci_response: at.FinalizeBlockResponse,
                     validator_updates: list[Validator]) -> None:
        """execution.go fireEvents: after everything is persisted."""
        bus = self.event_bus
        bus.publish_new_block(ev.EventDataNewBlock(
            block=block, block_id=block_id,
            result_finalize_block=abci_response))
        bus.publish_new_block_header(
            ev.EventDataNewBlockHeader(header=block.header))
        bus.publish_new_block_events(ev.EventDataNewBlockEvents(
            height=block.header.height, events=abci_response.events,
            num_txs=len(block.data.txs)))
        for ev_item in block.evidence:
            bus.publish_new_evidence(ev.EventDataNewEvidence(
                height=block.header.height, evidence=ev_item))
        for i, tx in enumerate(block.data.txs):
            bus.publish_tx(ev.EventDataTx(
                height=block.header.height, index=i, tx=tx,
                result=abci_response.tx_results[i]))
        if validator_updates:
            bus.publish_validator_set_updates(
                ev.EventDataValidatorSetUpdates(
                    validator_updates=validator_updates))


def validate_validator_updates(abci_updates: list[at.ValidatorUpdate],
                               validator_params) -> list[Validator]:
    """execution.go:609 validateValidatorUpdates + PB2TM conversion."""
    out = []
    for vu in abci_updates:
        if vu.power < 0:
            raise InvalidBlockError(
                f"voting power of {vu.pub_key_bytes.hex()} is negative")
        if vu.pub_key_type not in validator_params.pub_key_types:
            raise InvalidBlockError(
                f"unsupported pubkey type {vu.pub_key_type}")
        pub_key = key_encoding.make_pubkey(vu.pub_key_type,
                                           vu.pub_key_bytes)
        out.append(Validator(pub_key, vu.power))
    return out


def update_state(state: State, block_id: BlockID, block: Block,
                 abci_response: at.FinalizeBlockResponse,
                 validator_updates: list[Validator]) -> State:
    """execution.go:639 updateState: roll the deterministic snapshot
    forward one height. AppHash is filled by the caller post-Commit."""
    header = block.header
    n_val_set = state.next_validators.copy()

    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        n_val_set.update_with_change_set(validator_updates)
        # changes apply at height + 2
        last_height_vals_changed = header.height + 1 + 1
    n_val_set.increment_proposer_priority(1)

    next_params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    version = state.version
    if abci_response.consensus_param_updates is not None:
        next_params = state.consensus_params.merge_proto_updates(
            abci_response.consensus_param_updates)
        next_params.validate()
        version = replace(version, consensus=Consensus(
            block=version.consensus.block, app=next_params.version.app))
        last_height_params_changed = header.height + 1

    return State(
        version=version,
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=header.height,
        last_block_id=block_id,
        last_block_time=header.time,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=next_params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=tx_results_hash(abci_response.tx_results),
        app_hash=b"",  # set by caller after app Commit
    )


def _misbehavior(evidence: list) -> list:
    out = []
    for e in evidence:
        out.extend(evidence_to_abci(e))
    return out


def _proto_size(n: int) -> int:
    return delimited_field_size(n)
