"""Block validation against state (the port's copy of
`cometbft_tpu.state.validation`; CometBFT state/validation.go).

validate_block checks every header field against the current state and
verifies the LastCommit on `device`: `state.last_validators.verify_commit`
(validation.go:94) checks every signature, one RLC program on the card
(K1-K4) for the verdict cache's misses from the batch thresholds on.
Without a card it raises unless given device="cpu".
"""

from __future__ import annotations

from ..ops import device as devmod
from ..types.block import Block
from .state import State

ADDRESS_SIZE = 20


class InvalidBlockError(Exception):
    pass


def validate_block(state: State, block: Block, device="cuda") -> None:
    devmod.resolve(device)
    block.validate_basic()

    if (block.header.version.app != state.version.consensus.app
            or block.header.version.block != state.version.consensus.block):
        raise InvalidBlockError(
            f"wrong Block.Header.Version: expected "
            f"{state.version.consensus}, got {block.header.version}")
    if block.header.chain_id != state.chain_id:
        raise InvalidBlockError(
            f"wrong Block.Header.ChainID: expected {state.chain_id}, "
            f"got {block.header.chain_id}")
    if state.last_block_height == 0 and \
            block.header.height != state.initial_height:
        raise InvalidBlockError(
            f"wrong Block.Header.Height: expected {state.initial_height} "
            f"for initial block, got {block.header.height}")
    if state.last_block_height > 0 and \
            block.header.height != state.last_block_height + 1:
        raise InvalidBlockError(
            f"wrong Block.Header.Height: expected "
            f"{state.last_block_height + 1}, got {block.header.height}")

    if block.header.last_block_id != state.last_block_id:
        raise InvalidBlockError(
            f"wrong Block.Header.LastBlockID: expected "
            f"{state.last_block_id}, got {block.header.last_block_id}")

    if block.header.app_hash != state.app_hash:
        raise InvalidBlockError(
            f"wrong Block.Header.AppHash: expected "
            f"{state.app_hash.hex()}, got {block.header.app_hash.hex()}")
    if block.header.consensus_hash != state.consensus_params.hash():
        raise InvalidBlockError("wrong Block.Header.ConsensusHash")
    if block.header.last_results_hash != state.last_results_hash:
        raise InvalidBlockError("wrong Block.Header.LastResultsHash")
    if block.header.validators_hash != state.validators.hash(device=device):
        raise InvalidBlockError("wrong Block.Header.ValidatorsHash")
    if block.header.next_validators_hash != \
            state.next_validators.hash(device=device):
        raise InvalidBlockError("wrong Block.Header.NextValidatorsHash")

    # LastCommit: none at the initial height, verified (batched, on
    # device) afterwards — validation.go:88-99
    if block.header.height == state.initial_height:
        if block.last_commit and block.last_commit.signatures:
            raise InvalidBlockError(
                "initial block can't have LastCommit signatures")
    else:
        state.last_validators.verify_commit(
            state.chain_id, state.last_block_id,
            block.header.height - 1, block.last_commit, device=device)

    if len(block.header.proposer_address) != ADDRESS_SIZE:
        raise InvalidBlockError(
            f"expected ProposerAddress size {ADDRESS_SIZE}, got "
            f"{len(block.header.proposer_address)}")
    if not state.validators.has_address(block.header.proposer_address):
        raise InvalidBlockError(
            f"proposer {block.header.proposer_address.hex()} is not a "
            "validator")

    # block time rules (validation.go:118-150)
    h, t = block.header.height, block.header.time
    if h > state.initial_height:
        if t.diff_ns(state.last_block_time) <= 0:
            raise InvalidBlockError(
                f"block time {t} not greater than last block time "
                f"{state.last_block_time}")
        if not state.consensus_params.pbts_enabled(h):
            median = block.last_commit.median_time(state.last_validators)
            if t != median:
                raise InvalidBlockError(
                    f"invalid block time: expected {median}, got {t}")
    elif h == state.initial_height:
        if t.diff_ns(state.last_block_time) < 0:
            raise InvalidBlockError(
                f"block time {t} is before genesis time "
                f"{state.last_block_time}")
    else:
        raise InvalidBlockError(
            f"block height {h} lower than initial height "
            f"{state.initial_height}")

    # evidence size cap (validation.go:152-156)
    max_bytes = state.consensus_params.evidence.max_bytes
    got = sum(len(ev.bytes_()) for ev in block.evidence)
    if got > max_bytes:
        raise InvalidBlockError(
            f"evidence bytes {got} exceed max {max_bytes}")
