"""sm.State: the deterministic snapshot between blocks (the port's copy
of `cometbft_tpu.state.state`; CometBFT state/state.go:87-121).

State at height H describes the world AFTER applying block H:
validators for H+1+1 (next), H+1 (current), H (last); consensus params
as of H+1; app hash from block H's FinalizeBlock.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..abci import types as at
from ..crypto import merkle
from ..libs import protowire as pw
from ..types.block import Block, BlockID, Consensus, Data, Header, evidence_hash
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.timestamp import Timestamp
from ..types.validator_set import ValidatorSet

# version/version.go: BlockProtocol 11
BLOCK_PROTOCOL = 11
# Our framework version string (reference CMTSemVer "1.0.0-dev")
SOFTWARE_VERSION = "0.1.0-tpu"


@dataclass
class Version:
    """state.Version: consensus (block/app protocol) + software."""
    consensus: Consensus = field(
        default_factory=lambda: Consensus(block=BLOCK_PROTOCOL, app=0))
    software: str = SOFTWARE_VERSION

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .message_field(1, self.consensus.to_proto())
                .string_field(2, self.software).bytes())

    @staticmethod
    def from_proto(payload: bytes) -> "Version":
        r = pw.Reader(payload)
        v = Version()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                v.consensus = Consensus.from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                v.software = r.read_string()
            else:
                r.skip(w)
        return v


@dataclass
class State:
    version: Version = field(default_factory=Version)
    chain_id: str = ""
    initial_height: int = 1

    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time: Timestamp = field(default_factory=Timestamp.zero)

    next_validators: ValidatorSet | None = None
    validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(
        default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def is_empty(self) -> bool:
        return self.validators is None

    def copy(self) -> "State":
        return replace(
            self,
            next_validators=self.next_validators.copy()
            if self.next_validators else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy()
            if self.last_validators else None,
        )

    # -- wire (persisted by StateStore) ------------------------------------

    def to_proto(self) -> bytes:
        w = (pw.Writer()
             .message_field(1, self.version.to_proto())
             .string_field(2, self.chain_id)
             .int_field(14, self.initial_height))
        # field order kept ascending per protowire Writer contract would
        # require renumbering; we mirror the reference's state.proto tags
        # (proto/cometbft/state/v1/types.proto State) where initial_height
        # is tag 14 — sort order on the wire does not matter for proto.
        w.int_field(3, self.last_block_height)
        w.message_field(4, self.last_block_id.to_proto())
        w.message_field(5, self.last_block_time.to_proto())
        if self.next_validators is not None:
            w.message_field(6, self.next_validators.to_proto())
        if self.validators is not None:
            w.message_field(7, self.validators.to_proto())
        if self.last_validators is not None:
            w.message_field(8, self.last_validators.to_proto())
        w.int_field(9, self.last_height_validators_changed)
        w.message_field(10, self.consensus_params.to_proto())
        w.int_field(11, self.last_height_consensus_params_changed)
        w.bytes_field(12, self.last_results_hash)
        w.bytes_field(13, self.app_hash)
        return w.bytes()

    @staticmethod
    def from_proto(payload: bytes) -> "State":
        r = pw.Reader(payload)
        s = State()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                s.version = Version.from_proto(r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                s.chain_id = r.read_string()
            elif f == 3 and w == pw.VARINT:
                s.last_block_height = r.read_int()
            elif f == 4 and w == pw.BYTES:
                s.last_block_id = BlockID.from_proto(r.read_bytes())
            elif f == 5 and w == pw.BYTES:
                s.last_block_time = Timestamp.from_proto(r.read_bytes())
            elif f == 6 and w == pw.BYTES:
                s.next_validators = ValidatorSet.from_proto(r.read_bytes())
            elif f == 7 and w == pw.BYTES:
                s.validators = ValidatorSet.from_proto(r.read_bytes())
            elif f == 8 and w == pw.BYTES:
                s.last_validators = ValidatorSet.from_proto(r.read_bytes())
            elif f == 9 and w == pw.VARINT:
                s.last_height_validators_changed = r.read_int()
            elif f == 10 and w == pw.BYTES:
                s.consensus_params = ConsensusParams.from_proto(
                    r.read_bytes())
            elif f == 11 and w == pw.VARINT:
                s.last_height_consensus_params_changed = r.read_int()
            elif f == 12 and w == pw.BYTES:
                s.last_results_hash = r.read_bytes()
            elif f == 13 and w == pw.BYTES:
                s.app_hash = r.read_bytes()
            elif f == 14 and w == pw.VARINT:
                s.initial_height = r.read_int()
            else:
                r.skip(w)
        return s


def tx_results_hash(tx_results: list) -> bytes:
    """Merkle root of the deterministic subset of each ExecTxResult
    (reference types/results.go NewResults().Hash(); the deterministic
    fields are code/data/gas_wanted/gas_used per
    abci/types.go DeterministicExecTxResult)."""
    stripped = [
        at.ExecTxResult(code=r.code, data=r.data, gas_wanted=r.gas_wanted,
                        gas_used=r.gas_used).to_proto()
        for r in tx_results
    ]
    return merkle.hash_from_byte_slices(stripped)


def make_block(state: State, height: int, txs: list[bytes], last_commit,
               evidence: list, proposer_address: bytes,
               timestamp: Timestamp | None = None, device="cuda"):
    """state.MakeBlock (state/state.go:241): block data + header fields
    drawn from the state; time = genesis (initial), BFT median of the
    last commit, or wall clock under PBTS.  The validator-set hashes
    run on `device` (crypto/merkle.hash_from_byte_slices_device)."""
    if timestamp is None:
        if state.consensus_params.pbts_enabled(height):
            timestamp = Timestamp.now()
        elif height == state.initial_height:
            timestamp = state.last_block_time  # genesis time
        else:
            timestamp = last_commit.median_time(state.last_validators)

    header = Header(
        version=state.version.consensus,
        chain_id=state.chain_id,
        height=height,
        time=timestamp,
        last_block_id=state.last_block_id,
        last_commit_hash=last_commit.hash(),
        data_hash=Data(txs=list(txs)).hash(),
        validators_hash=state.validators.hash(device=device),
        next_validators_hash=state.next_validators.hash(device=device),
        consensus_hash=state.consensus_params.hash(),
        app_hash=state.app_hash,
        last_results_hash=state.last_results_hash,
        evidence_hash=evidence_hash(evidence),
        proposer_address=proposer_address,
    )
    return Block(header=header, data=Data(txs=list(txs)),
                 evidence=list(evidence), last_commit=last_commit)


def make_genesis_state(genesis: GenesisDoc) -> State:
    """state.MakeGenesisState analog: State before any block."""
    genesis.validate_and_complete()
    if genesis.validators:
        vals = ValidatorSet([v.to_validator() for v in genesis.validators])
        next_vals = vals.copy()
        next_vals.increment_proposer_priority(1)
    else:
        # validators come from the app's InitChain response
        vals = None
        next_vals = None
    return State(
        version=Version(consensus=Consensus(
            block=BLOCK_PROTOCOL, app=genesis.consensus_params.version.app)),
        chain_id=genesis.chain_id,
        initial_height=genesis.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=genesis.genesis_time,
        next_validators=next_vals,
        validators=vals,
        last_validators=None,
        last_height_validators_changed=genesis.initial_height,
        consensus_params=genesis.consensus_params,
        last_height_consensus_params_changed=genesis.initial_height,
        last_results_hash=b"",
        app_hash=genesis.app_hash,
    )
