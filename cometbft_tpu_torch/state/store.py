"""StateStore: persists State, historical validator sets, consensus
params, and FinalizeBlock responses (the port's copy of
`cometbft_tpu.state.store`; CometBFT state/store.go).

Space optimization mirrored from the reference (store.go:818-918):
validator sets are stored in full only when they change or at
checkpoint heights; otherwise a stub records `last_height_changed` and
loads chase the pointer.

Key layout (fixed-width big-endian heights, ordered for range prunes):
  b"stateKey"            -> State proto
  b"V:" + be64(h)        -> ValidatorsInfo {last_height_changed, set?}
  b"CP:" + be64(h)       -> ConsensusParamsInfo {last_height_changed, params?}
  b"FB:" + be64(h)       -> FinalizeBlockResponse (opaque proto bytes)
"""

from __future__ import annotations

from ..libs import lockrank
from ..libs import protowire as pw
from ..store.kv import KVStore, be64
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet
from .state import State

VALSET_CHECKPOINT_INTERVAL = 100_000  # state/store.go valSetCheckpointInterval

_K_STATE = b"stateKey"


def _k_vals(h: int) -> bytes:
    return b"V:" + be64(h)


def _k_params(h: int) -> bytes:
    return b"CP:" + be64(h)


def _k_fbresp(h: int) -> bytes:
    return b"FB:" + be64(h)


def _info_bytes(last_height_changed: int, payload: bytes | None) -> bytes:
    w = pw.Writer().int_field(1, last_height_changed)
    if payload is not None:
        w.message_field(2, payload)
    return w.bytes()


def _info_parse(raw: bytes) -> tuple[int, bytes | None]:
    r = pw.Reader(raw)
    lhc, payload = 0, None
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1 and w == pw.VARINT:
            lhc = r.read_int()
        elif f == 2 and w == pw.BYTES:
            payload = r.read_bytes()
        else:
            r.skip(w)
    return lhc, payload


class StateStore:
    def __init__(self, db: KVStore):
        self._db = db
        self._mtx = lockrank.RankedRLock("state.store")

    # -- State -------------------------------------------------------------

    def load(self) -> State | None:
        raw = self._db.get(_K_STATE)
        return State.from_proto(raw) if raw is not None else None

    def save(self, state: State) -> None:
        """SaveState: state + next/current validator info + params info in
        ONE atomic batch (state/store.go:249-294 uses a single db batch so
        a crash can never leave the state record and the validator history
        out of sync)."""
        with self._mtx:
            sets: list[tuple[bytes, bytes]] = []
            next_height = state.last_block_height + 1
            if next_height == 1:
                next_height = state.initial_height
                # genesis bootstrap: record validators for the initial height
                self._validators_entry(
                    sets, next_height, next_height, state.validators)
            self._validators_entry(
                sets, next_height + 1, state.last_height_validators_changed,
                state.next_validators)
            self._params_entry(
                sets, next_height, state.last_height_consensus_params_changed,
                state.consensus_params)
            sets.append((_K_STATE, state.to_proto()))
            self._db.write_batch(sets)

    def bootstrap(self, state: State) -> None:
        """node.BootstrapState analog: seed a store from a trusted state
        (statesync landing point; state/store.go:320)."""
        with self._mtx:
            sets: list[tuple[bytes, bytes]] = []
            height = state.last_block_height + 1
            if height == 1:
                height = state.initial_height
            if height > 1 and state.last_validators is not None:
                self._validators_entry(
                    sets, height - 1, height - 1, state.last_validators)
            self._validators_entry(sets, height, height, state.validators)
            self._validators_entry(
                sets, height + 1, height + 1, state.next_validators)
            self._params_entry(
                sets, height, state.last_height_consensus_params_changed,
                state.consensus_params)
            sets.append((_K_STATE, state.to_proto()))
            self._db.write_batch(sets)

    # -- validators --------------------------------------------------------

    def _validators_entry(self, sets: list, height: int,
                          last_height_changed: int,
                          vals: ValidatorSet | None) -> None:
        if vals is None:
            return
        if last_height_changed > height:
            raise ValueError("lastHeightChanged cannot be greater than "
                             "ValidatorsInfo height")
        # full set only on change or checkpoint (store.go:894-906)
        store_set = (height == last_height_changed
                     or height % VALSET_CHECKPOINT_INTERVAL == 0)
        payload = vals.to_proto() if store_set else None
        sets.append((_k_vals(height),
                     _info_bytes(last_height_changed, payload)))

    def load_validators(self, height: int) -> ValidatorSet:
        """LoadValidators with pointer chase (store.go:822-870)."""
        raw = self._db.get(_k_vals(height))
        if raw is None:
            raise KeyError(f"no validator set for height {height}")
        lhc, payload = _info_parse(raw)
        if payload is None:
            raw2 = self._db.get(_k_vals(lhc))
            if raw2 is None:
                raise KeyError(
                    f"validators pointer at {height} -> {lhc} dangling")
            _, payload = _info_parse(raw2)
            if payload is None:
                raise KeyError(
                    f"validator checkpoint at {lhc} is itself empty")
            vals = ValidatorSet.from_proto(payload)
            # catch the priorities up to `height` like the reference does
            vals.increment_proposer_priority(height - lhc)
            return vals
        return ValidatorSet.from_proto(payload)

    # -- consensus params --------------------------------------------------

    def _params_entry(self, sets: list, height: int,
                      last_height_changed: int,
                      params: ConsensusParams) -> None:
        store_params = height == last_height_changed
        payload = params.to_proto() if store_params else None
        sets.append((_k_params(height),
                     _info_bytes(last_height_changed, payload)))

    def load_consensus_params(self, height: int) -> ConsensusParams:
        raw = self._db.get(_k_params(height))
        if raw is None:
            raise KeyError(f"no consensus params for height {height}")
        lhc, payload = _info_parse(raw)
        if payload is None:
            raw2 = self._db.get(_k_params(lhc))
            if raw2 is None:
                raise KeyError(
                    f"params pointer at {height} -> {lhc} dangling")
            _, payload = _info_parse(raw2)
            if payload is None:
                raise KeyError(f"params at {lhc} is itself empty")
        return ConsensusParams.from_proto(payload)

    # -- FinalizeBlock responses -------------------------------------------

    def save_finalize_block_response(self, height: int,
                                     resp_bytes: bytes) -> None:
        self._db.set(_k_fbresp(height), resp_bytes)

    def load_finalize_block_response(self, height: int) -> bytes | None:
        return self._db.get(_k_fbresp(height))
