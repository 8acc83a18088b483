"""Light-block providers (the port's copy of `cometbft_tpu.light.provider`;
CometBFT light/provider).

A provider is what the client fetches LightBlocks through.  HttpProvider
speaks a full node's JSON-RPC /commit and /validators endpoints (CometBFT
light/provider/http); MemoryProvider serves a dict.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Protocol

from ..ops import device as devmod
from .types import LightBlock


class ProviderError(Exception):
    pass


class ErrLightBlockNotFound(ProviderError):
    pass


class ErrNoResponse(ProviderError):
    pass


class ErrHeightTooHigh(ProviderError):
    pass


class ErrBadLightBlock(ProviderError):
    pass


class Provider(Protocol):
    def light_block(self, height: int) -> LightBlock:
        """The light block at height (0 = the latest); raises
        ProviderError subclasses."""
        ...

    def chain_id(self) -> str: ...

    def report_evidence(self, ev) -> None:
        """Send misbehaviour evidence to this provider's node."""
        ...


class MemoryProvider:
    """Serves the blocks it was given."""

    def __init__(self, chain_id: str,
                 blocks: dict[int, LightBlock] | None = None):
        self._chain_id = chain_id
        self._blocks: dict[int, LightBlock] = dict(blocks or {})
        self.reported_evidence: list = []

    def add(self, lb: LightBlock) -> None:
        self._blocks[lb.height] = lb

    def report_evidence(self, ev) -> None:
        self.reported_evidence.append(ev)

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            if not self._blocks:
                raise ErrLightBlockNotFound("no blocks")
            height = max(self._blocks)
        lb = self._blocks.get(height)
        if lb is None:
            if self._blocks and height > max(self._blocks):
                raise ErrHeightTooHigh(str(height))
            raise ErrLightBlockNotFound(str(height))
        return lb


class HttpProvider:
    """A full node's JSON-RPC /commit and /validators (paged), each light
    block checked with validate_basic, its set hashed on `device`."""

    def __init__(self, chain_id: str, base_url: str, timeout: float = 10.0,
                 device="cuda"):
        self._chain_id = chain_id
        self._base = base_url.rstrip("/")
        self._timeout = timeout
        self.device = devmod.resolve(device)

    def chain_id(self) -> str:
        return self._chain_id

    def _rpc(self, path: str, params: dict) -> dict:
        qs = "&".join(f"{k}={v}" for k, v in params.items())
        url = f"{self._base}/{path}?{qs}" if qs else f"{self._base}/{path}"
        try:
            with urllib.request.urlopen(url, timeout=self._timeout) as resp:
                body = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 - a failed request is no response
            raise ErrNoResponse(str(e)) from e
        if "error" in body and body["error"]:
            msg = str(body["error"])
            if "height" in msg and "must be less" in msg:
                raise ErrHeightTooHigh(msg)
            raise ErrLightBlockNotFound(msg)
        return body["result"]

    def light_block(self, height: int) -> LightBlock:
        from ..types.validator_set import ValidatorSet
        from .rpc_decode import signed_header_from_rpc, validators_from_rpc

        hparam = {} if height == 0 else {"height": height}
        commit_res = self._rpc("commit", hparam)
        sh = signed_header_from_rpc(commit_res["signed_header"])
        # the validators query names the commit's height: with "latest" a
        # new block could land between the two requests
        vparam = {"height": sh.height}
        vals = []
        page, per_page = 1, 100
        while True:
            res = self._rpc("validators", {**vparam, "page": page,
                                           "per_page": per_page})
            batch = validators_from_rpc(res["validators"])
            if not batch:
                raise ErrBadLightBlock(
                    f"validators page {page} empty with "
                    f"{len(vals)}/{res['total']} fetched")
            vals.extend(batch)
            if len(vals) >= int(res["total"]):
                break
            page += 1
        lb = LightBlock(sh, ValidatorSet.from_validated(vals))
        try:
            lb.validate_basic(self._chain_id, device=self.device)
        except ValueError as e:
            raise ErrBadLightBlock(str(e)) from e
        return lb

    def report_evidence(self, ev) -> None:
        """POST the evidence to the node's /broadcast_evidence."""
        import base64
        from urllib.parse import quote

        from ..types.evidence import evidence_to_proto_wrapped

        wrapped = base64.b64encode(evidence_to_proto_wrapped(ev)).decode()
        self._rpc("broadcast_evidence", {"evidence": quote(wrapped)})
