"""Coalescing light-client serving plane (the port's copy of
`cometbft_tpu.lightserve`): one card-owning node amortizing shared
verify windows across thousands of concurrent light-client sync
requests.

- ``planner``: the deterministic skipping-bisection plan (the 9/16 pivot
  chain light/client.py walks), a hot-trust-height profile, and the
  serialized payload cache (types/part_set.SerializedBlockCache);
- ``coalesce``: the request coalescer: per-height shared verify futures
  deduping identical header-verify work across concurrent requests,
  drained round-robin and flushed as merged windows;
- ``session``: LightServeSession, the facade the fleet driver calls; it
  owns the verify flush (one DeferredSigBatch window per flush through
  the VerifyPipeline under ``sigcache.consumer("lightserve")``);
- ``codec``: payload encode / decode and the client-side
  ``verify_commit`` over the served wire bytes.
"""

from .coalesce import RequestCoalescer, RequestTicket
from .codec import decode_payload, verify_payload
from .planner import TrustPathPlanner, skip_path
from .session import LightServeError, LightServeSession

__all__ = [
    "LightServeError",
    "LightServeSession",
    "RequestCoalescer",
    "RequestTicket",
    "TrustPathPlanner",
    "decode_payload",
    "skip_path",
    "verify_payload",
]
