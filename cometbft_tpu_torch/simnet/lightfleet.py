"""Synthetic light-client fleet driver (the port's copy of
`cometbft_tpu.simnet.lightfleet`, with the coalescing A/B of
`cometbft_tpu.simnet.bench.bench_lightserve_fleet` as ``fleet_ab``):
thousands of clients against one LightServeSession.

Clients arrive with a seeded mix of trust heights (most track near the
tip, a long tail starts from deep history — the profile a real serving
node sees) in a seeded arrival order, fan out over a bounded worker
pool, and each records its serve latency plus a digest of the exact
payload bytes it received.  The combined fleet digest is the parity
oracle for the coalescing A/B: two same-seed runs serving the same
chain must produce IDENTICAL digests whether coalescing is on or off.

``sample_verify`` additionally runs the full client-side
``codec.verify_payload`` (reconstruct commit + valset from the wire
bytes, ``verify_commit`` on the session's device) on a seeded fraction
of clients.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time

from ..crypto import sigcache
from ..libs import lockrank
from ..ops import device as devmod


def fleet_mix(n_clients: int, tip: int, seed: int) -> list[int]:
    """Seeded trust heights for n clients: ~85% within 3 blocks of the
    tip (clients that stay synced), the rest uniform over history
    (fresh installs, long-offline wallets)."""
    rng = random.Random(seed)
    out = []
    lo = max(1, tip - 3)
    for _ in range(n_clients):
        if tip > 2 and rng.random() < 0.85:
            out.append(rng.randint(lo, tip - 1))
        else:
            out.append(rng.randint(1, max(1, tip - 1)))
    return out


def run_fleet(session, n_clients: int, seed: int,
              target: int | None = None, workers: int = 16,
              sample_verify: float = 0.0,
              chain_id: str | None = None,
              deadline_s: float | None = None,
              retry_s: float = 0.05) -> dict:
    """Drive n_clients synthetic sync requests through ``session``.

    Returns clients served, wall seconds, clients/s, latency
    percentiles, the order-independent fleet payload digest, and any
    verification failures.  With ``deadline_s`` set, failed requests
    retry until the deadline (the chaos partition arm); without it a
    failure raises.  Sampled clients verify on the session's device."""
    tip = session.block_store.height() if target is None else target
    trusts = fleet_mix(n_clients, tip, seed)
    order = list(range(n_clients))
    random.Random(seed + 1).shuffle(order)     # seeded arrival process
    verify_rng = random.Random(seed + 2)
    verify_mask = [verify_rng.random() < sample_verify
                   for _ in range(n_clients)]

    digests: list = [b""] * n_clients
    latencies: list = [0.0] * n_clients
    failures: list = []
    served = [0]
    cursor = [0]
    mtx = lockrank.RankedLock("simnet.lightfleet")
    t_start = time.perf_counter()

    def next_index():
        with mtx:
            if cursor[0] >= len(order):
                return None
            i = order[cursor[0]]
            cursor[0] += 1
            return i

    def client(i: int) -> None:
        t0 = time.perf_counter()
        deadline = None if deadline_s is None else t_start + deadline_s
        while True:
            try:
                _, blobs = session.serve(trusts[i], tip)
                break
            except Exception as e:
                if deadline is None or time.perf_counter() >= deadline:
                    raise e
                time.sleep(retry_s)
        latencies[i] = time.perf_counter() - t0
        h = hashlib.sha256()
        for blob in blobs:
            h.update(blob)
        digests[i] = h.digest()
        if verify_mask[i] and chain_id is not None:
            from ..lightserve import verify_payload

            for blob in blobs:
                verify_payload(chain_id, blob, device=session.device)
        with mtx:
            served[0] += 1

    def worker() -> None:
        while True:
            i = next_index()
            if i is None:
                return
            try:
                client(i)
            except Exception as e:
                with mtx:
                    failures.append(f"client {i} (trust {trusts[i]}): "
                                    f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker,
                                name=f"lightfleet-{w}", daemon=True)
               for w in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    lats = sorted(x for x in latencies if x > 0.0)

    def pct(q: float) -> float:
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(q * (len(lats) - 1)))]

    fleet = hashlib.sha256()
    for d in sorted(digests):
        fleet.update(d)
    return {
        "clients": served[0],
        "requested": n_clients,
        "wall_s": wall,
        "clients_per_sec": served[0] / wall if wall else 0.0,
        "p50_ms": pct(0.50) * 1000,
        "p99_ms": pct(0.99) * 1000,
        "digest": fleet.hexdigest(),
        "failures": failures,
        "verified_clients": sum(1 for i, m in enumerate(verify_mask)
                                if m and digests[i]),
    }


def fleet_ab(block_store, state_store, chain_id: str, n_clients: int,
             seed: int, workers: int = 16, device="cuda", *,
             sample_verify: float = 0.0, pipeline=None) -> dict:
    """A/B the coalescer over the same seeded client fleet on stores the
    caller built: arm OFF serves every request through its own verify
    window, arm ON merges overlapping in-flight paths into shared
    flushes, both on `pipeline` (default: the device's default
    pipeline).

    The contract coalescing must hold: every client is served, the fleet
    payload digest is bit-identical across arms (merging windows may not
    change a served byte), and the ON arm dispatches strictly fewer
    verify windows and fewer signature verifies for the same traffic.
    The signature-verdict cache is forced off in both arms, so the
    reduction is the coalescer's alone.  Raises RuntimeError on any
    violation; returns both arms' records and the bench figures
    (light_clients_served_per_sec, light_serve_p99_ms)."""
    from ..lightserve import LightServeSession

    dev = devmod.resolve(device)
    if pipeline is None:
        from ..crypto import dispatch

        pipeline = dispatch.default_pipeline(dev)
    prev_cache_enabled = sigcache._enabled_override
    arms: dict[str, dict] = {}
    try:
        for arm, coalesce in (("off", False), ("on", True)):
            sigcache.set_enabled(False)
            sigcache.reset()
            session = LightServeSession(
                block_store, state_store, chain_id, coalesce=coalesce,
                pipeline=pipeline, device=dev)
            submitted0 = pipeline.submitted
            try:
                rec = run_fleet(session, n_clients, seed, workers=workers,
                                sample_verify=sample_verify,
                                chain_id=chain_id)
            finally:
                session.close()
            rec["verify_windows"] = session.verify_windows
            rec["verify_sigs"] = session.verify_sigs
            rec["failed_heights"] = session.failed_heights
            rec["pipeline_windows"] = pipeline.submitted - submitted0
            arms[arm] = rec
    finally:
        sigcache.set_enabled(prev_cache_enabled)
        sigcache.reset()

    off, on = arms["off"], arms["on"]
    if off["failures"] or on["failures"]:
        raise RuntimeError(
            "lightserve fleet arm had failures: "
            f"off={off['failures'][:3]} on={on['failures'][:3]}")
    if off["clients"] != n_clients or on["clients"] != n_clients:
        raise RuntimeError(
            f"lightserve fleet under-served: off={off['clients']} "
            f"on={on['clients']} of {n_clients}")
    if off["digest"] != on["digest"]:
        raise RuntimeError(
            "coalescing changed served bytes: "
            f"off={off['digest']} on={on['digest']}")
    if not (on["verify_windows"] < off["verify_windows"]
            and on["verify_sigs"] < off["verify_sigs"]):
        raise RuntimeError(
            "coalescing did not reduce verify dispatch: windows "
            f"{off['verify_windows']}->{on['verify_windows']}, sigs "
            f"{off['verify_sigs']}->{on['verify_sigs']}")
    ratio = (on["clients_per_sec"] / off["clients_per_sec"]
             if off["clients_per_sec"] else 0.0)
    return {
        "light_clients_served_per_sec": on["clients_per_sec"],
        "light_serve_p99_ms": on["p99_ms"],
        "coalesce_ratio": ratio,
        "digest_parity": True,
        "digest": on["digest"],
        "clients": n_clients,
        "workers": workers,
        "seed": seed,
        "arms": arms,
    }
