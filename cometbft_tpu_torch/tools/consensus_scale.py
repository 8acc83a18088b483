#!/usr/bin/env python3
"""How many in-process consensus nodes one interpreter carries, and at
which timeouts: chip_smoke.py's `consensus` network (_CsNet: full port
nodes over the loopback double, the vote stream at device threshold 1,
the verdict cache off) run for a fixed time at each (nodes, timeouts)
case, with progress sampled every 2 s.

    python3 cometbft_tpu_torch/tools/consensus_scale.py \\
        [--case 16:test] [--case 11:x10] ... [--seconds 45]

Run it as a file, from a checkout (it loads the checkout's chip_smoke.py
by path).  A case is NODES:TIMEOUTS, TIMEOUTS one of `test`
(test_consensus_config: 20-80 ms), `xK` (those times K-fold) or
`default` (ConsensusConfig(): propose 3 s, prevote and precommit 1 s,
commit 1 s).  Needs a card.  Prints one JSON line a case: the lowest and
highest height and the highest round every 2 s, the heights decided and
each one's commit round, votes verified from the stream and inline,
what the reactors did with incoming votes, and the launches.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CASES = ("16:test", "11:test", "16:x10", "16:default", "11:x10",
                 "11:default")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(kind: str):
    from cometbft_tpu_torch.consensus import state as cstate

    if kind == "default":
        return cstate.ConsensusConfig()
    base = cstate.test_consensus_config()
    k = 1.0 if kind == "test" else float(kind.lstrip("x"))
    return cstate.ConsensusConfig(**{
        f: getattr(base, f) * k for f in (
            "timeout_propose", "timeout_propose_delta", "timeout_prevote",
            "timeout_prevote_delta", "timeout_precommit",
            "timeout_precommit_delta", "timeout_commit")})


def run_case(cs, nodes: int, kind: str, seconds: float) -> dict:
    from cometbft_tpu_torch.crypto import dispatch as vd
    from cometbft_tpu_torch.crypto import votestream as vs_mod
    from cometbft_tpu_torch.types import vote_set as vset_mod

    cfg = _config(kind)
    cs._cs_config = lambda: cfg
    cs.CS_NODES = nodes
    vset_mod.reset_verify_paths()
    progress = []
    with vd.VerifyPipeline(device="cuda") as pipe:
        sv = vs_mod.StreamingVerifier(device_threshold=1, pipeline=pipe,
                                      device="cuda")
        sv.start()
        sv.warmed.wait(600)
        net = cs._CsNet(cs._cs_privs(), sv)
        cs._zero_counts()
        t0 = time.perf_counter()
        net.start()
        try:
            while time.perf_counter() - t0 < seconds:
                time.sleep(2)
                hs = [n.cs.height for n in net.nodes]
                progress.append([round(time.perf_counter() - t0, 1),
                                 min(hs), max(hs),
                                 max(n.cs.round for n in net.nodes)])
        finally:
            net.close()
            sv.stop()
    top = min(n.bstore.height() for n in net.nodes)
    paths = sum((n.reactor.vote_paths for n in net.nodes),
                collections.Counter())
    return {"nodes": nodes, "timeouts": kind, "seconds": seconds,
            "decided": top, "commit_rounds": net.rounds(top) if top else [],
            "progress": progress, "votes": vset_mod.verify_paths(),
            "reactor_vote_paths": dict(paths),
            "launches": {k: v for k, v in cs._counts().items() if v}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", action="append",
                    help="NODES:TIMEOUTS (repeatable)")
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("consensus_scale: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from cometbft_tpu_torch.crypto import sigcache

    sigcache.set_enabled(False)
    torch.cuda.set_device(0)
    card = cs.nvidia_smi("name,power.limit")
    for case in args.case or DEFAULT_CASES:
        nodes, kind = case.split(":")
        print(json.dumps({"card": card, **run_case(cs, int(nodes), kind,
                                                   args.seconds)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
