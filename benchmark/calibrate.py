#!/usr/bin/env python3
"""Readings that the limits of a cell's correctness check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... --control-seeds 1 2 3

For each seed, in one process: the port's models from that seed, one
request of the cell's traffic, and the gaps of its checked rows from the
plain reference (the lower readings); for each control seed, the gaps of
the control (the reference in the precision below the configuration's) in
the port's place (the upper readings). Prints one JSON line per reading
and a summary: the largest gap of the port's runs and the smallest of the
control's, per number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seeds, control_seeds, device: str = "cuda", root: Path = ROOT,
             log=print) -> dict:
    sys.path.insert(0, str(ROOT))
    from benchmark import common
    spec = common.benchmark_spec(root)
    here = root / "benchmark"
    w = common.workload(spec, cell)
    config = common.config_file(spec, w["config"], root)
    traffic = common.traffic_file(w["traffic"], here)
    entry = common.entry(traffic["entry"], here)
    out = {"port": [], "control": []}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        session = entry.Session(config, traffic, seed, device)
        session.window(0.0)
        session.free()
        pick = common.seeds(seed, 2)[0]
        t1 = time.perf_counter()
        if seed in seeds:
            gaps = session.check(pick, detail=True)
            out["port"].append(gaps)
            log(json.dumps({"cell": cell, "seed": seed, "side": "port", "gaps": gaps,
                            "check_s": time.perf_counter() - t1, "run_s": t1 - t0}))
        if seed in control_seeds:
            t2 = time.perf_counter()
            gaps = session.check(pick, control=True, detail=True)
            out["control"].append(gaps)
            log(json.dumps({"cell": cell, "seed": seed, "side": "control", "gaps": gaps,
                            "check_s": time.perf_counter() - t2}))
        del session
    keys = sorted({k for g in out["port"] + out["control"] for k in g
                   if isinstance(g[k], float)})
    summary = {k: {"port_max": max((g[k] for g in out["port"]), default=None),
                   "control_min": min((g[k] for g in out["control"]), default=None)}
               for k in keys}
    log(json.dumps({"cell": cell, "summary": summary}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.control_seeds, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
