#!/usr/bin/env python3
"""Run one cell of the benchmark of dualdiffusion_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell is an entry of ``workloads`` in ``BENCHMARK.json``; what
belongs to it is found by name (``benchmark/common.py``). The run builds
the port's models from the seed on the card and warms them up (set-up),
drives the cell's traffic for ``--seconds`` (the window), and then checks
what the window produced against the plain reference. With ``--trace 1``
it profiles a short part after the window and reports the per-layer
metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``setup_parts`` (where ``setup_s`` went, the kernel
library's build apart) and last ``checks``: each compared number beside
its limit.
The same numbers are the last lines of standard error. Without a card, or
with fewer than the cell asks for, or with JAX loaded, the run prints no
result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "dualdiffusion_tpu")


def fail(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(2)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``dualdiffusion_tpu_torch`` is not ``dualdiffusion_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def no_jax_backends() -> None:
    """Keep libraries that would load JAX by themselves from doing so."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def reported(spec: dict, cell: str, trace: int) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def measure(spec: dict, cell: str, seed: int, seconds: float, trace: int, device: str,
            control: bool = False, root: Path = ROOT) -> dict:
    """Set-up, window, optional trace and check of one run of ``cell``, whose
    files lie under ``root``: the result's object. ``control`` checks the
    control (the reference in a lower precision) in the port's place."""
    import torch
    from benchmark import common
    here = root / "benchmark"
    w = common.workload(spec, cell)
    config = common.config_file(spec, w["config"], root)
    traffic = common.traffic_file(w["traffic"], here)
    limits = common.cell_file(cell, here)["limits"]
    entry = common.entry(traffic["entry"], here)
    on_card = torch.device(device).type == "cuda"

    t_session = time.perf_counter()
    session = entry.Session(config, traffic, seed, device)
    setup_s = time.perf_counter() - T_START
    setup_parts = dict(before_session_s=t_session - T_START, **session.setup_parts,
                       kernel_build_s=kernel_build_s())
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    window = session.window(seconds, timings=bool(trace))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = {"cell": cell, "config": config, "traffic": traffic, "setup_s": setup_s,
           "peak_bytes": peak, "window": window, "parts": session.trace() if trace else []}
    session.free()
    gaps = session.check(common.seeds(seed, 2)[0], control=control)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items() if k in limits}
    missing = sorted(set(limits) - set(gaps))
    if missing:
        raise KeyError(f"the check gave no number for {missing}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in reported(spec, cell, trace):
        value = common.metric_reader(m["name"], here)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window["requests"], "failed": 0 if correct else 1,
           "metrics": metrics, "device": dev}
    if trace:
        from benchmark.yardstick import trace as tr
        dev["busy_s"] = sum(tr.busy_us(p["device"]) for p in run["parts"]) / 1e6
        dev["window_s"] = sum(p["wall_s"] for p in run["parts"])
        out["breakdown"] = tr.breakdown(run["parts"])
    out["setup_parts"] = setup_parts
    out["checks"] = checks
    print("request seconds: " + " ".join(f"{s:.4f}" for s in window.get("request_s", [])),
          file=sys.stderr)
    print("setup parts: " + json.dumps(setup_parts), file=sys.stderr)
    return out


def kernel_build_s():
    """The seconds the port's kernel library took to build in this process
    (nvcc on a checkout's first run, 0 once built), or None where set-up
    never loaded it. A part of ``setup_s``, shown apart."""
    build = sys.modules.get("dualdiffusion_tpu_torch.ops.kernels.build")
    lib = getattr(build, "_LIB", None)
    return None if lib is None else lib.build_seconds


def main(argv=None) -> int:
    args = parse_args(argv)
    no_jax_backends()
    sys.path.insert(0, str(ROOT))
    from benchmark import common
    spec = common.benchmark_spec()
    w = common.workload(spec, args.workload)
    import torch
    # the window's host work is one Python thread launching kernels
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        fail(f"{args.workload} needs {w['chips']} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    out = measure(spec, args.workload, args.seed, args.seconds, args.trace, "cuda")
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
