"""What the harness finds by name: ``BENCHMARK.json`` and, under the
benchmark's folder, a configuration's file, a traffic mix's file, a cell's
limits and a per-layer metric's reader; and the inputs it makes from a
seed: request seeds and weights.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` needs
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``entry``
names the code under ``entries/`` that drives it) and
``cells/<cell>.json`` (the limits of its correctness check). A per-layer metric ``<name>`` is read by
``metrics/<name>.py``. Adding any of them is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_file(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def cell_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "cells" / f"{name}.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name: str, here: Path = HERE):
    """The code that drives a traffic mix's ``entry``: ``entries/<name>.py``."""
    return load_module(here / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def metric_reader(name: str, here: Path = HERE) -> Callable[[dict], object]:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing to read."""
    safe = name.replace(".", "_").replace("-", "_")
    return load_module(here / "metrics" / f"{name}.py", f"benchmark_metric_{safe}").read


def seeds(seed: int, *path: int, n: int = 1) -> list:
    """``n`` 63-bit seeds drawn from ``seed`` and a path of indices."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *path])
    return [int(v) >> 1 for v in ss.generate_state(n, np.uint64)]


def make_weights(shapes: Dict[str, Sequence[int]], seed: int, device) -> Dict[str, "object"]:
    """Weights for parameters of ``shapes`` (name -> shape), made on
    ``device`` from ``seed`` in one call: N(0, 1) for every tensor, and 1 for
    every 0-d parameter, the gains (a zero gain would switch its branch off;
    random gains made the sampler's sensitivity to rounding swing twofold
    from seed to seed). Names are taken in sorted order, so the same names
    and shapes give the same weights."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seeds(seed, 7)[0])
    names = sorted(shapes)
    tensors = [n for n in names if len(shapes[n]) > 0]
    total = sum(int(np.prod(shapes[n])) for n in tensors)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in tensors:
        k = int(np.prod(shapes[n]))
        out[n] = flat[at:at + k].view(tuple(shapes[n]))
        at += k
    for n in names:
        if len(shapes[n]) == 0:
            out[n] = torch.ones((), device=device)
    return out
