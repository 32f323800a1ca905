"""What the metric readers share: the statistics of a run's window and the
shares of a roofline or a peak, taken from the traced parts. Each reader
returns None where the run holds nothing for it."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional, Sequence

from . import trace
from .peaks import PEAK_FLOPS, bound_s, share_pct
from .work import k1_work, k2_work, k3_work

def per_clip_stage(run: dict, stages: Sequence[str]) -> Optional[float]:
    """The median over the window's requests of the summed seconds of
    ``stages`` (the pipeline's own stage timings), per clip."""
    window = run.get("window") or {}
    times = window.get("stage_s") or {}
    if not all(s in times for s in stages) or not window.get("requests"):
        return None
    per_request = [sum(v) for v in zip(*(times[s] for s in stages))]
    clips_per_request = window["clips"] / window["requests"]
    return statistics.median(per_request) / clips_per_request


def window_mfu(run: dict) -> Optional[float]:
    """The window's model FLOPs over its seconds, as a share of the bf16 peak."""
    window = run.get("window") or {}
    if not window.get("flops") or not window.get("seconds"):
        return None
    return 100.0 * window["flops"] / window["seconds"] / PEAK_FLOPS["bf16"]


def device_share(run: dict, select: Callable[[str], bool]) -> Optional[float]:
    """The share of a request's device time in operations whose name
    ``select`` takes: each traced part counted as often as a request runs
    it (its ``weight``)."""
    parts = run.get("parts") or []
    total = sum(p["weight"] * trace.device_us(p["device"]) for p in parts)
    if total <= 0:
        return None
    part = sum(p["weight"] * (e - s) for p in parts for name, s, e in p["device"]
               if select(name))
    return 100.0 * part / total


def idle_pct(run: dict) -> Optional[float]:
    """The share of a request's wall time in which the device ran nothing,
    each traced part counted as often as a request runs it."""
    parts = run.get("parts") or []
    wall = sum(p["weight"] * p["wall_s"] for p in parts)
    if wall <= 0 or not any(p["device"] for p in parts):
        return None
    busy = sum(p["weight"] * trace.busy_us(p["device"]) for p in parts) / 1e6
    return 100.0 * (1.0 - busy / wall)


def k1_forward_roofline(run: dict, kernels: Sequence[str],
                        module: str = "unet") -> Optional[float]:
    """The least time of the profiled UNet forwards' grouped convs over the
    device time of ``kernels``, the kernels that ran them."""
    config = run["config"][module]
    least = took = 0.0
    for p in run.get("parts") or []:
        shapes = p.get("work", {}).get("forwards", {}).get(module, [])
        for b, h, w, _ in shapes:
            k = k1_work(config, b, h, w)
            least += bound_s(k["flops"], k["bytes"], "bf16")
        if shapes:
            took += trace.matching_us(p["device"], kernels) / 1e6
    return share_pct(least, took)


def fgla_roofline(run: dict, kernels: Sequence[str]) -> Optional[float]:
    """The least time of Griffin-Lim's frame passes and overlap-adds over the
    device time of ``kernels``, the kernels that did them: per iteration one
    of each, plus the seed's frame pass."""
    least = took = 0.0
    for p in run.get("parts") or []:
        g: Dict = p.get("work", {}).get("fgla")
        if not g:
            continue
        k2 = k2_work(g["rows"], g["frames"], g["n_fft"], g["item"])
        k3 = k3_work(g["rows"], g["frames"], g["n_fft"], g["hop"], g["item"])
        least += (g["iters"] + 1) * bound_s(k2["flops"], k2["bytes"], "fp32")
        least += g["iters"] * bound_s(k3["flops"], k3["bytes"], "fp32")
        took += trace.matching_us(p["device"], kernels) / 1e6
    return share_pct(least, took)
