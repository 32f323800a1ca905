"""The reduction of a ``torch.profiler`` window to what the per-layer metrics
read: the device's operations with their times, the host's operations,
the busy time, the kernel time of named kernels and the breakdown.

A traced part is a dict: ``device`` [(name, start_us, end_us)] of every
operation on the device (kernels, copies, sets), ``host`` [(name,
start_us, end_us)] of the host's operations, ``wall_s`` the part's seconds
on the host's clock between two device synchronizes, and ``work``, what the
benchmark counted of the layers' calls inside the part.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

Op = Tuple[str, float, float]

#: kernels of PyTorch's elementwise passes (TensorIterator's kernels)
ELEMENTWISE = ("elementwise_kernel",)


def split_events(prof) -> Tuple[List[Op], List[Op]]:
    """(device ops, host ops) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        op = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(op)
        elif e.device_type == DeviceType.CPU:
            host.append(op)
    return device, host


def busy_us(ops: Iterable[Op]) -> float:
    """Microseconds in which at least one device operation ran."""
    total, end = 0.0, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def matching_us(ops: Iterable[Op], patterns: Sequence[str]) -> float:
    """Summed microseconds of the operations whose name holds a pattern."""
    return sum(e - s for name, s, e in ops if any(p in name for p in patterns))


def device_us(ops: Iterable[Op]) -> float:
    return sum(e - s for _, s, e in ops)


def idle_gaps(device: List[Op], host: List[Op], min_us: float = 20.0) -> Dict[str, float]:
    """Idle gaps of the device longer than ``min_us``, summed in seconds by
    the innermost host operation running at the gap's middle."""
    out: Dict[str, float] = defaultdict(float)
    ops = sorted(device, key=lambda o: o[1])
    host = sorted(host, key=lambda o: o[1])
    starts = [h[1] for h in host]
    end = None
    for _, s, e in ops:
        if end is not None and s - end > min_us:
            mid = (s + end) / 2
            # host operations nest: the latest started that still runs is innermost
            name = "(no host op)"
            for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, -4000), -1):
                if host[i][2] >= mid:
                    name = host[i][0]
                    break
            out[name] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    return dict(out)


def breakdown(parts: List[dict], top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, in seconds of one request: each traced part
    counted as often as a request runs it (its ``weight``)."""
    by_op: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    for p in parts:
        w = p.get("weight", 1.0)
        for name, s, e in p["device"]:
            by_op[name[:120]] += w * (e - s) / 1e6
        for name, sec in idle_gaps(p["device"], p["host"]).items():
            gaps[name[:120]] += w * sec
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
