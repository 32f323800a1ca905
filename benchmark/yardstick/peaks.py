# Copied from chip_smoke.py (HBM_BYTES_PER_S, PEAK_FLOPS, bound).
"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates) and
the least time the card could take for a piece of work."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    """The larger of the operations over the peak rate of their type and the
    bytes over the memory rate, in seconds."""
    return max(flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S)


def share_pct(least_s: float, took_s: float):
    """``least_s`` over ``took_s`` in percent; None where nothing was timed."""
    if took_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / took_s
