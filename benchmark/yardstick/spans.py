"""What the readers of the program's own spans share.

The port marks its layers with ``dd.<layer>.<what>`` spans
(``dualdiffusion_tpu_torch/utils/trace.py``), recorded by ``torch.profiler``
as host operations on the same clock as the device's operations: a traced
part's ``host`` list holds them. Each reader returns None where the parts
hold no span, as a program without them (a parent commit's) gives.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace

PREFIX = "dd."
#: the traced parts that hold a sampler's steps (``entries/generate.py``)
SAMPLER_PARTS = ("unet_steps", "ddec_steps")


def spans(part: dict) -> List[trace.Op]:
    return [h for h in part["host"] if h[0].startswith(PREFIX)]


def idle_by_layer(part: dict) -> Dict[Optional[str], float]:
    """Seconds of the part's idle gaps, however short, by the layer of the
    innermost span open on the host at each gap's middle (None where no
    span is open). ``trace.idle_gaps`` looks back over at most 4000 host
    operations: given the spans alone, that reaches past a whole sampler
    step (about 200 spans a forward in these models)."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for name, sec in trace.idle_gaps(part["device"], spans(part), min_us=0.0).items():
        out[name.split(".")[1] if name.startswith(PREFIX) else None] += sec
    return dict(out)


def idle_pct(run: dict, layer: str) -> Optional[float]:
    """The share of the traced parts' wall time in which the device was idle
    while the host was inside a span of ``layer``, each part counted as
    often as a request runs it (its ``weight``)."""
    parts = run.get("parts") or []
    wall = sum(p["weight"] * p["wall_s"] for p in parts)
    if (wall <= 0 or not any(spans(p) for p in parts)
            or not any(p["device"] for p in parts)):
        return None
    idle = sum(p["weight"] * idle_by_layer(p).get(layer, 0.0) for p in parts)
    return 100.0 * idle / wall


def sampler_spans(run: dict, name: str) -> Tuple[float, float]:
    """(count, summed microseconds) of the spans called ``name`` in the
    sampler parts, each part counted as often as a request runs it."""
    n = us = 0.0
    for p in run.get("parts") or []:
        if p["name"] in SAMPLER_PARTS:
            got = [e - s for span_name, s, e in spans(p) if span_name == name]
            n += p["weight"] * len(got)
            us += p["weight"] * sum(got)
    return n, us
