"""Spans of the port's own layers on ``torch.profiler``'s clock.

``with span("dd.<layer>.<what>"):`` marks a range of host time. While a
``torch.profiler`` profile runs (the trainer's ``profile_steps``, or any
caller's), the range is recorded as a host operation beside PyTorch's own,
so a trace shows which layer of the program the host was in between two
device operations. It is recorded as an ordinary CPU operation and not as
a user annotation: ``torch.profiler.record_function`` would also put a
``gpu_user_annotation`` range on the device's timeline, which reads as
device work to anything that sums the device's events. With no profile
running a span records nothing and costs well under a microsecond.

Names are fixed strings: ``dd.``, the layer (``pipeline``, ``sampler``,
``model``), then what runs. ``dd.pipeline.generate`` is the root of a
request; every other span nests inside its caller's in time, on the one
host thread, and that nesting is each span's parent.
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast


def span(name: str) -> _RecordFunctionFast:
    """A context manager that records ``name`` as a host operation over the
    ``with`` block while a ``torch.profiler`` profile runs."""
    return _RecordFunctionFast(name)
