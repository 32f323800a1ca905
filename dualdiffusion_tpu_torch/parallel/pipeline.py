"""GPipe pipeline parallelism over an axis of ranks (JAX:
dualdiffusion_tpu/parallel/pipeline.py).

K shape-preserving stages run one to a rank of the axis, and M
microbatches stream through them on the GPipe schedule: at tick t (0 <= t <
M + K - 1) the rank of stage k runs microbatch t - k, where there is one,
and hands its output to the next rank (``collectives.exchange``); the
bubble is (K - 1) / (M + K - 1). The last stage's outputs are then
broadcast to every rank.

Differences from JAX's ``gpipe``, none of which changes an output: each rank
holds its own stage only (JAX stacks the K stages' parameters and shards
the stack over the axis); a rank computes nothing on a bubble tick (JAX
computes on zeros and discards the result), and nothing is sent that its
receiver would ignore (JAX's ring also hands the last stage's output to
stage 0, which reads its microbatch instead). Forward only, as every JAX
caller runs it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .collectives import Axis, broadcast_from, exchange, start_point_to_point


def _microbatch_at(tick: int, stage: int, num_microbatches: int) -> Optional[int]:
    """The microbatch stage ``stage`` runs at ``tick``, None on a bubble tick."""
    mb = tick - stage
    return mb if 0 <= mb < num_microbatches else None


def gpipe(run: Callable, axis: Axis, num_microbatches: int, new_buffer: Callable) -> None:
    """The GPipe schedule on this rank of ``axis`` (JAX ``gpipe``'s ticks):
    ``run(mb, received)`` for each microbatch ``mb`` this rank's stage takes,
    in order; ``received`` is None on the first stage, which reads its own
    input, and else what the previous stage sent into ``new_buffer()``. What
    ``run`` returns goes to the next stage (the last stage's is ignored).
    Call it on every rank of the axis."""
    k, idx, m = axis.size, axis.rank, num_microbatches
    start_point_to_point(axis)
    state = None
    for t in range(m + k - 1):
        mb = _microbatch_at(t, idx, m)
        sends = []
        if mb is not None:
            out = run(mb, state)
            if idx < k - 1:
                sends = [(out, idx + 1)]
        recvs = []
        if idx > 0 and _microbatch_at(t + 1, idx, m) is not None:
            state = new_buffer()
            recvs = [(state, idx - 1)]
        exchange(axis, sends, recvs)


@torch.no_grad()
def pipeline_apply(fn: Callable, stage, x: torch.Tensor, axis: Axis,
                   num_microbatches: int = 4) -> torch.Tensor:
    """The K stages of ``axis`` applied in turn to ``x`` (B, ...), B a
    multiple of ``num_microbatches``: this rank runs ``fn(stage, x_mb)``, a
    function that keeps its input's shape and dtype, with its own ``stage``
    (its parameters or module). Call it on every rank of the axis with the
    same ``x``; every rank gets the last stage's output. Equals the stages
    applied one after another (JAX ``pipeline_apply``)."""
    b, m = x.shape[0], num_microbatches
    if b % m:
        raise ValueError(f"batch {b} does not divide into {m} microbatches")
    x_mb = x.reshape((m, b // m) + tuple(x.shape[1:]))
    outs = torch.empty_like(x_mb)

    def run(mb, received):
        inp = x_mb[mb] if received is None else received
        out = fn(stage, inp)
        if out.shape != inp.shape or out.dtype != inp.dtype:
            raise ValueError(f"a pipeline stage maps {tuple(inp.shape)} {inp.dtype} to "
                             f"{tuple(out.shape)} {out.dtype}; it must keep both")
        outs[mb] = out
        return out

    gpipe(run, axis, m, lambda: torch.empty_like(x_mb[0]))
    return broadcast_from(outs, axis, axis.size - 1).reshape(x.shape)
