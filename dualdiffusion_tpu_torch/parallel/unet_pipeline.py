"""GPipe pipeline parallelism over the UNet's op schedule (JAX:
dualdiffusion_tpu/parallel/unet_pipeline.py).

An EDM2 UNet is an hourglass: its levels change channels and resolution,
and the encoder's ops push skip activations that decoder ops pop much
later. ``pipeline.py``'s equal stages do not fit it, so the trunk is cut
along its linear op schedule (``models/unet.py`` ``build_schedule``,
``UNetCore.run_ops``):

* ``build_stage_plan`` splits the schedule into K contiguous ranges of
  about equal cost (out spatial x cin x cout per op, JAX ``_op_costs``; the
  greedy cut of JAX ``_balance``, so the boundaries are JAX's). The state
  at each boundary, x and every skip alive there, follows from the
  schedule and the resampling rules alone.
* The hand-off between stages is that whole state flattened into one
  buffer of the plan's ``payload_len`` (the largest state at a used
  boundary, the rest zero padding) in the trunk's activation dtype
  (``models/unet.py`` ``ACT_DTYPE``: bf16, as JAX's payload).
* Each rank keeps the modules of its own range (``keep_stage``), with
  ``out_gain`` (every JAX stage carries it) and the embedding modules
  ``precondition`` needs, and runs ``run_ops(lo, hi)`` on them.
* The conditioning ``emb`` of every microbatch is on every rank; a stage
  takes its current microbatch's. ``precondition`` and the c_skip / c_out
  combine run on every rank outside the pipeline (``pipelined_denoise``).

Deliberate differences from JAX, none of which changes an output: a rank
computes nothing on a bubble tick (JAX computes on zeros and discards the
result); each rank runs its own range directly (JAX picks it with a
``lax.switch`` on the axis index); the parameters stay in the stage's
modules (JAX ravels each stage's into a row of a stacked buffer); the
first stage takes its microbatch and the last keeps its output without the
payload's round trip (both already in the payload's dtype). Forward only,
as every JAX caller runs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .collectives import Axis, broadcast_from
from .pipeline import gpipe

Shape = Tuple[int, ...]


def _unet():
    # imported on use: models/layers.py imports this package
    from ..models import unet
    return unet


@dataclass
class StagePlan:
    """How one UNetCore is cut into K stages, for microbatches of one shape."""
    boundaries: List[int]                       # K + 1 op indices, [0, ..., n_ops]
    boundary_specs: List[Tuple[Shape, List[Shape]]]   # per op index: (x, [skips]) before it
    payload_len: int                            # the largest state at a used boundary
    stage_ops: List[List[str]]                  # each stage's op (module) names
    stage_param_sizes: List[int]                # its parameters, out_gain included
    n_stages: int


def boundary_state_specs(cfg, x_shape: Sequence[int]) -> List[Tuple[Shape, List[Shape]]]:
    """specs[b]: the shapes of x and of the skips alive before op b of the
    schedule, for a trunk input of ``x_shape`` ((B, [Z,] H, W, C) after
    ``precondition``); specs[n_ops] is the final state (JAX
    ``_boundary_state_specs``, from the schedule instead of a trace)."""
    ops = _unet().build_schedule(cfg)
    lead, (h, w, c) = tuple(x_shape[:-3]), tuple(x_shape[-3:])
    div = 1 << (len(cfg.channel_mult) - 1)
    if h % div or w % div:
        raise ValueError(f"UNet input H,W=({h},{w}) must be divisible by {div} "
                         f"(2^(levels-1), {len(cfg.channel_mult)} levels)")
    if c != ops[0][3]:
        raise ValueError(f"trunk input has {c} channels, the input conv takes {ops[0][3]}")
    skips: List[Shape] = []
    specs = [(lead + (h, w, c), [])]
    for _, kind, _, cin, cout in ops:
        if kind == "enc_down":
            h, w = h // 2, w // 2
        elif kind == "dec_up":
            h, w = h * 2, w * 2
        elif kind == "dec_layer":
            skips.pop()
        x = lead + (h, w, cout)
        if kind in ("enc_in", "enc_down", "enc_layer"):
            skips.append(x)
        specs.append((x, list(skips)))
    return specs


def op_costs(cfg, specs) -> np.ndarray:
    """Per-op cost ~ conv MACs: out spatial (batch included) x cin x cout
    (JAX ``_op_costs``)."""
    ops = _unet().build_schedule(cfg)
    return np.asarray([float(np.prod(specs[b + 1][0][:-1])) * cin * cout
                       for b, (_, _, _, cin, cout) in enumerate(ops)])


# copied from dualdiffusion_tpu/parallel/unet_pipeline.py
def balance(costs: np.ndarray, k: int) -> List[int]:
    """Contiguous partition of ops into k ranges with ~equal cost.
    Greedy cut at cumulative targets; every stage gets >= 1 op."""
    n = len(costs)
    assert k <= n, f"{k} stages for {n} ops"
    cum = np.concatenate([[0.0], np.cumsum(costs)])
    bounds = [0]
    for i in range(1, k):
        target = cum[-1] * i / k
        j = int(np.searchsorted(cum, target))
        j = min(max(j, bounds[-1] + 1), n - (k - i))  # keep stages non-empty
        bounds.append(j)
    bounds.append(n)
    return bounds


def _numel(shape: Shape) -> int:
    return int(np.prod(shape))


def _state_len(spec) -> int:
    x, skips = spec
    return sum(_numel(s) for s in [x] + list(skips))


def build_stage_plan(cfg, x_shape: Sequence[int], n_stages: int) -> StagePlan:
    """Plan ``n_stages`` contiguous stages of the schedule of a UNet of
    ``cfg`` for microbatches of trunk input shape ``x_shape``. The stage
    sizes come from a core on the meta device: no weight is made."""
    ops = _unet().build_schedule(cfg)
    if not 1 <= n_stages <= len(ops):
        raise ValueError(f"{n_stages} stages for a schedule of {len(ops)} ops")
    specs = boundary_state_specs(cfg, x_shape)
    bounds = balance(op_costs(cfg, specs), n_stages)
    meta = _unet().UNetCore(cfg, device="meta")
    stage_ops = [[ops[i][0] for i in range(bounds[k], bounds[k + 1])]
                 for k in range(n_stages)]
    sizes = [sum(p.numel() for name in names for p in getattr(meta, name).parameters())
             + meta.out_gain.numel() for names in stage_ops]
    return StagePlan(boundaries=bounds, boundary_specs=specs,
                     payload_len=max(_state_len(specs[b]) for b in bounds),
                     stage_ops=stage_ops, stage_param_sizes=sizes,
                     n_stages=n_stages)


def keep_stage(core, plan: StagePlan, stage: int):
    """Drop from ``core``, in place, the op modules of every stage but
    ``stage``; returns it. It keeps ``out_gain`` and ``precondition``'s
    modules. Load the whole core's weights first, then keep the stage, then
    move it to its device: the rank never holds another stage's weights."""
    keep = set(plan.stage_ops[stage])
    for name, *_ in core.schedule:
        if name not in keep and name in core._modules:
            delattr(core, name)
    return core


def pack_payload(tensors: Sequence[torch.Tensor], length: int, dtype) -> torch.Tensor:
    """The tensors flattened in order into one ``length`` buffer of ``dtype``,
    zero-padded (JAX ``_pack_payload``)."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    return torch.nn.functional.pad(flat, (0, length - flat.numel()))


def unpack_payload(flat: torch.Tensor, spec) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(x, skips) of ``spec``'s shapes from a packed buffer (JAX ``_unpack_payload``)."""
    x, skips = spec
    out, off = [], 0
    for s in [x] + list(skips):
        out.append(flat[off:off + _numel(s)].reshape(s))
        off += _numel(s)
    return out[0], out[1:]


def _check_state(x: torch.Tensor, skips, spec, where: str) -> None:
    got = (tuple(x.shape), [tuple(s.shape) for s in skips])
    if got != (tuple(spec[0]), [tuple(s) for s in spec[1]]):
        raise ValueError(f"{where}: state {got} is not the plan's {spec}")


@torch.no_grad()
def unet_pipeline_apply(core, x: torch.Tensor, emb: torch.Tensor, axis: Axis,
                        num_microbatches: int = 4,
                        plan: Optional[StagePlan] = None) -> torch.Tensor:
    """The trunk ``core.run_ops(x, emb, [])[0]`` pipelined over ``axis``:
    this rank runs stage ``axis.rank`` of ``plan`` (by default planned here
    for K = ``axis.size``) on ``core``, which must hold that stage's modules.
    ``x`` (B, ...) is the trunk input after ``precondition``, ``emb`` (B,
    cemb), B a multiple of ``num_microbatches``; the same on every rank.
    Returns the trunk output (before the combine), in the payload's dtype,
    on every rank."""
    k, idx = axis.size, axis.rank
    b, m = x.shape[0], num_microbatches
    if b % m:
        raise ValueError(f"batch {b} does not divide into {m} microbatches")
    dtype = _unet().ACT_DTYPE
    x_mb = x.reshape((m, b // m) + tuple(x.shape[1:])).to(dtype)
    emb_mb = emb.reshape((m, b // m) + tuple(emb.shape[1:])).to(dtype)
    if plan is None:
        plan = build_stage_plan(core.cfg, x_mb.shape[1:], k)
    if plan.n_stages != k:
        raise ValueError(f"a plan of {plan.n_stages} stages on an axis of {k} ranks")
    missing = [n for n in plan.stage_ops[idx] if n not in core._modules]
    if missing:
        raise ValueError(f"rank {idx} lacks its stage's modules {missing[:4]}")
    lo, hi = plan.boundaries[idx], plan.boundaries[idx + 1]
    specs, length = plan.boundary_specs, plan.payload_len
    _check_state(x_mb[0], [], specs[0], "the trunk input")
    outs = x_mb.new_empty((m,) + tuple(specs[-1][0]))

    def run(mb, received):
        xx, skips = (x_mb[mb], []) if received is None else unpack_payload(received, specs[lo])
        nx, nskips = core.run_ops(xx, emb_mb[mb], skips, lo, hi)
        _check_state(nx, nskips, specs[hi], f"stage {idx}'s output")
        if idx == k - 1:
            outs[mb] = nx
            return None
        return pack_payload([nx] + nskips, length, dtype)

    gpipe(run, axis, m, lambda: x_mb.new_empty((length,)))
    broadcast_from(outs, axis, k - 1)
    return outs.reshape((b,) + tuple(specs[-1][0][1:]))


@torch.no_grad()
def pipelined_denoise(core, x_in: torch.Tensor, sigma: torch.Tensor,
                      embeddings: Optional[torch.Tensor], axis: Axis,
                      num_microbatches: int = 4, x_ref: Optional[torch.Tensor] = None,
                      plan: Optional[StagePlan] = None) -> torch.Tensor:
    """The EDM2 denoiser D(x, sigma) with the trunk pipelined over ``axis``:
    ``core(x_in, sigma, embeddings, x_ref)`` (JAX ``pipelined_denoise``).
    ``precondition`` and the c_skip / c_out combine run on every rank; call
    it on every rank with the same inputs."""
    x, emb, c_skip, c_out = core.precondition(x_in, sigma, embeddings, x_ref)
    y = unet_pipeline_apply(core, x, emb, axis, num_microbatches, plan)
    return c_skip * x_in.float() + c_out * y.float()
