"""Collectives with gradients, the axes of the mesh as one rank sees them,
and the row shards of the FSDP and tensor-parallel layouts.

Convention: each rank's loss is the mean over its own rows, and the data
axis averages the ranks' gradients after the backward pass
(``average_gradients``). So the backward of every collective here sums the
gradients that reach it from all ranks, and the averaging divides once.

* ``Axis``: a process group, this rank's place on it and its size;
  ``Axis()`` is one process, on which every collective is the identity.
  ``share`` cuts this rank's rows from a tensor drawn for a global
  microbatch; ``mean`` (an all-reduce) and ``gather`` (an all-gather along
  dim 0) carry gradients, for the batch statistics of a loss.
* ``Shard``: a parameter kept as rows [rank*k, (rank+1)*k) of its dim 0 on
  each rank of a group; ``fsdp`` ones are all-gathered where they are used
  and their gradient reduce-scattered (``gather_rows``), ``tp`` ones compute
  column-parallel (``models/layers.py`` ``MPConv``) with the Megatron pair
  ``copy_to_group`` (f) and ``gather_last_dim`` (g).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


class Axis:
    """One axis of the mesh as this rank sees it."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        sub = mesh[name]
        return cls(sub.get_group(), sub.get_local_rank(), sub.size())

    def share(self, t):
        """This rank's rows of ``t`` (a tensor or a list; None passes),
        drawn for the whole axis: rows [rank*b, (rank+1)*b) of its size*b."""
        if self.size == 1 or t is None:
            return t
        b = (t.shape[0] if torch.is_tensor(t) else len(t)) // self.size
        return t[self.rank * b:(self.rank + 1) * b]

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the axis, with its gradient."""
        return t if self.size == 1 else _AllReduceMean.apply(t, self)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order, with
        its gradient."""
        return t if self.size == 1 else gather_rows(t, self)

    @torch.no_grad()
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place, summing; returns it."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    @torch.no_grad()
    def mean_of(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the axis, without gradient."""
        return t if self.size == 1 else self.sum_(t.detach().clone()) / self.size

    def std(self, t: torch.Tensor) -> torch.Tensor:
        """The population std of all elements of ``t`` over the axis."""
        return t.std(correction=0) if self.size == 1 else self.var(t).sqrt()

    def var(self, t: torch.Tensor) -> torch.Tensor:
        """The population variance of all elements of ``t`` over the axis,
        without gradient."""
        if self.size == 1:
            return t.var(correction=0)
        m = self.mean_of(t.detach().mean())
        return self.mean_of((t.detach() - m).square().mean())


# newer PyTorch names the flat-buffer collectives *_single
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _all_gather_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    t = t.contiguous()
    out = t.new_empty((t.shape[0] * axis.size,) + tuple(t.shape[1:]))
    _all_gather_flat(out, t, group=axis.group)
    return out


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        out = t.detach().clone()
        dist.all_reduce(out, group=axis.group)
        return out / axis.size

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g / ctx.axis.size, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, scale):
        ctx.axis, ctx.scale = axis, scale
        return _all_gather_rows(t, axis)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // a.size,) + tuple(g.shape[1:]))
        _reduce_scatter_flat(out, g, group=a.group)
        return (out if ctx.scale == 1 else out * ctx.scale), None, None


def gather_rows(t: torch.Tensor, axis: Axis, scale: float = 1.0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order. The
    backward reduce-scatters the gradient: this rank's rows of it, summed
    over the ranks, times ``scale`` (an FSDP shard takes 1/size: the
    data-axis average of its rows' gradient)."""
    return _GatherRows.apply(t, axis, scale)


# ---------------------------------------------------------------------------
# row shards (FSDP and tensor parallelism)
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class Shard:
    """A parameter held as this rank's rows of dim 0 over ``axis``;
    ``rows`` is the whole dim. ``mode``: "fsdp" (gathered where used) or
    "tp" (column-parallel compute)."""
    axis: Axis
    rows: int
    mode: str

    @property
    def local_rows(self) -> slice:
        k = self.rows // self.axis.size
        return slice(self.axis.rank * k, (self.axis.rank + 1) * k)


SHARD_ATTR = "dd_shard"


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    """The ``Shard`` a parameter was given, None for a whole one."""
    return getattr(t, SHARD_ATTR, None)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _GatherLastDim(torch.autograd.Function):
    """Megatron's g: each rank's channel slice gathered along the last dim;
    the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis, ctx.c = axis, t.shape[-1]
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t.contiguous(), group=axis.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, c = ctx.axis.rank, ctx.c
        return g[..., r * c:(r + 1) * c].contiguous(), None


def copy_to_group(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _CopyToGroup.apply(t, shard.axis)


def gather_last_dim(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _GatherLastDim.apply(t, shard.axis)


@torch.no_grad()
def full_tensor(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The whole tensor of a row shard (a collective over the shard's axis),
    on ``t``'s device; ``t`` itself without a shard. A tensor whose dim 0
    is not the shard's rows (a moment of another shape) stays as it is."""
    if shard is None or t.dim() == 0 or t.shape[0] * shard.axis.size != shard.rows:
        return t
    dev = t.device
    # a host copy (an offloaded EMA) travels through the group's device
    work = t.to(_group_device(shard.axis)) if dev.type == "cpu" else t
    return _all_gather_rows(work, shard.axis).to(dev)


def local_rows(full: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """This rank's rows of a whole tensor; ``full`` itself without a shard."""
    if shard is None or full.dim() == 0 or full.shape[0] != shard.rows:
        return full
    return full[shard.local_rows]


def _group_device(axis: Axis) -> torch.device:
    if dist.get_backend(axis.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@torch.no_grad()
def average_gradients(params: Sequence[torch.Tensor], data: Axis) -> None:
    """Average the gradients over the data axis, in one flat buffer per
    dtype; FSDP shards' gradients arrive averaged from their backward."""
    if data.size == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        s = shard_of(p)
        if p.grad is not None and not (s is not None and s.mode == "fsdp"):
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=data.group)
        flat /= data.size
        torch._foreach_copy_(grads, [c.view_as(g) for c, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def global_grad_norm(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    """The norm of the whole gradient: each shard's squares summed over its
    axis, every whole (replicated) gradient counted once."""
    sq = torch.stack(torch._foreach_norm(list(grads))).float().square()
    total = sq.new_zeros(())
    sharded: Dict[int, List] = {}
    for i, p in enumerate(params):
        s = shard_of(p)
        if s is None or s.axis.size == 1:
            total = total + sq[i]
        else:
            sharded.setdefault(id(s.axis.group), [s.axis, sq.new_zeros(())])[1] += sq[i]
    for axis, part in sharded.values():
        total = total + axis.sum_(part)
    return total.sqrt()
