"""The device mesh and the sharding rule (JAX: dualdiffusion_tpu/parallel/
mesh.py).

One process per device, so the mesh is a ``DeviceMesh`` of ranks named
("data", "model"). ``make_mesh`` lays the ranks out as JAX lays out its
devices; ``param_sharding_rule`` is JAX's rule (dim 0 sharded when the
leaf is at least 2-D and the axis divides dim 0, else replicated);
``shard_train_state`` applies it to every ``MPConv`` weight (the models'
only parameters of two or more dims) before the optimizer and the EMA
profiles are made from them, so those are sharded alike: the FSDP layout
of JAX ``shard_train_state`` over "data", or the tensor-parallel one over
"model". One departure from JAX's placement: under tensor parallelism a
grouped conv whose groups do not divide over the model axis stays
replicated (the math is the same; only its memory differs).

A global batch is cut as one process cuts it: microbatch i holds rows
[i*N*b, (i+1)*N*b) for N data ranks of b rows each, and rank r keeps rows
[i*N*b + r*b, i*N*b + (r+1)*b) of it (``shard_batch``). Each rank draws the
random numbers of the whole microbatch and keeps its rows (``Axis.share``),
so every sample gets the sigma and noise it gets on one process.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from .collectives import SHARD_ATTR, Axis, Shard, full_tensor, shard_of


@dataclass
class MeshConfig:
    data_axis: int = -1      # -1 = every rank not on the model axis
    model_axis: int = 1      # tensor-parallel width (1 = pure data parallelism)
    axis_names: Tuple[str, str] = ("data", "model")
    #: nodes joined by the slower network: the data axis's outer blocks are
    #: the ranks of one node each, so model-axis collectives stay inside a node
    num_dcn_slices: int = 1


def mesh_layout(config: MeshConfig, n: int,
                node_of: Optional[Sequence[int]] = None) -> np.ndarray:
    """The (data, model) array of ranks ``make_mesh`` builds for ``n``
    ranks; ``node_of[r]`` is rank r's node (by default r // LOCAL_WORLD_SIZE),
    by which ranks are grouped as JAX groups devices by process index."""
    model = max(config.model_axis, 1)
    data = n // model if config.data_axis == -1 else config.data_axis
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    ranks = list(range(n))
    slices = max(config.num_dcn_slices, 1)
    if slices > 1:
        if data % slices != 0:
            raise ValueError(f"data axis {data} not divisible by {slices} DCN slices")
        if node_of is None:
            per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
            node_of = [r // per_node for r in ranks]
        ranks.sort(key=lambda r: (node_of[r], r))
    return np.asarray(ranks).reshape(data, model)


def make_mesh(config: Optional[MeshConfig] = None, devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the process group's ranks (``devices``: the
    ranks, all of them by default), on "cuda" under NCCL, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh
    config = config or MeshConfig()
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else list(devices)
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"the mesh takes every rank of the group: {ranks} of {world}")
    layout = mesh_layout(config, len(ranks))
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.as_tensor(layout), mesh_dim_names=config.axis_names)


def param_sharding_rule(mesh, leaf: torch.Tensor, axis_name: str = "model"):
    """``Shard(0)`` over ``axis_name`` when ``leaf`` is at least 2-D and the
    axis divides dim 0, else ``Replicate()`` (JAX mesh.py:116-131)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import Shard as DShard
    size = mesh[axis_name].size()
    if leaf.dim() >= 2 and leaf.shape[0] % size == 0 and leaf.shape[0] >= size:
        return DShard(0)
    return Replicate()


def shard_batch(mesh, batch: Dict, grad_accum_steps: int = 1, device=None) -> Dict:
    """This rank's share of a global batch (the same on every rank), on
    ``device`` (default: this rank's): rows [i*N*b + r*b, i*N*b + (r+1)*b)
    of each of the ``grad_accum_steps`` microbatches, for data rank r of N.
    Entries that are not arrays (``paths``) are cut alike."""
    data = Axis.of(mesh, "data")
    accum = grad_accum_steps

    def rows(n: int):
        b = n // (accum * data.size)
        return [i * data.size * b + data.rank * b + j for i in range(accum) for j in range(b)]

    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, tuple)):
            out[k] = [v[i] for i in rows(len(v))]
            continue
        t = torch.as_tensor(v)
        t = t[torch.as_tensor(rows(t.shape[0]))]
        out[k] = t.to(device if device is not None else _mesh_device(mesh))
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate_state(mesh, module: nn.Module) -> nn.Module:
    """Broadcast every parameter and buffer of ``module`` from the mesh's
    first rank to all, in place."""
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in module.state_dict(keep_vars=True).values():
            dist.broadcast(t.data, src)
    return module


def shard_train_state(mesh, module: nn.Module, axis_name: str = "model") -> nn.Module:
    """Shard ``module``'s ``MPConv`` weights by ``param_sharding_rule`` over
    ``axis_name``, in place: each keeps its rows of dim 0. Over "data" the
    layout is FSDP's (gathered where used); over "model" the layer computes
    column-parallel. Make the optimizer and the EMA profiles after this, from
    the sharded parameters. An axis of one rank leaves every weight whole,
    as JAX's sharding over one device moves nothing."""
    from torch.distributed.tensor import Shard as DShard

    from ..models.layers import MPConv
    axis = Axis.of(mesh, axis_name)
    if axis.size == 1:
        return module
    mode = "tp" if axis_name == "model" else "fsdp"
    for m in module.modules():
        if not isinstance(m, MPConv):
            continue
        p = getattr(m, m.weight_name)
        if shard_of(p) is not None or not isinstance(param_sharding_rule(mesh, p, axis_name),
                                                     DShard):
            continue
        if mode == "tp" and m.groups > 1 and m.groups % axis.size:
            continue        # replicated: its groups do not divide over the model axis
        s = Shard(axis, p.shape[0], mode)
        p.data = p.data[s.local_rows].clone()
        setattr(p, SHARD_ATTR, s)
    return module


@contextlib.contextmanager
def gathered(module: nn.Module):
    """``module`` with every row-sharded parameter whole for the block (a
    collective on every rank), as a checkpoint saves it."""
    saved = []
    for p in module.parameters():
        s = shard_of(p)
        if s is not None:
            saved.append((p, p.data, s))
            p.data = full_tensor(p.data, s)
            delattr(p, SHARD_ATTR)
    try:
        yield module
    finally:
        for p, data, s in saved:
            p.data = data
            setattr(p, SHARD_ATTR, s)


def whole(tensors: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]
          ) -> Dict[str, torch.Tensor]:
    """``tensors`` (an EMA profile) whole, each gathered by the shard of
    ``like``'s tensor under its key (a collective on every rank)."""
    return {k: full_tensor(v, shard_of(like[k]) if k in like else None)
            for k, v in tensors.items()}


@dataclass
class ParallelState:
    """The mesh of a multi-process run and this rank's axes on it; ``fsdp``
    shards the trained weights over "data" (with a model axis of 1)."""
    mesh: object
    fsdp: bool = False
    data: Axis = field(init=False)
    model: Axis = field(init=False)

    def __post_init__(self):
        self.data = Axis.of(self.mesh, "data")
        self.model = Axis.of(self.mesh, "model")

    @property
    def shard_axis(self) -> Optional[str]:
        """The axis the trained weights are sharded over, None when whole."""
        if self.model.size > 1:
            return "model"
        return "data" if self.fsdp else None

    def prepare(self, module: nn.Module) -> nn.Module:
        """Make ``module`` the same on every rank, then shard it by the
        layout: before its optimizer and EMA profiles are made."""
        replicate_state(self.mesh, module)
        if self.shard_axis is not None:
            shard_train_state(self.mesh, module, self.shard_axis)
        return module
