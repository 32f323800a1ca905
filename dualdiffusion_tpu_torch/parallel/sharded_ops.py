"""Sequence parallelism: the DAE encode and decode with the time (W) axis
split over the ranks of an axis and halos exchanged between neighbours
(JAX: dualdiffusion_tpu/parallel/sharded_ops.py; reference: the
overlap-discard tiled encode, src/modules/daes/dae_edm2_q4.py:352-405).

Rank r of n holds columns [r W/n, (r+1) W/n) of a (B, H, W, C) tensor.
Each sends its first ``halo`` columns to its left neighbour and its last
``halo`` to its right one (``collectives.exchange``), runs the function on
its shard with the neighbours' columns on either side, and cuts the
halos' part off the result. The clip's true edges get zero halos: JAX
hands the wrap-around halos round the ring and zeroes them, the port
sends none, to the same result.

With ``halo`` at least the network's receptive-field radius the result
equals the unsharded one except within that radius of the clip's true
edges, where zero halos differ from per-layer zero padding once biases and
normalization act on the halo columns (as in JAX; the reference's tiling
has the same property at its seams).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import Axis, _group_device, exchange


def shard_w(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's columns of the W axis (dim 2) of a whole tensor."""
    w = x.shape[2]
    if w % axis.size:
        raise ValueError(f"W={w} does not divide into {axis.size} shards")
    k = w // axis.size
    return x[:, :, axis.rank * k:(axis.rank + 1) * k]


@torch.no_grad()
def gather_w(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's W shard concatenated in rank order (a collective)."""
    if axis.size == 1:
        return t
    dev = _group_device(axis)
    parts = [torch.empty(t.shape, dtype=t.dtype, device=dev) for _ in range(axis.size)]
    dist.all_gather(parts, t.to(dev).contiguous(), group=axis.group)
    return torch.cat(parts, dim=2).to(t.device)


def _reach(layers: Sequence[Tuple[str, int]], col: int) -> Tuple[int, int]:
    """The first and last input columns output column ``col`` of ``layers``
    (("conv", k): k wide, zero padded; ("down", r): an r-wide average pool;
    ("up", r): nearest upsampling) reads."""
    lo = hi = col
    for kind, k in reversed(layers):
        if kind == "conv":
            lo, hi = lo - k // 2, hi + k // 2
        elif kind == "down":
            lo, hi = lo * k, hi * k + k - 1
        else:
            lo, hi = lo // k, hi // k
    return lo, hi


def dae_halos(cfg) -> Tuple[int, int]:
    """The halos a DAE of ``cfg`` (``models/dae.py``) needs: (mel columns for
    ``sharded_tiled_encode``, a multiple of the downsample ratio; latent
    columns for ``sharded_tiled_decode``), each the farthest its network
    reaches past a shard's edge column, from its layers (the 1x1 skip convs
    and the pointwise ops reach nowhere)."""
    n_enc, n_dec = len(cfg.channel_mult_enc), len(cfg.channel_mult_dec)
    ds = 2 ** (n_dec - 1)
    enc = [("conv", 5)]
    for level in range(n_enc):
        if level > 0:       # the down block: pool (unless supersampled), two 3x3 convs
            enc += ([] if cfg.supersampled else [("down", 2)]) + [("conv", 3)] * 2
        enc += [("conv", 3)] * (2 * cfg.num_enc_layers_per_block)
    enc += [("conv", 3)] + ([("down", ds)] if cfg.supersampled else [])
    dec = [("conv", 3)]
    for level in reversed(range(n_dec)):
        dec += [] if level == n_dec - 1 else [("up", 2)]
        dec += [("conv", 3)] * (2 * (cfg.num_dec_layers_per_block + 1))
    dec += [("conv", 5)]
    # latent column i reads mel columns [lo + ds i, hi + ds i]
    lo, hi = _reach(enc, 0)
    halo = -(-max(-lo, hi - (ds - 1)) // ds) * ds
    # output column ds i + j (0 <= j < ds) reads latent columns [i + lo_j, i + hi_j]
    halo_latent = max(max(-a, b) for a, b in (_reach(dec, j) for j in range(ds)))
    return halo, halo_latent


def _with_halos(x: torch.Tensor, axis: Axis, halo: int) -> torch.Tensor:
    """This rank's shard with ``halo`` columns of each neighbour on either
    side, zeros beyond the clip's true edges (a collective)."""
    n, r = axis.size, axis.rank
    if not 0 <= halo <= x.shape[2]:
        raise ValueError(f"halo {halo} does not fit a shard of {x.shape[2]} columns")
    shape = tuple(x.shape[:2]) + (halo,) + tuple(x.shape[3:])
    from_left = x.new_zeros(shape)
    from_right = x.new_zeros(shape)
    if halo and n > 1:
        sends, recvs = [], []
        if r > 0:
            sends.append((x[:, :, :halo], r - 1))
            recvs.append((from_left, r - 1))
        if r < n - 1:
            sends.append((x[:, :, x.shape[2] - halo:], r + 1))
            recvs.append((from_right, r + 1))
        exchange(axis, sends, recvs)
    return torch.cat([from_left, x, from_right], dim=2)


def sharded_tiled_encode(encode_fn: Callable, x: torch.Tensor, axis: Axis, halo: int,
                         downsample_ratio: int) -> torch.Tensor:
    """``encode_fn`` (a (B, H, W, C) mel -> latents with W / ds columns) of
    this rank's W shard ``x`` of a mel sharded over ``axis``, with ``halo``
    mel columns of context from each neighbour; returns this rank's latent
    columns. ``halo`` must be a multiple of ``downsample_ratio`` and at least
    the encoder's receptive-field radius. Call it on every rank."""
    ds = downsample_ratio
    if halo % ds:
        raise ValueError("halo must be a multiple of the downsample ratio")
    if x.shape[2] % ds:
        raise ValueError(f"W={x.shape[2] * axis.size} must divide evenly into {axis.size} "
                         f"shards x ds {ds}")
    lat = encode_fn(_with_halos(x, axis, halo))
    h = halo // ds
    return lat[:, :, h:lat.shape[2] - h]


def sharded_tiled_decode(decode_fn: Callable, latents: torch.Tensor, axis: Axis,
                         halo_latent: int, downsample_ratio: int) -> torch.Tensor:
    """``decode_fn`` (latents -> (B, H, W, C) with W = ds x their columns) of
    this rank's W shard of latents sharded over ``axis``, with
    ``halo_latent`` latent columns of context from each neighbour; returns
    this rank's output columns. Call it on every rank."""
    out = decode_fn(_with_halos(latents, axis, halo_latent))
    h = halo_latent * downsample_ratio
    return out[:, :, h:out.shape[2] - h]
