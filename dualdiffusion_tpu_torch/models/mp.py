"""Magnitude-preserving primitive functions (the EDM2 MP toolkit), channel
last, and the stereo mid/side transform (JAX: dualdiffusion_tpu/models/
mp.py:30-136, 180-215; reference:
src/modules/mp_tools.py:42-311). 2D activations are (B, H, W, C), 3D
stereo-folded ones (B, Z, H, W, C).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

# std of silu(x) for x ~ N(0,1) (EDM2 eq. 81)
_SILU_STD = 0.596


def normalize(x: torch.Tensor, dim: Optional[Union[int, Sequence[int]]] = None,
              eps: float = 1e-4) -> torch.Tensor:
    """Unit RMS over ``dim`` (default: all but dim 0), computed in fp32:
    x / (eps + ||x|| / sqrt(n))."""
    if dim is None:
        dim = tuple(range(1, x.dim()))
    xf = x.float()
    rms = xf.square().mean(dim=dim, keepdim=True).sqrt()
    return (xf / (eps + rms)).to(x.dtype)


def normalize_groups(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Pixel norm per channel group, channel last."""
    if groups == 1:
        return normalize(x, dim=-1)
    c = x.shape[-1]
    y = normalize(x.reshape(x.shape[:-1] + (groups, c // groups)), dim=-1)
    return y.reshape(x.shape)


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) / _SILU_STD


def mp_sum(a: torch.Tensor, b: torch.Tensor,
           t: Union[float, torch.Tensor] = 0.5) -> torch.Tensor:
    """lerp(a, b, t) / sqrt((1-t)^2 + t^2) (EDM2 eq. 88)."""
    lerp = a + (b - a) * t
    denom = ((1.0 - t) ** 2 + t ** 2) ** 0.5
    return (lerp / denom).to(a.dtype)


def mp_cat(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
           t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving concat (EDM2 eq. 103)."""
    na, nb = a.shape[dim], b.shape[dim]
    c = ((na + nb) / ((1.0 - t) ** 2 + t ** 2)) ** 0.5
    wa = c / na ** 0.5 * (1.0 - t)
    wb = c / nb ** 0.5 * t
    return torch.cat([wa * a, wb * b], dim=dim)


def resample_2d(x: torch.Tensor, mode: str = "keep", ratio: int = 2) -> torch.Tensor:
    """(..., H, W, C): down = ratio x ratio average pool (trailing remainder
    rows/cols dropped), up = nearest."""
    if mode == "keep":
        return x
    h, w, c = x.shape[-3:]
    if mode == "down":
        he, we = h // ratio * ratio, w // ratio * ratio
        x = x[..., :he, :we, :]
        y = x.reshape(x.shape[:-3] + (he // ratio, ratio, we // ratio, ratio, c))
        return y.mean(dim=(-4, -2))
    if mode == "up":
        return x.repeat_interleave(ratio, dim=-3).repeat_interleave(ratio, dim=-2)
    raise ValueError(mode)


def resample_3d(x: torch.Tensor, mode: str = "keep") -> torch.Tensor:
    """(..., Z, H, W, C): resamples H and W only; the stereo depth Z stays."""
    return resample_2d(x, mode)


def midside_transform(x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
    """Stereo mid/side: ((L+R), (L-R)) / sqrt(2) along ``channel_dim``."""
    l, r = x.select(channel_dim, 0), x.select(channel_dim, 1)
    return torch.stack([l + r, l - r], dim=channel_dim) * 0.5 ** 0.5


def wavelet_decompose_2d(x: torch.Tensor, num_levels: int = 4) -> list:
    """Laplacian pyramid on (..., H, W, C), finest level first (JAX mp.py:187-197)."""
    wavelets = []
    for i in range(num_levels):
        if i == num_levels - 1:
            wavelets.append(x)
        else:
            x_down = resample_2d(x, "down")
            wavelets.append(x - resample_2d(x_down, "up"))
            x = x_down
    return wavelets


def wavelet_recompose_2d(wavelets: list) -> torch.Tensor:
    """The inverse of ``wavelet_decompose_2d``."""
    x = list(wavelets)
    y = x.pop()
    while x:
        y = resample_2d(y, "up") + x.pop()
    return y
