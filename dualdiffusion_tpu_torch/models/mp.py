"""Magnitude-preserving primitive functions (the EDM2 MP toolkit), channel
last: the MP sums and concatenations, resampling and patching, the stereo
mid/side transform and the spectral helpers (JAX: dualdiffusion_tpu/models/
mp.py; reference: src/modules/mp_tools.py:42-311). 2D activations are
(B, H, W, C), 3D stereo-folded ones (B, Z, H, W, C). Random functions take
a ``torch.Generator``, or their draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
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


def mp_sum_groups(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """``mp_sum`` per channel group, channel last; ``t`` is (groups,) or
    (B, groups), widened to the activations' rank (JAX mp.py:67-78)."""
    c = a.shape[-1]
    ag = a.reshape(a.shape[:-1] + (groups, c // groups))
    bg = b.reshape(b.shape[:-1] + (groups, c // groups))
    while t.dim() < ag.dim() - 1:
        t = t[..., None, :] if t.dim() >= 2 else t[None]
    return mp_sum(ag, bg, t[..., :, None]).reshape(a.shape)


def _mp_cat_weights(na: int, nb: int, t: float) -> Tuple[float, float]:
    c = ((na + nb) / ((1.0 - t) ** 2 + t ** 2)) ** 0.5
    return c / na ** 0.5 * (1.0 - t), c / nb ** 0.5 * t


def mp_cat(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
           t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving concat (EDM2 eq. 103)."""
    wa, wb = _mp_cat_weights(a.shape[dim], b.shape[dim], t)
    return torch.cat([wa * a, wb * b], dim=dim)


def mp_cat_interleave(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      t: float = 0.5) -> torch.Tensor:
    """``mp_cat`` with the two inputs' entries alternating along ``dim``
    (a0, b0, a1, b1, ...; JAX mp.py:91-102); a and b have the same shape."""
    wa, wb = _mp_cat_weights(a.shape[dim], b.shape[dim], t)
    dim = dim % a.dim()
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([wa * a, wb * b], dim=dim + 1).reshape(shape)


def resample_1d(x: torch.Tensor, mode: str = "keep") -> torch.Tensor:
    """(..., T, C): down = pairwise mean, up = nearest 2x, along T."""
    if mode == "keep":
        return x
    if mode == "down":
        return 0.5 * (x[..., ::2, :] + x[..., 1::2, :])
    if mode == "up":
        return x.repeat_interleave(2, dim=-2)
    raise ValueError(mode)


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


def patchify_2d(x: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/ph, W/pw, C*ph*pw), channel order (c, ph, pw)."""
    b, h, w, c = x.shape
    if h % patch_h or w % patch_w:
        raise ValueError("dims must be divisible by patch size")
    y = x.reshape(b, h // patch_h, patch_h, w // patch_w, patch_w, c)
    y = y.permute(0, 1, 3, 5, 2, 4)               # (B, H', W', C, ph, pw)
    return y.reshape(b, h // patch_h, w // patch_w, c * patch_h * patch_w)


def unpatchify_2d(x: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """The inverse of ``patchify_2d``."""
    b, hh, ww, cpp = x.shape
    c = cpp // (patch_h * patch_w)
    y = x.reshape(b, hh, ww, c, patch_h, patch_w).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(b, hh * patch_h, ww * patch_w, c)


def space_to_channel_2d(x: torch.Tensor) -> torch.Tensor:
    return patchify_2d(x, 2, 2)


def channel_to_space_2d(x: torch.Tensor) -> torch.Tensor:
    return unpatchify_2d(x, 2, 2)


def space_to_channel_3d(x: torch.Tensor) -> torch.Tensor:
    """(B, Z, H, W, C) -> (B, Z, H/2, W/2, 4C), each z-plane patchified alone
    (JAX mp.py:167-171; the reference's version crashes)."""
    b, z = x.shape[:2]
    y = patchify_2d(x.reshape((b * z,) + x.shape[2:]), 2, 2)
    return y.reshape((b, z) + y.shape[1:])


def channel_to_space_3d(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``space_to_channel_3d``."""
    b, z = x.shape[:2]
    y = unpatchify_2d(x.reshape((b * z,) + x.shape[2:]), 2, 2)
    return y.reshape((b, z) + y.shape[1:])


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


# ---------------------------------------------------------------------------
# spectral helpers (JAX mp.py:212-270)
# ---------------------------------------------------------------------------

def _reflect_pad_hw(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect padding of H and W of a (..., H, W, C) tensor, by each amount
    on both sides."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = F.pad(y, (pad_w, pad_w, pad_h, pad_h), mode="reflect").permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def lowpass_2d(x: torch.Tensor, blur_width: float = 16.0,
               use_circular_filter: bool = True) -> torch.Tensor:
    """FFT brick-wall low-pass of (..., H, W, C), reflect padded by half of
    each side, in fp32 (reference: mp_tools.py:121-160): the bins within
    1 / blur_width of DC (a circle, or a square) are kept."""
    h, w = x.shape[-3], x.shape[-2]
    pad_h, pad_w = h // 2, w // 2
    xp = _reflect_pad_hw(x, pad_h, pad_w).float()
    ph, pw = h + 2 * pad_h, w + 2 * pad_w
    fh, fw = np.fft.fftfreq(ph), np.fft.rfftfreq(pw)
    if use_circular_filter:
        dist = np.sqrt(fh[:, None] ** 2 + fw[None, :] ** 2)
    else:
        dist = np.maximum(np.abs(fh)[:, None], np.abs(fw)[None, :])
    mask = torch.as_tensor((dist <= 1.0 / blur_width)[..., None], device=x.device)
    xf = torch.fft.rfft2(xp, dim=(-3, -2), norm="ortho") * mask
    y = torch.fft.irfft2(xf, s=(ph, pw), dim=(-3, -2), norm="ortho")
    return y[..., pad_h:pad_h + h, pad_w:pad_w + w, :].to(x.dtype)


def randn_like_hp_2d(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """High-pass-shaped gaussian noise like (..., H, W, C) ``x`` (reference:
    mp_tools.py:246-263): complex normal half-spectrum bins, kept where
    |f_H| or |f_W| is at least 1/4 and set to 1 elsewhere (the reference's
    ``z ** mask``), through an inverse real 2-D FFT, times sqrt(1.5).
    ``draws``: the real and imaginary normal draws, each (..., H, W//2+1, C),
    else drawn from ``generator``.

    The stop band's ones make the W axis's DC and Nyquist bins non-Hermitian;
    the inverse runs as a c2c FFT along H, then the imaginary part of those
    bins set to zero (what a c2r transform on the CPU drops), then a real
    inverse along W, so the result does not depend on how the FFT library
    treats a non-Hermitian input."""
    h, w = x.shape[-3], x.shape[-2]
    if draws is None:
        shape = x.shape[:-3] + (h, w // 2 + 1, x.shape[-1])
        draws = tuple(torch.randn(shape, generator=generator, device=x.device)
                      for _ in range(2))
    zr, zi = (d.float() for d in draws)
    fy = np.abs(np.fft.fftfreq(h)) >= 0.25
    fx = np.abs(np.fft.rfftfreq(w)) >= 0.25
    mask = torch.as_tensor((fy[:, None] | fx[None, :])[..., None], device=zr.device)
    z = torch.complex(torch.where(mask, zr, 1.0), torch.where(mask, zi, 0.0))
    z = torch.fft.ifft(z, dim=-3, norm="ortho")
    hermitian = torch.ones(z.shape[-2], 1, dtype=torch.bool, device=z.device)
    hermitian[0] = False
    if w % 2 == 0:
        hermitian[-1] = False
    z = torch.complex(z.real, torch.where(hermitian, z.imag, 0.0))
    noise = torch.fft.irfft(z, n=w, dim=-2, norm="ortho") * 1.5 ** 0.5
    return noise.to(x.dtype)


def random_crop_2d(*tensors: torch.Tensor, range_h: int = 8, range_w: int = 8,
                   dropout: float = 0.5, generator: Optional[torch.Generator] = None,
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
    """The same per-sample random (h, w) crop of each (B, H, W, C) tensor,
    (B, H - range_h, W - range_w, C) out; with probability ``dropout`` a
    sample keeps offset (0, 0) (reference: mp_tools.py:224-243).
    ``draws``: (keep, h, w), each (B,): whether the sample is cropped at its
    drawn offsets, and the offsets in [0, range_h) and [0, range_w); else
    drawn from ``generator``."""
    b = tensors[0].shape[0]
    dev = tensors[0].device
    if draws is None:
        keep = torch.rand((b,), generator=generator, device=dev) >= dropout
        draws = (keep,
                 torch.randint(0, max(range_h, 1), (b,), generator=generator, device=dev),
                 torch.randint(0, max(range_w, 1), (b,), generator=generator, device=dev))
    keep, h, w = (d.to(dev) for d in draws)
    keep = keep.long()
    h_off, w_off = h.long() * keep, w.long() * keep
    outs = []
    for x in tensors:
        rows = (h_off[:, None] + torch.arange(x.shape[1] - range_h, device=dev))[:, :, None]
        cols = (w_off[:, None] + torch.arange(x.shape[2] - range_w, device=dev))[:, None, :]
        outs.append(x[torch.arange(b, device=dev)[:, None, None], rows, cols])
    return tuple(outs)
