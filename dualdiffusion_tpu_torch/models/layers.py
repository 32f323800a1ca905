"""Magnitude-preserving layers, channel last (JAX: dualdiffusion_tpu/models/
layers.py:160-269, 451-625, 629-650, 680-748; reference: src/modules/mp_tools.py:316-378).

MP weights are stored reference-style as (out, in/groups, *kernel) under
the parameter name ``w_mp`` (``w_raw`` when weight norm is disabled).
The filtered resamplers at the end back the equivariance loss.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import GroupedConv3x3Fn, grouped_conv3x3, prepare_weights
from .mp import normalize

MP_WEIGHT_NAME = "w_mp"
RAW_WEIGHT_NAME = "w_raw"


class MPConv(nn.Module):
    """Weight-normalized magnitude-preserving conv / linear.

    kernel () -> linear on the last dim; (kh, kw) -> 2D conv on NHWC input;
    (kz, kh, kw) -> 3D conv on stereo-folded (B, Z, H, W, C) input (JAX
    layers.py:531-625): kz == 2 wraps Z circularly (the z=0 plane appended,
    then a valid conv along Z), kz == 3 pads Z by one each side, kz == 1
    passes Z through. ``w_pad_mode="reflect"`` reflect-pads W before a 3D
    conv; 2D convs pad with zeros whatever the mode, as in JAX.
    A grouped 3x3 stride-1 2D conv runs kernel K1 (ops/kernels/grouped_conv.py),
    in training through ``GroupedConv3x3Fn``, whose backward is K1 (dgrad)
    and K4 (wgrad); CPU tensors take their plain versions. Every other conv,
    3D ones included, runs ``torch.nn.functional.conv2d`` or ``conv3d`` (the
    JAX package leaves those to XLA; its Pallas conv never takes 5-D input).
    ``training`` re-normalizes the weight in the forward (JAX layers.py
    MPConv: ``normalize_weight`` when training).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, ...] = (), groups: int = 1, stride: int = 1,
                 disable_weight_norm: bool = False, use_bias: bool = False,
                 zero_init: bool = False, w_pad_mode: str = "zeros",
                 device=None):
        super().__init__()
        if len(kernel) not in (0, 2, 3):
            raise ValueError(f"unsupported kernel rank {len(kernel)}")
        if w_pad_mode not in ("zeros", "reflect"):
            raise ValueError(f"unknown w_pad_mode {w_pad_mode!r}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel = tuple(kernel)
        self.groups = groups
        self.stride = stride
        self.disable_weight_norm = disable_weight_norm
        self.use_bias = use_bias
        self.zero_init = zero_init
        self.w_pad_mode = w_pad_mode
        shape = (out_channels, in_channels // groups) + self.kernel
        name = RAW_WEIGHT_NAME if disable_weight_norm else MP_WEIGHT_NAME
        self.weight_name = name
        self.register_parameter(name, nn.Parameter(torch.empty(shape, device=device)))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        else:
            self.bias = None
        self._kernel_weight_cache = None

    @property
    def weight(self) -> torch.Tensor:
        return getattr(self, self.weight_name)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: N(0, 1) (zeros with zero_init); bias
        alternating +-1/sqrt(out/groups)."""
        w = self.weight
        if self.zero_init:
            w.zero_()
        else:
            w.copy_(torch.randn(w.shape, generator=generator, device=generator.device))
        if self.bias is not None:
            group_dim = self.out_channels // self.groups
            sign = np.where(np.arange(self.out_channels) % 2 == 0, 1.0, -1.0)
            self.bias.copy_(torch.as_tensor(sign / np.sqrt(group_dim), dtype=torch.float32))

    def _scaled_weight(self, gain, training: bool) -> torch.Tensor:
        w = self.weight
        if training and not self.disable_weight_norm:
            w = normalize(w)
        w = w / np.sqrt(float(np.prod(w.shape[1:])))
        if not (isinstance(gain, (int, float)) and gain == 1.0):
            w = w * gain
        return w

    def _uses_kernel(self, x: torch.Tensor) -> bool:
        return (self.groups > 1 and self.kernel == (3, 3) and self.stride == 1
                and x.dim() == 4)

    def _kernel_weight(self, gain, dtype) -> torch.Tensor:
        """K1's pre-arranged weights, made once per module and reused until
        the parameter changes."""
        w = self.weight
        gain_key = gain if isinstance(gain, (int, float)) else (id(gain), gain._version)
        key = (w._version, w.data_ptr(), gain_key, dtype)
        if self._kernel_weight_cache is None or self._kernel_weight_cache[0] != key:
            with torch.no_grad():
                wt = prepare_weights(self._scaled_weight(gain, False), self.groups, dtype)
            self._kernel_weight_cache = (key, wt)
        return self._kernel_weight_cache[1]

    def forward(self, x: torch.Tensor, gain: Union[float, torch.Tensor] = 1.0,
                training: bool = False) -> torch.Tensor:
        if isinstance(gain, torch.Tensor) and gain.dim() > 0:
            raise NotImplementedError("per-sample gains are not ported")
        if len(self.kernel) == 0:
            w = self._scaled_weight(gain, training)
            if self.groups > 1:
                g = self.groups
                xg = x.reshape(x.shape[:-1] + (g, self.in_channels // g))
                wg = w.to(x.dtype).reshape(g, self.out_channels // g, self.in_channels // g)
                out = torch.einsum("...gi,goi->...go", xg, wg)
                out = out.reshape(x.shape[:-1] + (self.out_channels,))
            else:
                out = torch.matmul(x, w.t().to(x.dtype))
        elif self._uses_kernel(x) and training:
            # no weight cache: the prepared weights carry the parameter's grad
            wt = prepare_weights(self._scaled_weight(gain, True), self.groups, x.dtype)
            out = GroupedConv3x3Fn.apply(x.contiguous(), wt, self.groups)
        elif self._uses_kernel(x):
            out = grouped_conv3x3(x.contiguous(), self._kernel_weight(gain, x.dtype),
                                  self.groups)
        else:
            w = self._scaled_weight(gain, training).to(x.dtype)
            out = self._conv(x, w)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if len(self.kernel) == 3:
            return self._conv3d(x, w)
        kh, kw = self.kernel
        if self.stride == 1 and (kh, kw) == (1, 1) and self.groups == 1:
            # 1x1 conv == matmul over the channel dim
            return torch.matmul(x, w.reshape(w.shape[0], w.shape[1]).t())
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride,
                     padding=(kh // 2, kw // 2), groups=self.groups)
        return y.permute(0, 2, 3, 1)


    def _conv3d(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(B, Z, H, W, C) -> (B, Z, H', W', C_out) (JAX layers.py:531-553)."""
        kz, kh, kw = self.kernel
        if kz == 2:   # circular stereo wrap
            x = torch.cat([x, x[:, :1]], dim=1)
        pad_w = kw // 2
        if self.w_pad_mode == "reflect" and pad_w > 0:
            x = torch.cat([x[..., 1:pad_w + 1, :].flip(-2), x,
                           x[..., -pad_w - 1:-1, :].flip(-2)], dim=-2)
            pad_w = 0
        if kz == 1:   # Z passes through: a 2D conv over the B*Z planes
            b, z = x.shape[:2]
            if self.stride == 1 and (kh, kw) == (1, 1) and self.groups == 1:
                return torch.matmul(x, w.reshape(w.shape[0], w.shape[1]).t())
            y = F.conv2d(x.reshape((b * z,) + x.shape[2:]).permute(0, 3, 1, 2), w[:, :, 0],
                         stride=self.stride, padding=(kh // 2, pad_w), groups=self.groups)
            y = y.permute(0, 2, 3, 1)
            return y.reshape((b, z) + y.shape[1:])
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=(1, self.stride, self.stride),
                     padding=(1 if kz == 3 else 0, kh // 2, pad_w), groups=self.groups)
        return y.permute(0, 2, 3, 4, 1)


class MPFourier(nn.Module):
    """MP Fourier features with erfinv-spaced frequencies and alternating
    pi/2 phases (EDM2 eq. 75). No parameters."""

    def __init__(self, num_channels: int, bandwidth: float = 1.0, eps: float = 1e-3,
                 device=None):
        super().__init__()
        lin = torch.as_tensor(np.linspace(0, 1 - eps, num_channels), dtype=torch.float64)
        freqs = np.pi * torch.special.erfinv(lin) * bandwidth
        phases = np.pi / 2 * (np.arange(num_channels) % 2 == 0)
        self.register_buffer("freqs", freqs.float().to(device), persistent=False)
        self.register_buffer("phases", torch.as_tensor(phases, dtype=torch.float32,
                                                       device=device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B,) -> (B, C)."""
        y = x.float()[:, None] * self.freqs[None, :] + self.phases
        return (torch.cos(y) * np.sqrt(2.0)).to(x.dtype)


# ---------------------------------------------------------------------------
# filtered (anti-aliased) resamplers on channel-last tensors (JAX layers.py:680-748)
# ---------------------------------------------------------------------------

# copied from dualdiffusion_tpu/models/layers.py
def _kaiser_sinc_1d(size: int, cutoff: float, beta: float) -> np.ndarray:
    from ..ops.windows import kaiser
    x = (np.arange(size) - (size - 1) / 2) * np.pi * cutoff
    sinc = np.where(x == 0, 1.0, np.sin(x) / np.where(x == 0, 1.0, x))
    k = sinc * kaiser(size, beta=beta, periodic=False)
    return (k / k.sum()).astype(np.float64)


def _sep_conv_axis(x: torch.Tensor, kernel: np.ndarray, dim: int, stride: int) -> torch.Tensor:
    """Depthwise 1-D filter along ``dim`` of a channel-last tensor, reflect
    padded as the reference pads (resample.py:49-53): (k//2, k//2 - even) at
    stride 1, (k//2 - even, k//2) when striding."""
    ks = kernel.shape[0]
    even, hk = int(ks % 2 == 0), ks // 2
    pad = (hk, hk - even) if stride == 1 else (hk - even, hk)
    dim = dim % x.dim()
    xm = x.movedim(dim, -2)                       # (..., T, C)
    lead, (t, c) = xm.shape[:-2], xm.shape[-2:]
    y = F.pad(xm.reshape(-1, t, c).transpose(1, 2), pad, mode="reflect")
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device).expand(c, 1, ks)
    y = F.conv1d(y, w, stride=stride, groups=c).transpose(1, 2)
    return y.reshape(lead + y.shape[-2:]).movedim(-2, dim)


def filtered_downsample_2d(x: torch.Tensor, k_size: int = 7, beta: float = 1.5,
                           factor: int = 2) -> torch.Tensor:
    """(..., H, W, C) separable anti-aliased downsample by ``factor``."""
    k = _kaiser_sinc_1d(k_size, 1.0 / factor, beta)
    return _sep_conv_axis(_sep_conv_axis(x, k, -2, factor), k, -3, factor)


def filtered_upsample_2d(x: torch.Tensor, k_size: int = 15, beta: float = 1.5,
                         factor: int = 2) -> torch.Tensor:
    """(..., H, W, C) zero-stuffed, then low-passed: an anti-aliased upsample."""
    k = _kaiser_sinc_1d(k_size, 1.0 / factor, beta) * factor
    h, w = x.shape[-3], x.shape[-2]
    z = x.new_zeros(x.shape[:-3] + (h * factor, w * factor, x.shape[-1]))
    z[..., ::factor, ::factor, :] = x
    return _sep_conv_axis(_sep_conv_axis(z, k, -2, 1), k, -3, 1)
