"""Magnitude-preserving layers, channel last (JAX: dualdiffusion_tpu/models/
layers.py:102-104, 160-269, 451-625, 629-841; reference: src/modules/
mp_tools.py:316-495, src/utils/resample.py:28-280): MPConv, MPFourier,
AdaptiveGroupBalance, FilteredDownsample2D and the kaiser-windowed-sinc
filtered resamplers.

MP weights are stored reference-style as (out, in/groups, *kernel) under
the parameter name ``w_mp`` (``w_raw`` when weight norm is disabled).
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import GroupedConv3x3Fn, grouped_conv3x3, prepare_weights
from ..parallel.collectives import copy_to_group, gather_last_dim, gather_rows, shard_of
from ..utils.trace import span
from .mp import mp_silu, mp_sum_groups, normalize

MP_WEIGHT_NAME = "w_mp"
RAW_WEIGHT_NAME = "w_raw"

#: set while the layers run inside an enclosing activation checkpoint
_REMATERIALIZED = ContextVar("dd_rematerialized", default=False)


@contextmanager
def rematerialized():
    """Run the enclosed layers inside an enclosing non-reentrant
    ``checkpoint`` (a rematerialized UNet block): an FSDP layer then gathers
    its weight without a checkpoint of its own, since the enclosing one
    already keeps nothing made from the whole weight and runs the gather
    again in its recompute (two gathers a step, not three)."""
    token = _REMATERIALIZED.set(True)
    try:
        yield
    finally:
        _REMATERIALIZED.reset(token)


def normalize_weight(w: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Unit RMS per output channel (dim 0) of a weight."""
    return normalize(w, dim=tuple(range(1, w.dim())), eps=eps)


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

    ``gain``: a number or a 0-d tensor scales the weight; a (B,) or
    (B, C_out) tensor, a per-sample gain, scales the output before the bias
    (JAX layers.py:250-257), so K1's prepared weights, cached at gain 1,
    serve every sample. Under tensor parallelism such a gain multiplies the
    gathered output, which every rank holds whole, so its gradient is the
    whole layer's on every rank; under FSDP it stays outside the
    checkpointed layer.
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
        """The parameter (under FSDP or tensor parallelism, this rank's rows)."""
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

    def _scaled_weight(self, w: torch.Tensor, gain, training: bool,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The layer's weight as it multiplies: normalized (training), scaled
        by its fan-in and ``gain``, cast to ``dtype``. Outside training this
        is work on an unchanged weight, redone each forward: a
        ``dd.model.weight_prep`` span."""
        if training:
            return self._scale(w, gain, True, dtype)
        with span("dd.model.weight_prep"):
            return self._scale(w, gain, False, dtype)

    def _scale(self, w: torch.Tensor, gain, training: bool,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if training and not self.disable_weight_norm:
            w = normalize_weight(w)
        w = w / np.sqrt(float(np.prod(w.shape[1:])))
        if not (isinstance(gain, (int, float)) and gain == 1.0):
            w = w * gain
        return w if dtype is None else w.to(dtype)

    def _uses_kernel(self, x: torch.Tensor, groups: int) -> bool:
        return groups > 1 and self.kernel == (3, 3) and self.stride == 1 and x.dim() == 4

    def _kernel_weight(self, gain, dtype, groups: int) -> torch.Tensor:
        """K1's pre-arranged weights of the module's own parameter (a
        tensor-parallel row shard included), made once and reused until the
        parameter changes."""
        w = self.weight
        gain_key = gain if isinstance(gain, (int, float)) else (id(gain), gain._version)
        key = (w._version, w.data_ptr(), gain_key, dtype)
        if self._kernel_weight_cache is None or self._kernel_weight_cache[0] != key:
            self._kernel_weight_cache = (key, self._prepared_weight(w, gain, groups, dtype))
        return self._kernel_weight_cache[1]

    def _prepared_weight(self, w: torch.Tensor, gain, groups: int, dtype) -> torch.Tensor:
        """K1's pre-arranged eval weights of ``w``: a ``dd.model.weight_prep`` span."""
        with torch.no_grad(), span("dd.model.weight_prep"):
            return prepare_weights(self._scale(w, gain, False), groups, dtype)

    def forward(self, x: torch.Tensor, gain: Union[float, torch.Tensor] = 1.0,
                training: bool = False) -> torch.Tensor:
        out_gain = None
        if isinstance(gain, torch.Tensor) and gain.dim() > 0:
            out_gain, gain = gain, 1.0
        shard = shard_of(self.weight)
        if shard is None:
            out = self._layer(x, self.weight, self.groups, gain, training, cacheable=True)
        elif shard.mode == "tp":
            out = self._forward_column_parallel(x, gain, training, shard)
        else:
            out = self._forward_gathered(x, gain, training, shard)
        if out_gain is not None:
            if out_gain.dim() == 2:     # (B, C_out) -> (B, 1, ..., 1, C_out)
                g = out_gain.reshape((out_gain.shape[0],) + (1,) * (out.dim() - 2)
                                     + (out_gain.shape[1],))
            else:                       # (B,) -> (B, 1, ..., 1)
                g = out_gain.reshape(out_gain.shape + (1,) * (out.dim() - out_gain.dim()))
            out = out * g.to(out.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    def _forward_gathered(self, x: torch.Tensor, gain, training: bool,
                          shard) -> torch.Tensor:
        """FSDP: the layer with its whole weight, all-gathered from the row
        shards where it is used (the backward reduce-scatters the weight's
        gradient). Under autograd the gather and the layer run again in the
        backward (``checkpoint``), so no whole weight, and nothing made from
        one, outlives the layer: between the forward and the backward the
        step keeps each layer's input and row shard alone. Inside a
        ``rematerialized`` block the block's checkpoint does this."""
        def layer(x, w, gain):
            whole = gather_rows(w, shard.axis, 1.0 / shard.axis.size)
            return self._layer(x, whole, self.groups, gain, training, cacheable=False)

        if not torch.is_grad_enabled() or _REMATERIALIZED.get():
            return layer(x, self.weight, gain)
        return checkpoint(layer, x, self.weight, gain, use_reentrant=False,
                          preserve_rng_state=False)

    def _forward_column_parallel(self, x: torch.Tensor, gain, training: bool,
                                 shard) -> torch.Tensor:
        """Tensor parallelism: this rank's rows of the weight are its slice of
        the output channels (its groups, and their input channels, for a
        grouped layer); the slices are all-gathered along the channels. The
        gradients of the input and of a gain, which each rank sees through its
        slice alone, are summed over the group (Megatron's f and g)."""
        n, groups = shard.axis.size, self.groups
        x = copy_to_group(x, shard)
        if isinstance(gain, torch.Tensor):
            gain = copy_to_group(gain, shard)
        if groups > 1:
            c = x.shape[-1] // n
            x = x[..., shard.axis.rank * c:(shard.axis.rank + 1) * c]
            groups //= n
        out = self._layer(x, self.weight, groups, gain, training, cacheable=True)
        return gather_last_dim(out, shard)

    def _layer(self, x: torch.Tensor, w: torch.Tensor, groups: int, gain, training: bool,
               cacheable: bool) -> torch.Tensor:
        """The layer with weight ``w`` (out, in/groups, *kernel) in ``groups``
        groups, without the bias; ``cacheable``: ``w`` is the module's own
        parameter, whose K1 weights may be kept."""
        if len(self.kernel) == 0:
            w = self._scaled_weight(w, gain, training, x.dtype)
            if groups > 1:
                cin, cout = x.shape[-1], w.shape[0]
                xg = x.reshape(x.shape[:-1] + (groups, cin // groups))
                wg = w.reshape(groups, cout // groups, cin // groups)
                out = torch.einsum("...gi,goi->...go", xg, wg)
                return out.reshape(x.shape[:-1] + (cout,))
            return torch.matmul(x, w.t())
        if self._uses_kernel(x, groups) and training:
            # no weight cache: the prepared weights carry the parameter's grad
            wt = prepare_weights(self._scaled_weight(w, gain, True), groups, x.dtype)
            return GroupedConv3x3Fn.apply(x.contiguous(), wt, groups)
        if self._uses_kernel(x, groups):
            wt = (self._kernel_weight(gain, x.dtype, groups) if cacheable else
                  self._prepared_weight(w, gain, groups, x.dtype))
            return grouped_conv3x3(x.contiguous(), wt, groups)
        return self._conv(x, self._scaled_weight(w, gain, training, x.dtype), groups)

    def _conv(self, x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
        if len(self.kernel) == 3:
            return self._conv3d(x, w, groups)
        kh, kw = self.kernel
        if self.stride == 1 and (kh, kw) == (1, 1) and groups == 1:
            # 1x1 conv == matmul over the channel dim
            return torch.matmul(x, w.reshape(w.shape[0], w.shape[1]).t())
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride,
                     padding=(kh // 2, kw // 2), groups=groups)
        return y.permute(0, 2, 3, 1)


    def _conv3d(self, x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
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
            if self.stride == 1 and (kh, kw) == (1, 1) and groups == 1:
                return torch.matmul(x, w.reshape(w.shape[0], w.shape[1]).t())
            y = F.conv2d(x.reshape((b * z,) + x.shape[2:]).permute(0, 3, 1, 2), w[:, :, 0],
                         stride=self.stride, padding=(kh // 2, pad_w), groups=groups)
            y = y.permute(0, 2, 3, 1)
            return y.reshape((b, z) + y.shape[1:])
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=(1, self.stride, self.stride),
                     padding=(1 if kz == 3 else 0, kh // 2, pad_w), groups=groups)
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


class AdaptiveGroupBalance(nn.Module):
    """A learned per-group ``mp_sum`` balance of two activations, from the
    embedding through a zero-initialised linear ``emb_balance`` (or, with
    ``emb_channels`` 0, a zero-initialised parameter ``balance`` of shape
    (groups,)), sigmoid of the logits plus ``balance_logits_offset`` clipped
    to [min_balance, max_balance] (JAX layers.py:652-673; reference:
    mp_tools.py:380-411)."""

    def __init__(self, emb_channels: int, groups: int = 1,
                 balance_logits_offset: float = 0.0, min_balance: float = 0.1,
                 max_balance: float = 0.9, device=None):
        super().__init__()
        self.emb_channels = emb_channels
        self.groups = groups
        self.balance_logits_offset = balance_logits_offset
        self.min_balance = min_balance
        self.max_balance = max_balance
        if emb_channels > 0:
            self.emb_balance = MPConv(emb_channels, groups, kernel=(),
                                      disable_weight_norm=True, zero_init=True, device=device)
            self.emb_balance.init_weights(None)
        else:
            self.balance = nn.Parameter(torch.zeros(groups, device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor, emb: Optional[torch.Tensor],
                training: bool = False) -> torch.Tensor:
        """x, y (B, ..., C) channel last; emb (B, emb_channels), unused
        without ``emb_balance``."""
        if self.emb_channels > 0:
            balance = self.emb_balance(emb, training=training)
        else:
            balance = self.balance.expand(x.shape[0], self.groups)
        balance = torch.sigmoid(balance + self.balance_logits_offset)
        balance = balance.clamp(self.min_balance, self.max_balance)
        return mp_sum_groups(x, y, balance, self.groups)


# ---------------------------------------------------------------------------
# filtered (anti-aliased) resamplers on channel-last tensors (JAX layers.py:680-841)
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
    z = _zero_stuff(x, factor, (-3, -2))
    return _sep_conv_axis(_sep_conv_axis(z, k, -2, 1), k, -3, 1)


def _zero_stuff(x: torch.Tensor, factor: int, dims: Tuple[int, ...]) -> torch.Tensor:
    """``x`` with ``factor - 1`` zeros after each entry along each of ``dims``."""
    shape = list(x.shape)
    index = [slice(None)] * x.dim()
    for d in dims:
        shape[d] *= factor
        index[d] = slice(None, None, factor)
    z = x.new_zeros(shape)
    z[tuple(index)] = x
    return z


def filtered_downsample_1d(x: torch.Tensor, k_size: int = 7, beta: float = 1.5,
                           factor: int = 2) -> torch.Tensor:
    """(..., T, C) anti-aliased downsample along T by ``factor``."""
    return _sep_conv_axis(x, _kaiser_sinc_1d(k_size, 1.0 / factor, beta), -2, factor)


def filtered_upsample_1d(x: torch.Tensor, k_size: int = 15, beta: float = 1.5,
                         factor: int = 2) -> torch.Tensor:
    """(..., T, C) zero-stuffed along T, then low-passed (gain ``factor``)."""
    k = _kaiser_sinc_1d(k_size, 1.0 / factor, beta) * factor
    return _sep_conv_axis(_zero_stuff(x, factor, (-2,)), k, -2, 1)


def filtered_mp_silu_2d(x: torch.Tensor, k_size: int = 7, beta: float = 1.5) -> torch.Tensor:
    """Alias-suppressed MP-SiLU of (..., H, W, C): upsample 2x, silu,
    downsample 2x (reference: resample.py:155-165)."""
    up = filtered_upsample_2d(x, k_size=k_size * 2 + k_size % 2, beta=beta, factor=2)
    return filtered_downsample_2d(mp_silu(up), k_size=k_size, beta=beta, factor=2)


class FilteredDownsample2D(nn.Module):
    """The sin^2-separable FIR anti-aliased strided downsample of the
    supersampled-latent DAE encoders (JAX layers.py:757-784; reference:
    mp_tools.py:455-495): a normalised ``kernel`` x ``kernel`` filter,
    reflect padding (k//2, k//2 - (k+1)%2) on H and W, a depthwise conv at
    ``stride``. Takes (..., H, W, C) with any leading dims, the stereo-folded
    (B, Z, H, W, C) filtered one z-plane at a time. No parameters: the filter
    is a buffer that the state dict does not hold."""

    def __init__(self, kernel: int = 16, stride: int = 8, device=None):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        k = np.sin(np.arange(kernel) / kernel * np.pi)
        k2 = k[:, None] * k[None, :]
        self.register_buffer("filter", torch.as_tensor(k2 / k2.sum(), dtype=torch.float64,
                                                       device=device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1, p2 = self.kernel // 2, self.kernel // 2 - (self.kernel + 1) % 2
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        xp = F.pad(x.reshape((-1, h, w, c)).permute(0, 3, 1, 2), (p1, p2, p1, p2),
                   mode="reflect")
        wk = self.filter.to(x.dtype).expand(c, 1, self.kernel, self.kernel)
        y = F.conv2d(xp, wk, stride=self.stride, groups=c).permute(0, 2, 3, 1)
        return y.reshape(lead + y.shape[1:])


def filtered_downsample_3d(x: torch.Tensor, k_size: int = 7, beta: float = 1.5,
                           factor: int = 2) -> torch.Tensor:
    """Stereo-folded (..., Z, H, W, C) anti-aliased downsample of H and W, Z
    untouched, each axis's filter with gain sqrt(factor) (reference:
    resample.py:196-199; the 2-D version has gain 1)."""
    k = _kaiser_sinc_1d(k_size, 1.0 / factor, beta) * np.sqrt(factor)
    return _sep_conv_axis(_sep_conv_axis(x, k, -2, factor), k, -3, factor)


def filtered_upsample_3d(x: torch.Tensor, k_size: int = 15, beta: float = 1.5,
                         factor: int = 2) -> torch.Tensor:
    """Stereo-folded (..., Z, H, W, C): H and W zero-stuffed, then
    interpolated, each axis's filter with gain sqrt(factor) (reference:
    resample.py:201-215)."""
    k = _kaiser_sinc_1d(k_size, 1.0 / factor, beta) * np.sqrt(factor)
    z = _zero_stuff(x, factor, (-3, -2))
    return _sep_conv_axis(_sep_conv_axis(z, k, -2, 1), k, -3, 1)


def filtered_mp_silu_3d(x: torch.Tensor, k_size: int = 7, beta: float = 1.5) -> torch.Tensor:
    """``filtered_mp_silu_2d`` on stereo-folded (..., Z, H, W, C) tensors
    (reference: resample.py:216-225)."""
    up = filtered_upsample_3d(x, k_size=k_size * 2 + k_size % 2, beta=beta, factor=2)
    return filtered_downsample_3d(mp_silu(up), k_size=k_size, beta=beta, factor=2)


def filtered_downsample_1d3(x: torch.Tensor, k_size: int = 7, beta: float = 1.5,
                            factor: int = 2) -> torch.Tensor:
    """W-only filtered downsample of a stereo-folded (..., Z, H, W, C) tensor
    (reference: resample.py:262-265): ``filtered_downsample_1d`` along W."""
    return filtered_downsample_1d(x, k_size, beta, factor)


def filtered_upsample_1d3(x: torch.Tensor, k_size: int = 15, beta: float = 1.5,
                          factor: int = 2) -> torch.Tensor:
    """W-only filtered upsample, gain ``factor`` (reference:
    resample.py:267-280): ``filtered_upsample_1d`` along W."""
    return filtered_upsample_1d(x, k_size, beta, factor)
