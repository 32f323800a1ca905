# Config copied from dualdiffusion_tpu/models/formats/raw.py; transforms on torch.
"""Raw-waveform format with FFT-domain mel-density pre-emphasis and an
optional dual-channel analytic-signal form (JAX: dualdiffusion_tpu/models/
formats/raw.py; reference: src/modules/formats/raw.py:33-104): reflect pad
by half the length, ortho rfft, an optional per-sample phase rotation,
division by the mean-normalized mel density, then irfft (single channel) or
the complex ifft of the one-sided spectrum as real and imaginary planes
(dual channel).

Layout: (B, D, C, T) with D = 1 (single) or 2 (real, imaginary).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops.mel import mel_density
from ...ops.stft import reflect_pad
from .format import Format, FormatConfig, register_format


@dataclass
class RawFormatConfig(FormatConfig):
    """Field names and defaults of the JAX RawFormatConfig."""
    default_raw_length: int = 1409024
    dual_channel: bool = False
    mel_density_scaling: bool = True
    scale: float = 39.05
    width_alignment: int = 2048


def _reflect_half(x: torch.Tensor) -> torch.Tensor:
    """Reflect pad the last axis by half its length on each side."""
    return reflect_pad(x, x.shape[-1] // 2)


@register_format("raw")
class RawFormat(Format):
    config_class = RawFormatConfig

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        cfg = self.config
        raw_length = raw_length or cfg.default_raw_length
        return raw_length // cfg.width_alignment * cfg.width_alignment

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        cfg = self.config
        return (bsz, int(cfg.dual_channel) + 1, cfg.num_raw_channels,
                self.get_raw_crop_width(raw_length))

    def _density(self, padded_len: int, like: torch.Tensor) -> torch.Tensor:
        freq = np.fft.rfftfreq(padded_len, d=1.0 / self.config.sample_rate)
        d = np.asarray(mel_density(freq), np.float64)
        return torch.as_tensor((d / d.mean()).astype(np.float32), device=like.device)

    def raw_to_sample(self, raw: torch.Tensor,
                      theta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, T) -> (B, D, C, T). ``theta`` (B,) rotates each sample's
        spectrum (the JAX ``random_phase_augmentation``, whose angles it
        draws itself)."""
        cfg = self.config
        t = raw.shape[-1]
        xp = _reflect_half(raw.float())
        rfft = torch.fft.rfft(xp, norm="ortho")
        if theta is not None:
            rfft = rfft * torch.exp(1j * theta.float())[:, None, None]
        if cfg.mel_density_scaling:
            rfft = rfft / self._density(xp.shape[-1], rfft)
        if not cfg.dual_channel:
            y = torch.fft.irfft(rfft, n=xp.shape[-1], norm="ortho")
            return y[..., t // 2: t // 2 + t][:, None] * cfg.scale
        full = torch.zeros(xp.shape, dtype=torch.complex64, device=xp.device)
        full[..., : rfft.shape[-1]] = rfft
        y = torch.fft.ifft(full, norm="ortho")
        y = torch.stack([y.real, y.imag], dim=1)
        return y[..., t // 2: t // 2 + t] * (cfg.scale * 2.0)

    def sample_to_raw(self, sample: torch.Tensor) -> torch.Tensor:
        """(B, D, C, T) -> (B, C, T)."""
        cfg = self.config
        if not cfg.dual_channel:
            x = sample[:, 0].float() / cfg.scale
            t = x.shape[-1]
            xp = _reflect_half(x)
            rfft = torch.fft.rfft(xp, norm="ortho")
        else:
            # the factor 2 of raw_to_sample cancels against the one-sided /2
            re, im = sample[:, 0].float() / cfg.scale, sample[:, 1].float() / cfg.scale
            t = re.shape[-1]
            xp = torch.complex(_reflect_half(re), _reflect_half(im))
            ft = torch.fft.fft(xp, norm="ortho")
            rfft = ft[..., : ft.shape[-1] // 2 + 1] / 2.0
        if cfg.mel_density_scaling:
            rfft = rfft * self._density(xp.shape[-1], rfft)
        y = torch.fft.irfft(rfft, n=xp.shape[-1], norm="ortho")
        return y[..., t // 2: t // 2 + t]
