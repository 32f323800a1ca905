# Config copied from dualdiffusion_tpu/models/formats/mdct.py; transforms on torch.
"""Standalone MDCT format: a 256-sample window, an optional dual-channel
(real and imaginary MCLT) output, mel-density normalization (JAX:
dualdiffusion_tpu/models/formats/mdct.py; reference:
src/modules/formats/mdct.py:35-118).

Layout: (B, N, frames, C) channel last.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops.mdct import imdct, mdct
from ...ops.mel import mel_density
from .format import Format, FormatConfig, register_format
from .ms_mdct_dual import _MDCT_WINDOW_MAP


@dataclass
class MDCTFormatConfig(FormatConfig):
    """Field names and defaults of the JAX MDCTFormatConfig."""
    default_raw_length: int = 1409024
    width_alignment: int = 32768
    mdct_to_raw_scale: float = 1.0
    raw_to_mdct_scale: float = 196.36579562832198
    mdct_window_len: int = 256
    mdct_window_func: str = "sin"

    @property
    def mdct_num_frequencies(self) -> int:
        return self.mdct_window_len // 2


@register_format("mdct")
class MDCTFormat(Format):
    config_class = MDCTFormatConfig

    def __init__(self, config: MDCTFormatConfig) -> None:
        super().__init__(config)
        hz = ((np.arange(config.mdct_num_frequencies) + 0.5) * config.sample_rate
              / config.mdct_window_len)
        self.mdct_mel_density = np.asarray(mel_density(hz), np.float32)
        self.window_fn = _MDCT_WINDOW_MAP[config.mdct_window_func]

    def _dens(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.mdct_mel_density, device=like.device)[:, None]

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        cfg = self.config
        raw_length = raw_length or cfg.default_raw_length
        return raw_length // cfg.width_alignment * cfg.width_alignment - cfg.mdct_num_frequencies

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        cfg = self.config
        w = self.get_raw_crop_width((raw_length or cfg.default_raw_length)
                                    + cfg.mdct_num_frequencies)
        n = cfg.mdct_num_frequencies
        return (bsz, n, (w + n) // n, cfg.num_raw_channels)

    def raw_to_mdct(self, raw: torch.Tensor, theta: Optional[torch.Tensor] = None,
                    dual_channel: bool = False) -> torch.Tensor:
        """(B, C, T) -> (B, N, frames, C or 2C); ``theta`` (B,) rotates each
        sample's MCLT phases (the JAX ``random_phase_augmentation``)."""
        cfg = self.config
        re, im = mdct(raw.float(), cfg.mdct_window_len, window_fn=self.window_fn,
                      return_complex=True)
        if theta is not None:
            c = torch.cos(theta)[:, None, None, None]
            s = torch.sin(theta)[:, None, None, None]
            re, im = re * c - im * s, re * s + im * c
        dens = self._dens(re)
        out = torch.cat([re / dens, im / dens], dim=1) if dual_channel else re / dens
        return (out * cfg.raw_to_mdct_scale).permute(0, 2, 3, 1)

    raw_to_sample = raw_to_mdct

    def mdct_to_raw(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(B, N, frames, C) -> (B, C, T)."""
        cfg = self.config
        x = coeffs.float().permute(0, 3, 1, 2)
        x = x * self._dens(x) / cfg.raw_to_mdct_scale
        return imdct(x, cfg.mdct_window_len, window_fn=self.window_fn) * cfg.mdct_to_raw_scale

    sample_to_raw = mdct_to_raw

    def raw_to_mdct_psd(self, raw: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        re, im = mdct(raw.float(), cfg.mdct_window_len, window_fn=self.window_fn,
                      return_complex=True)
        psd = torch.sqrt(re * re + im * im) / self._dens(re) * cfg.raw_to_mdct_scale
        return psd.permute(0, 2, 3, 1)
