# Config copied from dualdiffusion_tpu/models/formats/mdct_psd.py; transforms on torch.
"""MDCT-PSD format: PSD-conditioned MDCT with the P2M (patch-to-MDCT) 2-D
lapped transform (JAX: dualdiffusion_tpu/models/formats/mdct_psd.py;
reference: src/modules/formats/mdct_psd.py:35-236):

* an FFT-domain linear-ramp high-pass pre-filter (28.9 Hz down to 20 Hz);
* mel-density normalized MDCT and MDCT-PSD transforms;
* the PSD scaling of MDCT coefficients, mdct / (psd + eps) * scale;
* P2M: a 2-D lapped MDCT over (freq, time) blocks of the MDCT spectrogram
  (``mdct2`` / ``imdct2``; reference: src/utils/mdct/functional.py:213-230),
  its block frequencies folded into channels with the audio channels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...ops.mdct import imdct, mdct
from ...ops.mel import mel_density
from ..mp import midside_transform
from .format import Format, FormatConfig, register_format
from .ms_mdct_dual import _MDCT_WINDOW_MAP
from .raw import _reflect_half


@dataclass
class MDCTPSDFormatConfig(FormatConfig):
    """Field names and defaults of the JAX MDCTPSDFormatConfig."""
    default_raw_length: int = 1409024
    width_alignment: int = 32768
    low_cut_start_hz: float = 28.862
    low_cut_end_hz: float = 20.0
    raw_to_mdct_scale: float = 275.47124      # stereo @ -20 LUFS
    mdct_psd_scale: float = 1.1785113
    mdct_psd_eps: float = 1e-2
    mdct_window_len: int = 512
    mdct_window_func: str = "sin"
    mdct_psd_to_p2m_scale: float = 30.9832693
    p2m_psd_scale: float = 1.765726368
    p2m_psd_eps: float = 1e-2
    p2m_use_midside_transform: bool = True
    p2m_block_width: int = 16
    p2m_window_func: str = "sin"

    @property
    def mdct_num_frequencies(self) -> int:
        return self.mdct_window_len // 2

    @property
    def p2m_num_frequencies(self) -> int:
        return self.p2m_block_width ** 2 // 4

    @property
    def p2m_block_hop_length(self) -> int:
        return self.p2m_block_width // 2


def mdct2(x: torch.Tensor, block_width: int, window_fn: str = "sin_mdct") -> torch.Tensor:
    """2-D lapped MDCT of (..., H, W): the MDCT over W, then over H ->
    (..., Nw, Fw, Nh, Fh)."""
    a = mdct(x, block_width, window_fn=window_fn)              # (..., H, N, Fw)
    return mdct(torch.movedim(a, -3, -1), block_width, window_fn=window_fn)


def imdct2(y: torch.Tensor, block_width: int, window_fn: str = "sin_mdct") -> torch.Tensor:
    a = imdct(y, block_width, window_fn=window_fn)             # (..., N, Fw, H)
    return imdct(torch.movedim(a, -1, -3), block_width, window_fn=window_fn)


@register_format("mdct_psd")
class MDCTPSDFormat(Format):
    config_class = MDCTPSDFormatConfig

    def __init__(self, config: MDCTPSDFormatConfig) -> None:
        super().__init__(config)
        hz = ((np.arange(config.mdct_num_frequencies) + 0.5) * config.sample_rate
              / config.mdct_window_len)
        self.mdct_mel_density = np.asarray(mel_density(hz), np.float32)
        self.window_fn = _MDCT_WINDOW_MAP.get(config.mdct_window_func, config.mdct_window_func)
        self.p2m_window_fn = _MDCT_WINDOW_MAP.get(config.p2m_window_func,
                                                  config.p2m_window_func)

    def _dens(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.mdct_mel_density, device=like.device)[:, None]

    def _high_pass(self, raw: torch.Tensor) -> torch.Tensor:
        """A linear ramp from ``low_cut_end_hz`` (0) to ``low_cut_start_hz`` (1)
        on the rfft of the half-length reflect-padded signal."""
        cfg = self.config
        cutoff = cfg.low_cut_end_hz
        if cutoff <= 0 or (cfg.low_cut_start_hz - cutoff) <= 0:
            return raw
        t = raw.shape[-1]
        xp = _reflect_half(raw.float())
        rfft = torch.fft.rfft(xp, norm="ortho")
        freq = np.fft.rfftfreq(xp.shape[-1], d=1.0 / cfg.sample_rate)
        filt = np.clip((freq - cutoff) / (cfg.low_cut_start_hz - cutoff), 0, 1)
        y = torch.fft.irfft(rfft * torch.as_tensor(filt.astype(np.float32), device=xp.device),
                            n=xp.shape[-1], norm="ortho")
        return y[..., t // 2: t // 2 + t]

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        cfg = self.config
        raw_length = raw_length or cfg.default_raw_length
        return raw_length // cfg.width_alignment * cfg.width_alignment - cfg.mdct_num_frequencies

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None):
        cfg = self.config
        w = self.get_raw_crop_width((raw_length or cfg.default_raw_length)
                                    + cfg.mdct_num_frequencies)
        n = cfg.mdct_num_frequencies
        return (bsz, n, (w + n) // n, cfg.num_raw_channels)

    def raw_to_mdct(self, raw: torch.Tensor, theta: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """(B, C, T) -> (B, N, frames, C); ``theta`` (B,) rotates each
        sample's phases first (the JAX ``random_phase_augmentation``)."""
        cfg = self.config
        re, im = mdct(self._high_pass(raw), cfg.mdct_window_len, window_fn=self.window_fn,
                      return_complex=True)
        if theta is not None:
            re = re * torch.cos(theta)[:, None, None] - im * torch.sin(theta)[:, None, None]
        return (re / self._dens(re) * cfg.raw_to_mdct_scale).permute(0, 2, 3, 1)

    raw_to_sample = raw_to_mdct

    def raw_to_mdct_psd(self, raw: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        re, im = mdct(self._high_pass(raw), cfg.mdct_window_len, window_fn=self.window_fn,
                      return_complex=True)
        psd = torch.sqrt(re ** 2 + im ** 2) / self._dens(re) * cfg.raw_to_mdct_scale / 2.0 ** 0.5
        return psd.permute(0, 2, 3, 1)

    def mdct_to_raw(self, coeffs: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = coeffs.float().permute(0, 3, 1, 2)
        return imdct(x * self._dens(x) / cfg.raw_to_mdct_scale, cfg.mdct_window_len,
                     window_fn=self.window_fn)

    sample_to_raw = mdct_to_raw

    def scale_mdct_from_psd(self, mdct_c: torch.Tensor, psd: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return mdct_c / (psd + cfg.mdct_psd_eps) * cfg.mdct_psd_scale

    def unscale_mdct_from_psd(self, mdct_c: torch.Tensor, psd: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return mdct_c * (psd + cfg.mdct_psd_eps) / cfg.mdct_psd_scale

    def mdct_to_p2m(self, mdct_c: torch.Tensor) -> torch.Tensor:
        """(B, N, F, C) MDCT -> (B, Fh, Fw, C * Nh * Nw): the 2-D lapped
        transform's block frequencies folded with the audio channels."""
        cfg = self.config
        x = mdct_c.float().permute(0, 3, 1, 2)                   # (B, C, N, F)
        if cfg.p2m_use_midside_transform:
            x = midside_transform(x, channel_dim=1)
        y = mdct2(x, cfg.p2m_block_width, self.p2m_window_fn)  # (B, C, Nw, Fw, Nh, Fh)
        b, c, nw, fw, nh, fh = y.shape
        y = y.permute(0, 5, 3, 1, 4, 2)                          # (B, Fh, Fw, C, Nh, Nw)
        return y.reshape(b, fh, fw, c * nh * nw) * cfg.mdct_psd_to_p2m_scale

    def p2m_to_mdct(self, p2m: torch.Tensor, num_channels: int = 2) -> torch.Tensor:
        """Inverse of ``mdct_to_p2m`` -> (B, N, F, C)."""
        cfg = self.config
        b, fh, fw, _ = p2m.shape
        n = cfg.p2m_block_width // 2
        y = (p2m.float() / cfg.mdct_psd_to_p2m_scale).reshape(b, fh, fw, num_channels, n, n)
        x = imdct2(y.permute(0, 3, 5, 2, 4, 1), cfg.p2m_block_width, self.p2m_window_fn)
        if cfg.p2m_use_midside_transform:
            x = midside_transform(x, channel_dim=1)
        return x.permute(0, 2, 3, 1)
