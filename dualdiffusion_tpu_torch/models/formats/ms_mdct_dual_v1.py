# Config and constants copied from dualdiffusion_tpu/models/formats/ms_mdct_dual_v1.py; transforms on torch.
"""MS+MDCT dual format v1: a mel spectrogram of two blackman-harris windows
blended by the squared mel density, and an MCLT path for the diffusion
decoder (JAX: dualdiffusion_tpu/models/formats/ms_mdct_dual_v1.py;
reference: src/modules/formats/ms_mdct_dual.py:35-329).

* two STFTs with blackman-harris**17 (low: frequency resolution) and **58
  (high: time resolution) windows, each window L2-normalized, blended per
  bin with weight (mel density / max)**2;
* the slaney triangular mel filterbank over blended / mel density, then
  ** ms_abs_exponent * scale + offset;
* ``mel_spec_to_mdct_psd``: the mel unscaled to the linear bins of the
  MDCT-domain conditioning through the filterbank's pseudoinverse;
* an optional linear-ramp high-pass from ``ms_freq_min`` to the lowest
  mel filter's frequency;
* MDCT: a 512-sample kaiser-bessel-derived MCLT, mel-density normalized,
  optionally dual channel (real and imaginary), with an optional phase
  rotation whose angles the caller passes (``theta``, one per sample).

Layouts: mel (B, F=256, T', C); MDCT (B, N=256, frames, C or 2C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops.mdct import imclt, mclt
from ...ops.mel import FrequencyScale, mel_density
from ...ops.stft import stft
from ...ops.windows import get_window
from .format import Format, FormatConfig, register_format
from .raw import _reflect_half


@dataclass
class MSMDCTDualV1FormatConfig(FormatConfig):
    """Field names and defaults of the JAX MSMDCTDualV1FormatConfig."""
    raw_to_mel_spec_scale: float = 50.0
    raw_to_mel_spec_offset: float = 0.0
    mel_spec_to_mdct_psd_scale: float = 0.18
    mel_spec_to_mdct_psd_offset: float = 0.0
    mdct_to_raw_scale: float = 2.0
    raw_to_mdct_scale: float = 12.1

    mdct_window_len: int = 512
    mdct_window_func: str = "kaiser_bessel_derived"  # or "sin"
    mdct_psd_num_bins: int = 2048
    mdct_dual_channel: bool = False

    ms_abs_exponent: float = 1.0
    ms_freq_min: float = 0.0
    ms_width_alignment: int = 128
    ms_num_frequencies: int = 256
    ms_step_size_ms: int = 8
    ms_window_duration_ms: int = 128
    ms_padded_duration_ms: int = 128
    ms_window_exponent_low: float = 17.0
    ms_window_exponent_high: Optional[float] = 58.0
    ms_window_func: str = "blackman_harris"  # or "hann"

    @property
    def mdct_num_frequencies(self) -> int:
        return self.mdct_window_len // 2

    @property
    def ms_frame_padded_length(self) -> int:
        return int(self.ms_padded_duration_ms / 1000.0 * self.sample_rate)

    @property
    def ms_win_length(self) -> int:
        return int(self.ms_window_duration_ms / 1000.0 * self.sample_rate)

    @property
    def ms_frame_hop_length(self) -> int:
        return int(self.ms_step_size_ms / 1000.0 * self.sample_rate)

    @property
    def ms_num_stft_bins(self) -> int:
        return self.ms_frame_padded_length // 2 + 1


def _ms_window(cfg: MSMDCTDualV1FormatConfig, exponent: float) -> np.ndarray:
    if cfg.ms_window_func == "blackman_harris":
        win = get_window("blackman_harris", cfg.ms_win_length) ** exponent
    else:
        win = get_window("hann_power", cfg.ms_win_length, exponent=exponent, periodic=True)
    return (win / np.sqrt((win ** 2).sum())).astype(np.float64)


@register_format("ms_mdct_dual_v1")
class MSMDCTDualV1Format(Format):
    config_class = MSMDCTDualV1FormatConfig

    def __init__(self, config: MSMDCTDualV1FormatConfig) -> None:
        super().__init__(config)
        cfg = config
        self.win_low = _ms_window(cfg, cfg.ms_window_exponent_low)
        self.win_high = (_ms_window(cfg, cfg.ms_window_exponent_high)
                         if cfg.ms_window_exponent_high is not None else None)
        self.ms_freq_scale = FrequencyScale(
            freq_scale="mel", freq_min=cfg.ms_freq_min, freq_max=cfg.sample_rate / 2,
            sample_rate=cfg.sample_rate, num_stft_bins=cfg.ms_num_stft_bins,
            num_filters=cfg.ms_num_frequencies, filter_norm="slaney", filter_shape="triangular")
        self.ms_lowest_filter_freq = float(
            self.ms_freq_scale.get_unscaled(cfg.ms_num_frequencies + 2)[1])

        stft_hz = np.linspace(0, cfg.sample_rate / 2, cfg.ms_num_stft_bins)
        self.ms_stft_mel_density = np.asarray(mel_density(stft_hz), np.float32)
        dens = np.asarray(mel_density(stft_hz), np.float64)
        self.spec_blend_weight = ((dens / dens.max()) ** 2).astype(np.float32)

        # the reference reuses the main bank and crops its last bin when the
        # PSD has one bin fewer than the STFT (reference :155-168)
        if cfg.mdct_psd_num_bins == cfg.ms_num_stft_bins - 1:
            psd_filters = self.ms_freq_scale.filters
            self._psd_crop_last = True
        else:
            psd_filters = FrequencyScale(
                freq_scale="mel", freq_min=cfg.ms_freq_min, freq_max=cfg.sample_rate / 2,
                sample_rate=cfg.sample_rate, num_stft_bins=cfg.mdct_psd_num_bins,
                num_filters=cfg.ms_num_frequencies, filter_norm="slaney",
                filter_shape="triangular").filters
            self._psd_crop_last = False
        self._psd_pinv = np.linalg.pinv(np.asarray(psd_filters, np.float64).T,
                                        rcond=1e-10).astype(np.float32)

        mdct_hz = ((np.arange(cfg.mdct_num_frequencies) + 0.5) * cfg.sample_rate
                   / cfg.mdct_window_len)
        self.mdct_mel_density = np.asarray(mel_density(mdct_hz), np.float32)
        self._mclt_window = cfg.mdct_window_func

    @staticmethod
    def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=like.device)

    def high_pass(self, raw: torch.Tensor) -> torch.Tensor:
        """A linear ramp from ``ms_freq_min`` (0) to the lowest mel filter's
        frequency (1) on the rfft of the half-length reflect-padded signal."""
        cfg = self.config
        cutoff = cfg.ms_freq_min
        if cutoff <= 0 or (self.ms_lowest_filter_freq - cutoff) <= 0:
            return raw
        t = raw.shape[-1]
        xp = _reflect_half(raw.float())
        rfft = torch.fft.rfft(xp, norm="ortho")
        freqs = np.fft.rfftfreq(xp.shape[-1], d=1.0 / cfg.sample_rate)
        filt = np.clip((freqs - cutoff) / (self.ms_lowest_filter_freq - cutoff), 0.0, 1.0)
        out = torch.fft.irfft(rfft * self._const(filt, rfft), n=xp.shape[-1], norm="ortho")
        return out[..., t // 2: -(t // 2)]

    # ---- shape math (reference :215-245) -----------------------------------
    def _get_num_ms_frames(self, raw_len: int) -> int:
        cfg = self.config
        return 1 + (raw_len + cfg.ms_frame_padded_length - cfg.ms_win_length) \
            // cfg.ms_frame_hop_length

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        cfg = self.config
        raw_length = raw_length or cfg.default_raw_length
        n = self._get_num_ms_frames(raw_length)
        n = n // cfg.ms_width_alignment * cfg.ms_width_alignment
        return (n - 1) * cfg.ms_frame_hop_length + cfg.ms_win_length - cfg.ms_frame_padded_length

    def get_mel_spec_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        w = self.get_raw_crop_width(raw_length)
        return (bsz, self.config.ms_num_frequencies, self._get_num_ms_frames(w),
                self.config.num_raw_channels)

    def get_mdct_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        cfg = self.config
        w = self.get_raw_crop_width(raw_length)
        n = cfg.mdct_num_frequencies
        c = cfg.num_raw_channels * (2 if cfg.mdct_dual_channel else 1)
        return (bsz, n, w // n + 1, c)

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        return self.get_mel_spec_shape(bsz, raw_length)

    # ---- mel path ----------------------------------------------------------
    def raw_to_mel_spec(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, F, T', C)."""
        cfg = self.config
        raw = self.high_pass(raw).float()

        def mag(win):
            return stft(raw, win, cfg.ms_frame_padded_length, cfg.ms_frame_hop_length).abs()

        spec = mag(self.win_low)                                   # (B, C, frames, bins)
        if self.win_high is not None:
            blend = self._const(self.spec_blend_weight, spec)
            spec = spec * blend + mag(self.win_high) * (1.0 - blend)
        spec = spec / self._const(self.ms_stft_mel_density, spec)
        mel = torch.matmul(spec, self._const(self.ms_freq_scale.filters, spec))
        mel = mel ** cfg.ms_abs_exponent * cfg.raw_to_mel_spec_scale + cfg.raw_to_mel_spec_offset
        return mel.permute(0, 3, 2, 1)

    raw_to_sample = raw_to_mel_spec

    def mel_spec_to_mdct_psd(self, mel_spec: torch.Tensor) -> torch.Tensor:
        """(B, F, T', C) -> (B, psd_bins, T', C) linear PSD conditioning; the
        mel's scale stays folded into ``mel_spec_to_mdct_psd_scale``, as in
        the reference (:259-270)."""
        cfg = self.config
        ms = (mel_spec.float() - cfg.raw_to_mel_spec_offset).clamp_min(0.0) \
            ** (1.0 / cfg.ms_abs_exponent)
        lin = torch.einsum("bftc,nf->bntc", ms, self._const(self._psd_pinv, ms))
        if self._psd_crop_last:
            lin = lin[:, :-1]
        return lin * cfg.mel_spec_to_mdct_psd_scale + cfg.mel_spec_to_mdct_psd_offset

    # ---- mdct path ---------------------------------------------------------
    def _mclt(self, raw: torch.Tensor, theta: Optional[torch.Tensor]):
        re, im = mclt(self.high_pass(raw).float(), self.config.mdct_window_len,
                      window_fn=self._mclt_window)               # (B, C, frames, N)
        if theta is not None:
            c = torch.cos(theta)[:, None, None, None]
            s = torch.sin(theta)[:, None, None, None]
            re, im = re * c - im * s, re * s + im * c
        return re, im

    def raw_to_mdct(self, raw: torch.Tensor, theta: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """(B, C, T) -> (B, N, frames, C or 2C); ``theta`` (B,) rotates each
        sample's phases first (the JAX ``random_phase_augmentation``)."""
        cfg = self.config
        re, im = self._mclt(raw, theta)
        out = torch.cat([re, im], dim=1) if cfg.mdct_dual_channel else re
        out = out.permute(0, 3, 2, 1)
        return out / self._const(self.mdct_mel_density, out).reshape(1, -1, 1, 1) \
            * cfg.raw_to_mdct_scale

    def raw_to_mdct_psd(self, raw: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        re, im = self._mclt(raw, None)
        out = torch.sqrt(re * re + im * im).permute(0, 3, 2, 1)
        return out / self._const(self.mdct_mel_density, out).reshape(1, -1, 1, 1) \
            * cfg.raw_to_mdct_scale / np.sqrt(2.0)

    def mdct_to_raw(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(B, N, frames, C or 2C) -> (B, C, T)."""
        cfg = self.config
        x = coeffs.float() * self._const(self.mdct_mel_density, coeffs).reshape(1, -1, 1, 1) \
            / cfg.raw_to_mdct_scale
        x = x.permute(0, 3, 2, 1)                                  # (B, C', frames, N)
        if cfg.mdct_dual_channel:
            c = x.shape[1] // 2
            re, im = x[:, :c], x[:, c:]
        else:
            re, im = x, torch.zeros_like(x)
        return imclt(re, im, cfg.mdct_window_len, window_fn=self._mclt_window) \
            * cfg.mdct_to_raw_scale

    sample_to_raw = mdct_to_raw
