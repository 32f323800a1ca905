# Config and constants copied from dualdiffusion_tpu/models/formats/ms_mdct_dual.py; transforms on torch.
"""MS+MDCT dual format: a multi-window blended mel spectrogram for the DAE
and latent UNet, and MDCT coefficients for the diffusion decoder
(JAX: dualdiffusion_tpu/models/formats/ms_mdct_dual.py:36-291; reference:
src/modules/formats/ms_mdct_dual_2.py:35-381).

* mel: N hann**e windows (e = 9/32/112), each RMS-normalized and STFT'd
  (normalized, 4096 points, hop 256); magnitudes over the stft-bin mel
  density, through an RMS-normalized slaney mel filterbank, blended per
  filter with gaussian weights on log(ideal width / window width);
  blended**0.25, affine-normalized.
* ``mel_spec_to_linear``: the pinv of the raw slaney bank, times
  sqrt(mel density), last bin dropped; ``sample_to_raw_fgla`` inverts it to
  magnitudes and runs Griffin-Lim (the decode of a pipeline without DDEC).
* MDCT: 512-sample window, mel-density normalized, with an optional phase
  rotation of the complex MCLT coefficients, and its phase/psd split. The
  JAX package draws the rotation angles inside; here the caller passes
  them (``theta``, one angle per sample) so a test can replay JAX's draws.
* The DDEC decodes the MDCT grid conditioned on ``mel_spec_to_linear``;
  the mel and the MDCT share one hop, so the two grids align frame for
  frame (``get_mdct_shape_for_mel_frames``).

Layouts: mel (B, F=256, T', C); MDCT (B, N=256, frames, C); raw (B, C, T).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops.fgla import griffinlim
from ...ops.mdct import imdct, mdct
from ...ops.mel import FrequencyScale, mel_density
from ...ops.stft import stft
from ...ops.windows import get_window
from ...utils.trace import span
from .format import Format, FormatConfig, register_format


@dataclass
class MSMDCTDualFormatConfig(FormatConfig):
    """Field names and defaults of the JAX MSMDCTDualFormatConfig."""
    raw_to_mdct_scale: float = 0.00395184212251821011433253029603
    mdct_psd_scale: float = 0.07179056842448940381561506832112
    mdct_psd_offset: float = -0.1806843343919556
    mdct_psd_exponent: float = 0.25
    mdct_phase_scale: float = 1.0
    mdct_window_len: int = 512
    mdct_window_func: str = "sin"  # sin | kaiser_bessel_derived | vorbis

    raw_to_mel_spec_scale: float = 0.48693139085749312574067728443989
    raw_to_mel_spec_offset: float = -1.530891040808645
    mel_spec_to_linear_scale: float = 15.11100987193986714324861053997
    mel_spec_to_linear_offset: float = 0.0
    ms_abs_exponent: float = 0.25
    ms_freq_min: float = 0.0
    ms_freq_max_override: Optional[float] = None
    ms_num_filters: int = 256
    ms_ideal_num_filter_bins: float = 3.0
    ms_window_length: int = 4096
    ms_blend_sharpness: float = 30.0
    ms_window_exponents: Tuple[float, ...] = (9.0, 32.0, 112.0)

    @property
    def mdct_num_frequencies(self) -> int:
        return self.mdct_window_len // 2

    @property
    def mdct_frame_hop_length(self) -> int:
        return self.mdct_window_len // 2

    @property
    def ms_num_stft_bins(self) -> int:
        return self.ms_window_length // 2 + 1

    @property
    def ms_hop_length(self) -> int:
        return self.mdct_frame_hop_length

    @property
    def ms_width_alignment(self) -> int:
        return self.mdct_frame_hop_length // 2

    @property
    def ms_freq_max(self) -> float:
        return self.ms_freq_max_override or self.sample_rate / 2


_MDCT_WINDOW_MAP = {"sin": "sin_mdct", "kaiser_bessel_derived": "kbd_mdct",
                    "vorbis": "vorbis"}


@register_format("ms_mdct_dual")
class MSMDCTDualFormat(Format):
    config_class = MSMDCTDualFormatConfig

    def __init__(self, config: MSMDCTDualFormatConfig) -> None:
        super().__init__(config)
        cfg = config
        hann = get_window("hann", cfg.ms_window_length, periodic=True)
        windows = np.stack([hann ** e for e in cfg.ms_window_exponents])
        self.ms_windows = windows / np.sqrt((windows ** 2).mean(axis=1, keepdims=True))

        self.ms_freq_scale = FrequencyScale(
            freq_scale="mel", freq_min=cfg.ms_freq_min, freq_max=cfg.ms_freq_max,
            sample_rate=cfg.sample_rate, num_stft_bins=cfg.ms_num_stft_bins,
            num_filters=cfg.ms_num_filters, filter_norm="slaney", filter_shape="triangular")
        mel_freqs = self.ms_freq_scale.get_unscaled(cfg.ms_num_filters + 2)
        bandwidths = mel_freqs[2:] - mel_freqs[:-2]
        num_filter_bins = bandwidths / cfg.sample_rate * cfg.ms_num_stft_bins * 2
        ideal_widths = cfg.ms_ideal_num_filter_bins / num_filter_bins * cfg.ms_window_length

        # filters RMS-normalized per filter; empty filters stay zero
        raw_filters = self.ms_freq_scale.filters.astype(np.float64)
        rms = np.sqrt((raw_filters ** 2).mean(axis=0, keepdims=True))
        self.ms_filters = (raw_filters / np.maximum(rms, 1e-12)).astype(np.float32)
        # mel_spec_to_linear inverts through the RAW slaney bank
        self._filters_pinv = np.linalg.pinv(raw_filters.T, rcond=1e-10).astype(np.float32)

        window_widths = np.array([2 * np.arccos(2.0 ** (-1.0 / e)) / np.pi * 2
                                  * cfg.ms_window_length for e in cfg.ms_window_exponents])
        weights = np.zeros((cfg.ms_num_filters, len(cfg.ms_window_exponents)))
        for i in range(cfg.ms_num_filters):
            w = np.exp(-cfg.ms_blend_sharpness * np.log(ideal_widths[i] / window_widths) ** 2)
            weights[i] = w / w.sum()
        self.ms_filter_window_weights = weights.astype(np.float32)

        stft_hz = np.linspace(0, cfg.sample_rate / 2, cfg.ms_num_stft_bins)
        self.ms_stft_mel_density = np.asarray(mel_density(stft_hz), np.float32)
        mdct_hz = ((np.arange(cfg.mdct_num_frequencies) + 0.5) * cfg.sample_rate
                   / cfg.mdct_window_len)
        self.mdct_mel_density = np.asarray(mel_density(mdct_hz), np.float32)
        self.mdct_window_fn = _MDCT_WINDOW_MAP[cfg.mdct_window_func]

    @staticmethod
    def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=like.device)

    # ---- shape math ----------------------------------------------------------
    def _get_num_mel_frames(self, raw_len: int) -> int:
        return 1 + raw_len // self.config.ms_hop_length

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        cfg = self.config
        raw_length = raw_length or cfg.default_raw_length
        n = self._get_num_mel_frames(raw_length)
        n = n // cfg.ms_width_alignment * cfg.ms_width_alignment
        return (n - 1) * cfg.ms_hop_length

    def get_mel_spec_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        w = self.get_raw_crop_width(raw_length)
        return (bsz, self.config.ms_num_filters, self._get_num_mel_frames(w),
                self.config.num_raw_channels)

    def get_mdct_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        w = self.get_raw_crop_width(raw_length)
        n_bins = self.config.mdct_num_frequencies
        return (bsz, n_bins, w // n_bins + 1, self.config.num_raw_channels)

    def get_mdct_shape_for_mel_frames(self, bsz: int, n_mel_frames: int) -> Tuple[int, ...]:
        """The MDCT sample shape aligned 1:1 with a mel of ``n_mel_frames``
        frames: the two hops are the same samples by construction."""
        cfg = self.config
        if cfg.ms_hop_length != cfg.mdct_frame_hop_length:
            raise ValueError("mel and MDCT hops must match for DDEC conditioning alignment")
        return (bsz, cfg.mdct_num_frequencies, n_mel_frames, cfg.num_raw_channels)

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        return self.get_mel_spec_shape(bsz, raw_length)

    # ---- mel path --------------------------------------------------------------
    def raw_to_mel_spec(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, F=256, T', C) blended, normalized mel spec."""
        cfg = self.config
        raw = raw.float()
        dens = self._const(self.ms_stft_mel_density, raw)
        filters = self._const(self.ms_filters, raw)
        blended = None
        for i in range(len(cfg.ms_window_exponents)):
            spec = stft(raw, self.ms_windows[i], cfg.ms_window_length, cfg.ms_hop_length,
                        normalized=True)
            mel = torch.matmul(spec.abs() / dens, filters)
            mel = mel * self._const(self.ms_filter_window_weights[:, i], raw)
            blended = mel if blended is None else blended + mel
        mel = blended ** cfg.ms_abs_exponent
        mel = (mel + cfg.raw_to_mel_spec_offset) / cfg.raw_to_mel_spec_scale
        return mel.permute(0, 3, 2, 1)

    raw_to_sample = raw_to_mel_spec

    def mel_spec_to_linear(self, mel_spec: torch.Tensor) -> torch.Tensor:
        """(B, F, T', C) -> (B, bins - 1, T', C) linear PSD conditioning."""
        with span("dd.pipeline.mel_to_linear"):
            cfg = self.config
            ms = mel_spec * cfg.raw_to_mel_spec_scale - cfg.raw_to_mel_spec_offset
            ms = ms.clamp_min(0.0) ** (1.0 / cfg.ms_abs_exponent)
            lin = torch.einsum("bftc,nf->bntc", ms, self._const(self._filters_pinv, ms))
            lin = lin * self._const(np.sqrt(self.ms_stft_mel_density), ms)[None, :, None, None]
            lin = lin[:, :-1]
            return (lin + cfg.mel_spec_to_linear_offset) / cfg.mel_spec_to_linear_scale

    def sample_to_raw_fgla(self, mel_spec: torch.Tensor, n_fgla_iters: int = 200,
                           phase_init: Optional[str] = None) -> torch.Tensor:
        """(B, F, T', C) -> (B, C, T): the FGLA fallback decode for a pipeline
        without a DDEC. mel -> linear PSD, unscaled and clamped at 0, the
        dropped last bin restored, then Griffin-Lim on the ``ms_window_length``
        STFT grid with a periodic Hann window. JAX's ``key`` feeds only its
        random phase init, which this decode never takes."""
        with span("dd.pipeline.fgla"):
            cfg = self.config
            lin = self.mel_spec_to_linear(mel_spec)
            lin = (lin * cfg.mel_spec_to_linear_scale
                   - cfg.mel_spec_to_linear_offset).clamp_min(0.0)
            lin = torch.nn.functional.pad(lin, (0, 0, 0, 0, 0, 1))     # the last stft bin
            mag = lin.permute(0, 3, 2, 1)                                # (B, C, frames, bins)
            win = get_window("hann", cfg.ms_window_length, periodic=True)
            return griffinlim(mag, win, cfg.ms_window_length, cfg.ms_hop_length,
                              n_iter=n_fgla_iters, stereo=cfg.num_raw_channels == 2,
                              phase_init=phase_init or "flat")

    # ---- mdct path -------------------------------------------------------------
    def _mclt(self, raw: torch.Tensor, theta: Optional[torch.Tensor]):
        """(re, im) of the MCLT, (B, C, N, frames); ``theta`` (B,) rotates
        each sample's phases (the JAX ``random_phase_augmentation``, with
        the angles drawn by the caller)."""
        re, im = mdct(raw.float(), self.config.mdct_window_len, window_fn=self.mdct_window_fn,
                      return_complex=True)
        if theta is not None:
            c = torch.cos(theta)[:, None, None, None]
            s = torch.sin(theta)[:, None, None, None]
            re, im = re * c - im * s, re * s + im * c
        return re, im

    def raw_to_mdct(self, raw: torch.Tensor,
                    theta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, T) -> (B, N, frames, C) normalized MDCT coefficients,
        rotated by ``theta`` first when given."""
        re, _ = self._mclt(raw, theta)
        out = re / self._const(self.mdct_mel_density, re)[:, None] / self.config.raw_to_mdct_scale
        return out.permute(0, 2, 3, 1)

    def mdct_to_raw(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(B, N, frames, C) -> (B, C, T)."""
        with span("dd.pipeline.imdct"):
            cfg = self.config
            x = coeffs.permute(0, 3, 1, 2)
            x = x * self._const(self.mdct_mel_density, x)[:, None] * cfg.raw_to_mdct_scale
            return imdct(x, cfg.mdct_window_len, window_fn=self.mdct_window_fn)

    sample_to_raw = mdct_to_raw

    def normalize_psd(self, psd: torch.Tensor) -> torch.Tensor:
        return (psd + self.config.mdct_psd_offset) / self.config.mdct_psd_scale

    def unnormalize_psd(self, psd: torch.Tensor) -> torch.Tensor:
        return psd * self.config.mdct_psd_scale - self.config.mdct_psd_offset

    def raw_to_mdct_phase_psd(self, raw: torch.Tensor, theta: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C, T) -> (phase, psd), each (B, N, frames, C): the MCLT's
        real part over its magnitude (times sqrt 2) and its mel-density
        normalized magnitude ** ``mdct_psd_exponent``, rotated by ``theta``
        first when given."""
        cfg = self.config
        re, im = self._mclt(raw, theta)
        psd = torch.sqrt(re * re + im * im)
        phase = (re / psd.clamp_min(1e-20)).clamp(-1.0, 1.0) * 2.0 ** 0.5
        psd = (psd / self._const(self.mdct_mel_density, re)[:, None]) ** cfg.mdct_psd_exponent
        phase = phase.permute(0, 2, 3, 1) / cfg.mdct_phase_scale
        return phase, self.normalize_psd(psd.permute(0, 2, 3, 1))
