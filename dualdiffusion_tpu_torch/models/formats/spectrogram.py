"""Mel-spectrogram format with FGLA phase reconstruction
(JAX: dualdiffusion_tpu/models/formats/spectrogram.py; reference:
src/modules/formats/old/spectrogram.py:33-275): hann**32 window (200 ms
window, 8 ms hop), 256 mel bins 20 Hz - 16 kHz, abs**0.25 compression;
inverse via pseudoinverse mel unscale + momentum FGLA with stereo-coherent
annealing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops import FrequencyScale, get_window, griffinlim, stft
from ...utils.trace import span
from .format import Format, FormatConfig, register_format


@dataclass
class SpectrogramFormatConfig(FormatConfig):
    """Field names and defaults of the JAX SpectrogramFormatConfig."""
    raw_to_sample_scale: float = 2.247
    sample_to_raw_scale: float = 0.445
    sample_mean: float = 1.295
    abs_exponent: float = 0.25

    step_size_ms: int = 8
    window_duration_ms: int = 200
    padded_duration_ms: int = 200
    window_exponent: float = 32.0
    window_periodic: bool = True

    freq_scale_type: str = "mel"
    num_frequencies: int = 256
    min_frequency: int = 20
    max_frequency: int = 16000
    freq_scale_norm: Optional[str] = None

    num_fgla_iters: int = 200
    fgla_momentum: float = 0.99
    stereo_coherence: float = 0.67
    fgla_work_dtype: str = "float32"
    fgla_phase_init: str = "flat"

    @property
    def stereo(self) -> bool:
        return self.num_raw_channels == 2

    @property
    def padded_length(self) -> int:
        return int(self.padded_duration_ms / 1000.0 * self.sample_rate)

    @property
    def win_length(self) -> int:
        return int(self.window_duration_ms / 1000.0 * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.step_size_ms / 1000.0 * self.sample_rate)

    @property
    def num_stft_bins(self) -> int:
        return self.padded_length // 2 + 1


@register_format("spectrogram")
class SpectrogramFormat(Format):
    config_class = SpectrogramFormatConfig

    def __init__(self, config: SpectrogramFormatConfig) -> None:
        super().__init__(config)
        self.window = get_window("hann_power", config.win_length,
                                 exponent=config.window_exponent,
                                 periodic=config.window_periodic)
        self.freq_scale = FrequencyScale(
            freq_scale=config.freq_scale_type, freq_min=config.min_frequency,
            freq_max=config.max_frequency, sample_rate=config.sample_rate,
            num_stft_bins=config.num_stft_bins, num_filters=config.num_frequencies,
            filter_norm=config.freq_scale_norm)

    def get_num_frames(self, audio_len: int) -> int:
        cfg = self.config
        return 1 + (audio_len + cfg.padded_length - cfg.win_length) // cfg.hop_length

    def get_audio_len(self, num_frames: int) -> int:
        cfg = self.config
        return (num_frames - 1) * cfg.hop_length + cfg.win_length - cfg.padded_length

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        raw_length = raw_length or self.config.default_raw_length
        num_frames = self.get_num_frames(raw_length)
        if num_frames >= 128:
            num_frames = num_frames // 128 * 128
        elif num_frames >= 1:
            num_frames = 1 << (num_frames.bit_length() - 1)
        else:
            raise ValueError(f"requested length {raw_length} is shorter than one "
                             f"spectrogram frame")
        return self.get_audio_len(num_frames)

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        raw_length = self.get_raw_crop_width(raw_length)
        return (bsz, self.config.num_frequencies, self.get_num_frames(raw_length),
                self.config.num_raw_channels)

    def raw_to_sample(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, C, T) audio -> (B, F, T', C) normalized mel spectrogram
        ((mel**0.25 - sample_mean) * raw_to_sample_scale)."""
        cfg = self.config
        return (self.raw_to_mel_spec(raw) - cfg.sample_mean) * cfg.raw_to_sample_scale

    def raw_to_mel_spec(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, C, T) audio -> (B, F, T', C) mel spectrogram ** abs_exponent
        (JAX spectrogram.py:144-152)."""
        cfg = self.config
        spec = stft(raw.float(), self.window, cfg.padded_length, cfg.hop_length)
        mel = self.freq_scale.scale(spec.abs().transpose(-1, -2))  # (B, C, F_mel, frames)
        return (mel ** cfg.abs_exponent).permute(0, 2, 3, 1)

    def get_ln_freqs(self) -> torch.Tensor:
        """The standardized ln of the mel filters' centre frequencies, (F,)
        fp32: the UNet's ln-freq channel (JAX spectrogram.py:193-200)."""
        freqs = self.freq_scale.get_unscaled(self.config.num_frequencies + 2)[1:-1]
        ln = np.log(freqs)
        return torch.as_tensor((ln - ln.mean()) / ln.std(), dtype=torch.float32)

    def sample_to_raw(self, sample: torch.Tensor, n_fgla_iters: Optional[int] = None,
                      phase_init: Optional[str] = None) -> torch.Tensor:
        """(B, F, T', C) -> (B, C, T) via mel unscale + FGLA."""
        with span("dd.pipeline.fgla"):
            cfg = self.config
            mel = sample.float() / cfg.raw_to_sample_scale + cfg.sample_mean
            mel = mel.permute(0, 3, 1, 2).clamp_min(0.0)                     # (B, C, F, T')
            mag_lin = self.freq_scale.unscale(mel ** (1.0 / cfg.abs_exponent))  # (B, C, bins, T')
            return griffinlim(mag_lin.transpose(-1, -2), self.window, cfg.padded_length,
                              cfg.hop_length, n_iter=n_fgla_iters or cfg.num_fgla_iters,
                              momentum=cfg.fgla_momentum, stereo=cfg.stereo,
                              stereo_coherence=cfg.stereo_coherence,
                              work_dtype=cfg.fgla_work_dtype,
                              phase_init=phase_init or cfg.fgla_phase_init)
