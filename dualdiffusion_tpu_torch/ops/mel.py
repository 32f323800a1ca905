# Filterbank construction and mel_density copied from dualdiffusion_tpu/ops/mel.py; scale/unscale on torch.
"""Mel / log frequency-scale filterbanks with matmul scale and
precomputed-pseudoinverse unscale (reference: src/modules/formats/
frequency_scale.py:85-169). The filterbank and its Moore-Penrose
pseudoinverse are host numpy constants built once; ``unscale`` is then one
fp32 matmul, numerically the min-norm lstsq solution.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch


def hz_to_mel(freq):
    return 2595.0 * np.log10(1.0 + freq / 700.0)


def mel_to_hz(mels):
    return 700.0 * (10.0 ** (np.asarray(mels) / 2595.0) - 1.0)


def mel_density(hz):
    """d(mel)/d(hz) (reference: frequency_scale.py:36-37). Works on numpy and torch."""
    return 1127.0 / (700.0 + hz)


def _triangular_filterbank(all_freqs: np.ndarray, f_pts: np.ndarray) -> np.ndarray:
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]     # (n_freqs, n_filter+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


@dataclasses.dataclass(frozen=True)
class FrequencyScale:
    """Static filterbank container; all arrays are host numpy constants."""
    freq_scale: Literal["mel", "log"] = "mel"
    freq_min: float = 0.0
    freq_max: Optional[float] = None
    sample_rate: int = 32000
    num_stft_bins: int = 3201
    num_filters: int = 256
    filter_norm: Optional[str] = None
    filter_shape: Literal["triangular", "cos"] = "triangular"

    def __post_init__(self):
        object.__setattr__(self, "_filters", self._build_filters())
        object.__setattr__(self, "_pinv",
                           np.linalg.pinv(self._filters.T.astype(np.float64),
                                          rcond=1e-10).astype(np.float32))

    @property
    def fmax(self) -> float:
        return self.freq_max if self.freq_max is not None else self.sample_rate / 2

    def scale_fn(self, f):
        return hz_to_mel(f) if self.freq_scale == "mel" else np.log2(np.maximum(f, 1e-12))

    def unscale_fn(self, s):
        return mel_to_hz(s) if self.freq_scale == "mel" else np.exp2(s)

    def get_unscaled(self, num_points: int) -> np.ndarray:
        scaled = np.linspace(self.scale_fn(self.freq_min), self.scale_fn(self.fmax),
                             num_points)
        return self.unscale_fn(scaled)

    def _build_filters(self) -> np.ndarray:
        stft_freqs = np.linspace(0.0, self.sample_rate / 2, self.num_stft_bins)
        pts = self.get_unscaled(self.num_filters + 2)
        filters = _triangular_filterbank(stft_freqs, pts)
        if self.filter_shape == "cos":
            filters = np.sin(np.pi * filters / 2.0) ** 2
        elif self.filter_shape != "triangular":
            raise ValueError(f"invalid filter shape: {self.filter_shape}")
        if self.filter_norm == "slaney":
            enorm = 2.0 / (pts[2: self.num_filters + 2] - pts[: self.num_filters])
            filters = filters * enorm[None, :]
        return filters.astype(np.float32)

    @property
    def filters(self) -> np.ndarray:
        """(num_stft_bins, num_filters)."""
        return self._filters  # type: ignore[attr-defined]

    @property
    def filters_pinv(self) -> np.ndarray:
        """pinv(filters.T): (num_stft_bins, num_filters)."""
        return self._pinv  # type: ignore[attr-defined]

    def scale(self, spec: torch.Tensor) -> torch.Tensor:
        """(..., num_stft_bins, T) -> (..., num_filters, T), fp32."""
        f = torch.as_tensor(self.filters, device=spec.device)
        return torch.matmul(spec.transpose(-1, -2), f).transpose(-1, -2)

    def unscale(self, spec: torch.Tensor, rectify: bool = True) -> torch.Tensor:
        """(..., num_filters, T) -> (..., num_stft_bins, T), fp32."""
        p = torch.as_tensor(self.filters_pinv, device=spec.device)
        out = torch.matmul(p, spec)
        return out.clamp_min(0.0) if rectify else out
