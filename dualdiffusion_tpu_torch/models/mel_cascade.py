# Transition matrices copied from dualdiffusion_tpu/models/mel_cascade.py; products on torch.
"""MelCascade: a multi-stage linear-to-mel frequency resampling cascade
(JAX: dualdiffusion_tpu/models/mel_cascade.py; reference:
src/modules/mel_cascade.py:30-235). Each stage maps an n-bin grid (spaced
between linear and mel by alpha) to an n/2-bin grid through a triangular
transition matrix; the inverse takes its pseudoinverse. The matrices are
host constants built once in float64, so the cascade is a chain of fp32
matrix products.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.mel import hz_to_mel, mel_to_hz


def get_frequency_grid(n_bins: int, alpha: float, sample_rate: float = 32000.0) -> np.ndarray:
    """Centre frequencies between linear (alpha = 0) and mel (alpha = 1)."""
    f_min, f_max = 0.0, sample_rate / 2.0
    lin = np.linspace(f_min, f_max, n_bins)
    mel = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_bins))
    return (1.0 - alpha) * lin + alpha * mel


def build_transition_matrix(source_freqs: np.ndarray, target_freqs: np.ndarray) -> np.ndarray:
    """(n_in, n_out): column j is a triangular filter centred at target j,
    evaluated on the source grid and normalized so a flat input stays flat."""
    n_in, n_out = len(source_freqs), len(target_freqs)
    w = np.zeros((n_in, n_out), np.float64)
    c = np.asarray(target_freqs, np.float64)
    pad = np.concatenate([[c[0] - (c[1] - c[0])], c, [c[-1] + (c[-1] - c[-2])]])
    s = np.asarray(source_freqs, np.float64)
    for j in range(n_out):
        left, center, right = pad[j], pad[j + 1], pad[j + 2]
        up = (s >= left) & (s <= center)
        w[up, j] = (s[up] - left) / (center - left + 1e-8)
        down = (s > center) & (s <= right)
        w[down, j] = (right - s[down]) / (right - center + 1e-8)
    return w / np.maximum(w.sum(axis=0, keepdims=True), 1e-8)


class ResampleStage:
    def __init__(self, n_in: int, n_out: int, alpha_in: float, alpha_out: float,
                 sample_rate: float) -> None:
        src = get_frequency_grid(n_in, alpha_in, sample_rate)
        dst = get_frequency_grid(n_out, alpha_out, sample_rate)
        self.forward_mat = build_transition_matrix(src, dst).astype(np.float32)
        self.inverse_mat = np.linalg.pinv(self.forward_mat.astype(np.float64),
                                          rcond=1e-8).astype(np.float32)

    @staticmethod
    def _apply(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
        return torch.matmul(x.float(), torch.as_tensor(m, device=x.device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n_in) -> (..., n_out)."""
        return self._apply(x, self.forward_mat)

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(x, self.inverse_mat)


class MelCascade:
    """(B, C, n_bins, W) <-> (B, C, n_bins / 2^stages, W)."""

    def __init__(self, sample_rate: float = 32000.0, num_bins: int = 256,
                 num_stages: int = 3) -> None:
        self.stages: List[ResampleStage] = []
        for i in range(num_stages):
            n_in = num_bins // (2 ** i)
            self.stages.append(ResampleStage(n_in, n_in // 2, i / num_stages,
                                             (i + 1) / num_stages, sample_rate))

    def __call__(self, x: torch.Tensor, stage: int = -1) -> torch.Tensor:
        y = x.transpose(-1, -2)          # bins last
        for st in (self.stages if stage == -1 else [self.stages[stage]]):
            y = st(y)
        return y.transpose(-1, -2)

    def inverse_transform(self, x: torch.Tensor, stage: int = -1) -> torch.Tensor:
        y = x.transpose(-1, -2)
        for st in (reversed(self.stages) if stage == -1 else [self.stages[stage]]):
            y = st.inverse_transform(y)
        return y.transpose(-1, -2)
