# Copied from dualdiffusion_tpu/utils/roseus.py.
"""Spectrogram colormap LUT (256 x 3, float in [0,1]).

Role parity with the reference's roseus colormap
(reference: src/utils/roseus_colormap.py) — a perceptually-uniform
dark-to-bright map used for spectrogram/latent previews. Rather than
shipping a hard-coded table we derive the LUT from matplotlib's "magma"
(perceptually uniform, similar hue ramp); if matplotlib is unavailable we
fall back to a procedurally generated cubehelix ramp.
"""

from __future__ import annotations

import numpy as np


def _cubehelix(n: int = 256, start: float = 0.5, rotations: float = -1.5,
               hue: float = 1.2, gamma: float = 1.0) -> np.ndarray:
    lam = np.linspace(0.0, 1.0, n) ** gamma
    phi = 2.0 * np.pi * (start / 3.0 + rotations * lam)
    amp = hue * lam * (1.0 - lam) / 2.0
    cos_p, sin_p = np.cos(phi), np.sin(phi)
    r = lam + amp * (-0.14861 * cos_p + 1.78277 * sin_p)
    g = lam + amp * (-0.29227 * cos_p - 0.90649 * sin_p)
    b = lam + amp * (1.97294 * cos_p)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


def _build_lut() -> np.ndarray:
    try:
        import matplotlib
        cmap = matplotlib.colormaps["magma"]
        return np.asarray(cmap(np.linspace(0, 1, 256)))[:, :3].astype(np.float32)
    except Exception:
        return _cubehelix(256)


ROSEUS_LUT: np.ndarray = _build_lut()
