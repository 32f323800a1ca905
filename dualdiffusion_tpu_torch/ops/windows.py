# Copied from dualdiffusion_tpu/ops/windows.py, with numpy's i0 in place of scipy's.
"""Window function zoo.

Windows are static buffers: they are constructed host-side in float64 numpy at
setup/trace time and enter jitted computations as constants. Semantics match
the reference's two window zoos (reference: src/utils/mclt.py:28-85 — hann,
sin, kaiser, kaiser_bessel_derived, hann_poisson, blackman_harris, flat_top
— and src/utils/mdct/windows.py — MDCT sin/kbd/vorbis) plus the
hann-power STFT window (reference: src/modules/formats/old/spectrogram.py:96-103).

Note the two distinct KBD constructions in the reference (beta~4, squared
symmetric kaiser vs beta~12, periodic kaiser, unsquared cumsum): both are
provided as ``kaiser_bessel_derived`` (mclt zoo) and ``kbd_mdct`` (mdct zoo).
"""

from __future__ import annotations

import numpy as np
_i0 = np.i0


def hann(window_len: int, periodic: bool = True) -> np.ndarray:
    denom = window_len if periodic else window_len - 1
    n = np.arange(window_len, dtype=np.float64) / denom
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n)


def hann_power(window_len: int, exponent: float = 1.0, periodic: bool = True) -> np.ndarray:
    """hann ** exponent — the tuned STFT windows (exponents 9/32/112 etc.)."""
    if exponent == 0:
        return np.ones(window_len, dtype=np.float64)
    return hann(window_len, periodic=periodic) ** exponent


def sin_window(window_len: int) -> np.ndarray:
    """MDCT sine window: sin(pi*(n+0.5)/N) (Princen-Bradley compliant)."""
    n = np.arange(window_len, dtype=np.float64) + 0.5
    return np.sin(np.pi * n / window_len)


def sqrt_hann(window_len: int) -> np.ndarray:
    """hann**0.5 — the 'sin' entry of the mclt window zoo (periodic hann)."""
    return np.sqrt(hann(window_len, periodic=True))


def vorbis(window_len: int) -> np.ndarray:
    n = np.arange(window_len, dtype=np.float64) + 0.5
    return np.sin(np.pi / 2.0 * np.sin(np.pi * n / window_len) ** 2)


def _kaiser(window_len: int, beta: float, periodic: bool) -> np.ndarray:
    n = window_len + 1 if periodic else window_len
    if n == 1:
        w = np.ones(1)
    else:
        k = np.arange(n, dtype=np.float64)
        arg = beta * np.sqrt(np.maximum(1.0 - (2.0 * k / (n - 1) - 1.0) ** 2, 0.0))
        w = _i0(arg) / _i0(np.float64(beta))
    return w[:window_len] if periodic else w


def kaiser(window_len: int, beta: float = 4.0 * np.pi, periodic: bool = False) -> np.ndarray:
    return _kaiser(window_len, beta, periodic)


def kaiser_bessel_derived(window_len: int, beta: float = 4.0) -> np.ndarray:
    """KBD from the mclt zoo: cumsum of squared symmetric kaiser halves
    (reference: src/utils/mclt.py:44-62)."""
    if window_len % 2 != 0:
        raise ValueError("KBD window length must be even")
    kw = _kaiser(window_len // 2 + 1, beta, periodic=False)
    csum = np.cumsum(kw[:-1] ** 2)
    half = np.sqrt(csum / csum[-1])
    return np.concatenate([half, half[::-1]])


def kbd_mdct(window_len: int, beta: float = 12.0) -> np.ndarray:
    """KBD from the mdct zoo: cumsum of (unsquared) periodic kaiser
    (reference: src/utils/mdct/windows.py:28-63)."""
    kw = _kaiser(window_len // 2 + 1, beta, periodic=True)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([half, half[::-1]])


def hann_poisson(window_len: int, alpha: float = 2.0) -> np.ndarray:
    x = np.arange(window_len, dtype=np.float64) / window_len
    return np.exp(-alpha * np.abs(1.0 - 2.0 * x)) * 0.5 * (1.0 - np.cos(2.0 * np.pi * x))


def blackman_harris(window_len: int) -> np.ndarray:
    x = np.arange(window_len, dtype=np.float64) / window_len * 2.0 * np.pi
    return (0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x)
            - 0.01168 * np.cos(3 * x))


def flat_top(window_len: int) -> np.ndarray:
    x = np.arange(window_len, dtype=np.float64) / window_len * 2.0 * np.pi
    return (0.21557895 - 0.41663158 * np.cos(x) + 0.277263158 * np.cos(2 * x)
            - 0.083578947 * np.cos(3 * x) + 0.006947368 * np.cos(4 * x))


_WINDOW_FNS = {
    "hann": hann,
    "hann_power": hann_power,
    "sin": sqrt_hann,            # mclt zoo naming: "sin" == hann**0.5
    "sin_mdct": sin_window,      # mdct zoo sine window
    "vorbis": vorbis,
    "kaiser": kaiser,
    "kaiser_bessel_derived": kaiser_bessel_derived,
    "kbd_mdct": kbd_mdct,
    "hann_poisson": hann_poisson,
    "blackman_harris": blackman_harris,
    "flat_top": flat_top,
}


def get_window(name: str, window_len: int, **kwargs) -> np.ndarray:
    """Window by name, float64 numpy (host-side constant)."""
    try:
        fn = _WINDOW_FNS[name]
    except KeyError:
        raise ValueError(f"unknown window '{name}'; known: {sorted(_WINDOW_FNS)}") from None
    return fn(window_len, **kwargs)
