# MDCT bases copied from dualdiffusion_tpu/ops/mdct.py; framing and products on torch.
"""MDCT / IMDCT as matrix products against bases built once in float64
(reference: src/utils/mdct/functional.py:52-211). Every step of the lapped
MDCT (window, pre-twiddle, FFT, post-twiddle) is a fixed linear map, so one
frame of length L maps to N = L/2 coefficients through one (L, N) product.
``torch.matmul`` runs it in fp32, as the JAX package leaves it to XLA.

Layout: ``mdct`` returns (..., N, frames), freq-major, as the JAX package.
The MCLT is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stft import frame_signal, overlap_add
from .windows import get_window


@functools.lru_cache(maxsize=16)
def _mdct_bases(window_fn: str, win_length: int):
    """Forward/backward MDCT bases with all scaling folded in.

    forward:  spec[k]  = sum_n frame[n] * Bf[n, k]   (+ i * Bf_im for MCLT)
    backward: frame[n] = sum_k spec[k]  * Bi[k, n]
    """
    window = get_window(window_fn, win_length)
    L = win_length
    N = L // 2
    n = np.arange(L, dtype=np.float64)
    k = np.arange(N, dtype=np.float64)
    scaling = 1.0 / np.sqrt(L * N)
    pre = np.exp(-1j * np.pi / L * n)
    post = np.exp(-1j * np.pi / L * (L / 2 + 1) * (k + 0.5))
    dft = np.exp(-2j * np.pi * np.outer(n, k) / L)
    bf = (window[:, None] * pre[:, None] * dft) * post[None, :] * scaling
    pre2 = np.exp(-1j * np.pi / (2 * N) * (N + 1) * k)
    n_out = np.arange(0.5 + N / 2, 2 * N + N / 2 + 0.5, dtype=np.float64)
    post2 = np.exp(-1j * np.pi / (2 * N) * n_out) / N
    dft2 = np.exp(-2j * np.pi * np.outer(k, np.arange(L)) / L)
    bi = np.real(pre2[:, None] * dft2 * post2[None, :]) * 2.0 * window[None, :] / scaling
    return (bf.real.astype(np.float32), bf.imag.astype(np.float32), bi.astype(np.float32))


def _basis(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def mdct(x: torch.Tensor, win_length: int, window_fn: str = "sin_mdct",
         return_complex: bool = False):
    """MDCT of (..., T) -> (..., N, frames), N = win_length // 2.

    ``return_complex=True`` returns the complex MCLT coefficients as a
    (real, imag) pair. Framing matches the reference: reflect pad by hop,
    frames = ceil(T / hop) + 1 after the trailing frame is dropped."""
    bf_r, bf_i, _ = _mdct_bases(window_fn, win_length)
    hop = win_length // 2
    t = x.shape[-1]
    n_frames = -(-t // hop) + 1
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, t), (hop, (n_frames + 1) * hop - t), mode="reflect")
    frames = frame_signal(x.reshape(lead + (x.shape[-1],)), win_length, hop)[..., :-1, :]
    xr = frames.float()
    re = torch.matmul(xr, _basis(bf_r, xr)).transpose(-1, -2)
    if not return_complex:
        return re
    im = torch.matmul(xr, _basis(bf_i, xr)).transpose(-1, -2)
    return re, im


def imdct(spec: torch.Tensor, win_length: int, window_fn: str = "sin_mdct") -> torch.Tensor:
    """Inverse MDCT of (..., N, frames) -> (..., T), T = hop * (frames - 1)."""
    _, _, bi = _mdct_bases(window_fn, win_length)
    hop = win_length // 2
    y = spec.transpose(-1, -2).float()
    sig = overlap_add(torch.matmul(y, _basis(bi, y)), hop)
    return sig[..., hop: sig.shape[-1] - hop]
