# MDCT and MCLT bases copied from dualdiffusion_tpu/ops/mdct.py; framing and products on torch.
"""MDCT / IMDCT and MCLT / IMCLT as matrix products against bases built once
in float64 (reference: src/utils/mdct/functional.py:52-211,
src/utils/mclt.py:87-130). Every step of the lapped MDCT (window,
pre-twiddle, FFT, post-twiddle) is a fixed linear map, so one frame of
length L maps to N = L/2 coefficients through one (L, N) product.
``torch.matmul`` runs it in fp32, as the JAX package leaves it to XLA.

Layout: ``mdct`` returns (..., N, frames), freq-major, and ``mclt``
(..., frames, N), as the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stft import frame_signal, overlap_add
from .windows import get_window


@functools.lru_cache(maxsize=16)
def _mdct_bases(window_key: Tuple, win_length: int):
    """Forward/backward MDCT bases with all scaling folded in.

    forward:  spec[k]  = sum_n frame[n] * Bf[n, k]   (+ i * Bf_im for MCLT)
    backward: frame[n] = sum_k spec[k]  * Bi[k, n]
    """
    name, kwargs = window_key
    window = get_window(name, win_length, **dict(kwargs))
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


def _win_key(window_fn: str, window_kwargs: Optional[dict]) -> Tuple:
    return (window_fn, tuple(sorted((window_kwargs or {}).items())))


def _basis(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    lead, t = x.shape[:-1], x.shape[-1]
    y = F.pad(x.reshape(-1, 1, t), (left, right), mode="reflect")
    return y.reshape(lead + (y.shape[-1],))


def mdct(x: torch.Tensor, win_length: int, window_fn: str = "sin_mdct",
         window_kwargs: Optional[dict] = None, padding: bool = True,
         return_complex: bool = False):
    """MDCT of (..., T) -> (..., N, frames), N = win_length // 2.

    ``return_complex=True`` returns the complex MCLT coefficients as a
    (real, imag) pair. Framing matches the reference: with ``padding``,
    reflect pad by hop, frames = ceil(T / hop) + 1 after the trailing frame
    is dropped; without, the frames of ``x`` as it is."""
    bf_r, bf_i, _ = _mdct_bases(_win_key(window_fn, window_kwargs), win_length)
    hop = win_length // 2
    t = x.shape[-1]
    if padding:
        n_frames = -(-t // hop) + 1
        x = _reflect_pad(x, hop, (n_frames + 1) * hop - t)
    frames = frame_signal(x, win_length, hop)
    if padding:
        frames = frames[..., :-1, :]
    xr = frames.float()
    re = torch.matmul(xr, _basis(bf_r, xr)).transpose(-1, -2)
    if not return_complex:
        return re
    im = torch.matmul(xr, _basis(bf_i, xr)).transpose(-1, -2)
    return re, im


def imdct(spec: torch.Tensor, win_length: int, window_fn: str = "sin_mdct",
          window_kwargs: Optional[dict] = None, padding: bool = True) -> torch.Tensor:
    """Inverse MDCT of (..., N, frames) -> (..., T), T = hop * (frames - 1)
    with ``padding`` (hop * (frames + 1) without)."""
    _, _, bi = _mdct_bases(_win_key(window_fn, window_kwargs), win_length)
    hop = win_length // 2
    y = spec.transpose(-1, -2).float()
    sig = overlap_add(torch.matmul(y, _basis(bi, y)), hop)
    if padding:
        sig = sig[..., hop: sig.shape[-1] - hop]
    return sig


@functools.lru_cache(maxsize=16)
def _mclt_bases(window_key: Tuple, block_width: int):
    """Forward/inverse MCLT bases; the window raised to its ``exponent``."""
    name, kwargs_t = window_key
    kwargs = dict(kwargs_t)
    exponent = kwargs.pop("exponent", 1.0)
    if exponent == 0:
        window = np.ones(block_width, dtype=np.float64)
    else:
        window = get_window(name, block_width, **kwargs) ** exponent
    L = block_width
    N = L // 2
    n = np.arange(L, dtype=np.float64)
    k = np.arange(N, dtype=np.float64) + 0.5
    pre = np.exp(-1j * np.pi / 2 / N * n)
    post = np.exp(-1j * np.pi / 2 / N * (N + 1) * k)
    dft = np.exp(-2j * np.pi * np.outer(n, np.arange(N)) / L) / L
    bf = (window * pre)[:, None] * dft * post[None, :] * (2.0 * N ** 0.5)
    idft = np.exp(2j * np.pi * np.outer(np.arange(N), n) / L) / L
    bi = (1.0 / post)[:, None] * idft * (window / pre)[None, :] * (2.0 * N ** 0.5)
    return (bf.real.astype(np.float32), bf.imag.astype(np.float32),
            bi.real.astype(np.float32), bi.imag.astype(np.float32))


def mclt(x: torch.Tensor, block_width: int, window_fn: str = "hann",
         window_exponent: float = 1.0):
    """Complex MCLT of (..., T) -> (real, imag), each (..., frames, N):
    reflect padded by hop on the left and to a whole hop plus one on the
    right, the window raised to ``window_exponent``."""
    bf_r, bf_i, _, _ = _mclt_bases(_win_key(window_fn, {"exponent": window_exponent}),
                                   block_width)
    hop = block_width // 2
    t = x.shape[-1]
    frames = frame_signal(_reflect_pad(x, hop, hop + (hop - t % hop) % hop), block_width,
                          hop).float()
    return torch.matmul(frames, _basis(bf_r, frames)), torch.matmul(frames, _basis(bf_i, frames))


def imclt(spec_r: torch.Tensor, spec_i: torch.Tensor, block_width: int,
          window_fn: str = "hann", window_exponent: float = 1.0) -> torch.Tensor:
    """Inverse MCLT of a (..., frames, N) pair -> real (..., T)."""
    _, _, bi_r, bi_i = _mclt_bases(_win_key(window_fn, {"exponent": window_exponent}),
                                   block_width)
    hop = block_width // 2
    sr, si = spec_r.float(), spec_i.float()
    sig = overlap_add(torch.matmul(sr, _basis(bi_r, sr)) - torch.matmul(si, _basis(bi_i, si)),
                      hop)
    return sig[..., hop: sig.shape[-1] - hop]
