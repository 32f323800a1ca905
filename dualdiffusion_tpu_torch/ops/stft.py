"""STFT / inverse STFT on ``torch.fft``.

Same semantics as dualdiffusion_tpu/ops/stft.py (torch.stft/istft
compatible: center=True, reflect padding, onesided). Spectra are
(..., frames, bins): frames-major, as in the JAX package. These transforms
run outside any kernel in the JAX package too, so ``torch.fft`` is the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def pad_center(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Pad a win_length window symmetrically to n_fft (torch semantics)."""
    wl = window.shape[0]
    if wl == n_fft:
        return window
    left = (n_fft - wl) // 2
    return np.pad(window, (left, n_fft - wl - left))


def overlap_add_np(frames: np.ndarray, hop: int) -> np.ndarray:
    f, l = frames.shape
    out = np.zeros((f - 1) * hop + l, dtype=np.float64)
    for i in range(f):
        out[i * hop: i * hop + l] += frames[i]
    return out


def envelope(window: np.ndarray, n_fft: int, hop_length: int, frames: int,
             eps: float = 1e-11) -> np.ndarray:
    """Overlap-added squared window over the whole (uncropped) signal,
    clamped at ``eps`` where hann**32-style windows underflow (float64)."""
    win = pad_center(np.asarray(window, np.float64), n_fft)
    env = overlap_add_np(np.broadcast_to(win ** 2, (frames, n_fft)), hop_length)
    return np.maximum(env, eps)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(..., F, L) -> (..., (F-1)*hop + L)."""
    lead = frames.shape[:-2]
    f, l = frames.shape[-2:]
    out_len = (f - 1) * hop_length + l
    cols = frames.reshape(-1, f, l).transpose(1, 2)
    sig = F.fold(cols, output_size=(1, out_len), kernel_size=(1, l),
                 stride=(1, hop_length))
    return sig.reshape(lead + (out_len,))


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """(..., T) -> (..., F, frame_length), F = (T - frame_length)//hop + 1."""
    return x.unfold(-1, frame_length, hop_length)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(lead + (y.shape[-1],))


def stft(x: torch.Tensor, window: np.ndarray, n_fft: int, hop_length: int,
         center: bool = True, normalized: bool = False) -> torch.Tensor:
    """(..., T) real -> complex (..., frames, bins). ``normalized`` scales by
    n_fft**-0.5 (torch.stft's semantics)."""
    win = pad_center(np.asarray(window, np.float64), n_fft)
    if normalized:
        win = win / np.sqrt(n_fft)
    win = torch.as_tensor(win, dtype=torch.promote_types(x.dtype, torch.float32),
                          device=x.device)
    if center:
        x = reflect_pad(x, n_fft // 2)
    return torch.fft.rfft(frame_signal(x, n_fft, hop_length) * win, n=n_fft)


def istft(spec: torch.Tensor, window: np.ndarray, n_fft: int, hop_length: int,
          center: bool = True, length: Optional[int] = None) -> torch.Tensor:
    """complex (..., frames, bins) -> (..., T): overlap-add of windowed irfft
    frames over the squared-window envelope."""
    f = spec.shape[-2]
    win = torch.as_tensor(pad_center(np.asarray(window, np.float64), n_fft),
                          dtype=torch.float32, device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft) * win
    sig = overlap_add(frames, hop_length)
    env = envelope(window, n_fft, hop_length, f).astype(np.float32)
    sig = sig / torch.as_tensor(env, device=sig.device)
    if center:
        sig = sig[..., n_fft // 2: sig.shape[-1] - n_fft // 2]
    out_len = length if length is not None else (f - 1) * hop_length
    if sig.shape[-1] > out_len:
        sig = sig[..., :out_len]
    elif sig.shape[-1] < out_len:
        sig = F.pad(sig, (0, out_len - sig.shape[-1]))
    return sig


def stft_num_frames(t: int, hop_length: int, center: bool = True, n_fft: int = 0) -> int:
    """Frames of the STFT of ``t`` samples: centred, t // hop + 1; else
    (t - n_fft) // hop + 1 (JAX ops/stft.py:180)."""
    if center:
        return t // hop_length + 1
    return (t - n_fft) // hop_length + 1
