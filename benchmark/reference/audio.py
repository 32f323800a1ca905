# Frozen copy of the math of dualdiffusion_tpu_torch/ops/{windows,mel,stft,fgla,mdct}.py
# and the decode halves of models/formats/{spectrogram,ms_mdct_dual}.py.
"""The plain reference's audio decode: windows, mel filterbanks, STFT and
inverse, Griffin-Lim as the plain loop on ``torch.fft``, the inverse MDCT,
and the two formats' decodes (the mel spectrogram's Griffin-Lim and the
MS-MDCT dual format's PSD conditioning and inverse MDCT).

Everything runs in float32, except where a ``Precision`` stores a state in
a lower type: the work dtype of the Griffin-Lim iteration.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision


# ---- windows ----------------------------------------------------------------

def hann(n: int, periodic: bool = True) -> np.ndarray:
    denom = n if periodic else n - 1
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=np.float64) / denom)


def hann_power(n: int, exponent: float, periodic: bool = True) -> np.ndarray:
    return np.ones(n) if exponent == 0 else hann(n, periodic) ** exponent


def sin_window(n: int) -> np.ndarray:
    return np.sin(np.pi * (np.arange(n, dtype=np.float64) + 0.5) / n)


# ---- mel scale ----------------------------------------------------------------

def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_density(hz):
    return 1127.0 / (700.0 + hz)


def mel_points(f_min: float, f_max: float, n: int) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n))


def mel_filters(sample_rate: int, n_bins: int, n_filters: int, f_min: float, f_max: float,
                slaney: bool = False) -> np.ndarray:
    """(n_bins, n_filters) triangular mel filterbank, float32."""
    freqs = np.linspace(0.0, sample_rate / 2, n_bins)
    pts = mel_points(f_min, f_max, n_filters + 2)
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    if slaney:
        fb = fb * (2.0 / (pts[2:n_filters + 2] - pts[:n_filters]))[None, :]
    return fb.astype(np.float32)


def pinv_t(filters: np.ndarray) -> np.ndarray:
    """pinv(filters.T), float32 (rcond 1e-10, in float64)."""
    return np.linalg.pinv(filters.T.astype(np.float64), rcond=1e-10).astype(np.float32)


# ---- STFT -------------------------------------------------------------------------

def pad_center(window: np.ndarray, n_fft: int) -> np.ndarray:
    left = (n_fft - window.shape[0]) // 2
    return np.pad(window, (left, n_fft - window.shape[0] - left))


def envelope(window: np.ndarray, n_fft: int, hop: int, frames: int) -> np.ndarray:
    win = pad_center(np.asarray(window, np.float64), n_fft)
    env = np.zeros((frames - 1) * hop + n_fft)
    for i in range(frames):
        env[i * hop: i * hop + n_fft] += win ** 2
    return np.maximum(env, 1e-11)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., F, L) -> (..., (F-1)*hop + L)."""
    lead, (f, l) = frames.shape[:-2], frames.shape[-2:]
    n = (f - 1) * hop + l
    sig = F.fold(frames.reshape(-1, f, l).transpose(1, 2), output_size=(1, n),
                 kernel_size=(1, l), stride=(1, hop))
    return sig.reshape(lead + (n,))


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode="reflect")
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def stft(x: torch.Tensor, window: np.ndarray, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> complex (..., frames, bins), centred, reflect-padded."""
    win = torch.as_tensor(pad_center(np.asarray(window, np.float64), n_fft),
                          dtype=torch.float32, device=x.device)
    x = reflect_pad(x, n_fft // 2, n_fft // 2)
    return torch.fft.rfft(x.unfold(-1, n_fft, hop) * win, n=n_fft)


def istft(spec: torch.Tensor, window: np.ndarray, n_fft: int, hop: int,
          length: Optional[int] = None) -> torch.Tensor:
    f = spec.shape[-2]
    win = torch.as_tensor(pad_center(np.asarray(window, np.float64), n_fft),
                          dtype=torch.float32, device=spec.device)
    sig = overlap_add(torch.fft.irfft(spec, n=n_fft) * win, hop)
    sig = sig / torch.as_tensor(envelope(window, n_fft, hop, f).astype(np.float32),
                                device=sig.device)
    sig = sig[..., n_fft // 2: sig.shape[-1] - n_fft // 2]
    n = length if length is not None else (f - 1) * hop
    return sig[..., :n] if sig.shape[-1] >= n else F.pad(sig, (0, n - sig.shape[-1]))


# ---- Griffin-Lim ---------------------------------------------------------------------

def spsi_phase(mag: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Phase-locked SPSI initial phases of (..., frames, bins) magnitudes."""
    k = mag.shape[-1]
    a, b, c = mag[..., :-2], mag[..., 1:-1], mag[..., 2:]
    denom = a - 2.0 * b + c
    p = 0.5 * (a - c) / torch.where(denom.abs() > 1e-12, denom, torch.full_like(denom, math.inf))
    p = F.pad(p.clamp(-0.5, 0.5), (1, 1))
    idx = torch.arange(k, device=mag.device)
    phi_acc = torch.cumsum(2.0 * math.pi * hop * (idx.float() + p) / n_fft, dim=-2)
    left = F.pad(mag[..., :-1], (1, 0))
    right = F.pad(mag[..., 1:], (0, 1))
    peak = (mag > left) & (mag >= right)
    big = torch.full_like(idx, -10 * k)
    lp = torch.cummax(torch.where(peak, idx, big), dim=-1).values
    rp = -torch.cummax(torch.where(peak, -idx, big).flip(-1), dim=-1).values.flip(-1)
    kp = torch.where((idx - lp) <= (rp - idx), lp, rp).clamp(0, k - 1)
    return torch.gather(phi_acc, -1, kp) + math.pi * (idx - kp).float()


def griffinlim(spec: torch.Tensor, window: np.ndarray, n_fft: int, hop: int, n_iter: int,
               momentum: float, stereo: bool, stereo_coherence: float, phase_init: str,
               prec: Precision) -> torch.Tensor:
    """Fast Griffin-Lim with momentum and stereo-coherent annealing on
    (B, C, frames, bins) magnitudes -> (B, C, T); the iterated state is held
    in ``prec.gl_state``."""
    mom = momentum / (1.0 + momentum)
    spec = spec.float()
    merged = spec.mean(dim=1, keepdim=True).expand_as(spec) if stereo and spec.shape[1] > 1 \
        else spec
    if phase_init == "spsi":
        phi = spsi_phase(spec, n_fft, hop)
        ang_r, ang_i = torch.cos(phi), torch.sin(phi)
    else:
        ang_r, ang_i = torch.ones_like(spec), torch.zeros_like(spec)
    q = prec.gl_state
    spec_w, merged_w = q(spec), q(merged)
    ang_r, ang_i = q(ang_r), q(ang_i)
    prev_r = torch.zeros_like(ang_r)
    prev_i = torch.zeros_like(ang_i)
    for i in range(n_iter):
        t = i / n_iter - stereo_coherence
        interp = q(merged_w + (spec_w - merged_w) * t) if t > 0 else merged_w
        x = torch.complex(ang_r * interp, ang_i * interp)
        r = stft(istft(x, window, n_fft, hop), window, n_fft, hop)
        rr, ri = q(r.real), q(r.imag)
        nr, ni = q(rr - mom * prev_r), q(ri - mom * prev_i)
        mag = torch.sqrt(nr * nr + ni * ni) + 1e-12
        ang_r, ang_i, prev_r, prev_i = q(nr / mag), q(ni / mag), rr, ri
    return istft(torch.complex(ang_r * spec, ang_i * spec), window, n_fft, hop)


# ---- the inverse MDCT -------------------------------------------------------------------

def imdct_basis(win_length: int) -> np.ndarray:
    """(N, L) inverse MDCT basis of the sine window, scaling folded in."""
    window = sin_window(win_length)
    L, N = win_length, win_length // 2
    k = np.arange(N, dtype=np.float64)
    scaling = 1.0 / np.sqrt(L * N)
    pre2 = np.exp(-1j * np.pi / (2 * N) * (N + 1) * k)
    n_out = np.arange(0.5 + N / 2, 2 * N + N / 2 + 0.5, dtype=np.float64)
    post2 = np.exp(-1j * np.pi / (2 * N) * n_out) / N
    dft2 = np.exp(-2j * np.pi * np.outer(k, np.arange(L)) / L)
    bi = np.real(pre2[:, None] * dft2 * post2[None, :]) * 2.0 * window[None, :] / scaling
    return bi.astype(np.float32)


def imdct(spec: torch.Tensor, win_length: int) -> torch.Tensor:
    """(..., N, frames) -> (..., hop * (frames - 1))."""
    hop = win_length // 2
    y = spec.transpose(-1, -2).float()
    sig = overlap_add(torch.matmul(y, torch.as_tensor(imdct_basis(win_length), device=y.device)),
                      hop)
    return sig[..., hop: sig.shape[-1] - hop]


# ---- the formats' decodes -----------------------------------------------------------------

class SpectrogramDecode:
    """The mel spectrogram format's decode: mel unscale through the
    filterbank's pseudoinverse, then Griffin-Lim on the hann**32 STFT grid."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        sr = cfg["sample_rate"]
        self.n_fft = int(cfg["padded_duration_ms"] / 1000.0 * sr)
        self.hop = int(cfg["step_size_ms"] / 1000.0 * sr)
        self.window = hann_power(int(cfg["window_duration_ms"] / 1000.0 * sr),
                                 cfg["window_exponent"], cfg["window_periodic"])
        filters = mel_filters(sr, self.n_fft // 2 + 1, cfg["num_frequencies"],
                              cfg["min_frequency"], cfg["max_frequency"])
        self.pinv = pinv_t(filters)

    def magnitudes(self, sample: torch.Tensor) -> torch.Tensor:
        """(B, F, T', C) mel sample -> (B, C, frames, bins) linear magnitudes."""
        cfg = self.cfg
        mel = sample.float() / cfg["raw_to_sample_scale"] + cfg["sample_mean"]
        mel = mel.permute(0, 3, 1, 2).clamp_min(0.0)
        lin = torch.matmul(torch.as_tensor(self.pinv, device=mel.device),
                           mel ** (1.0 / cfg["abs_exponent"])).clamp_min(0.0)
        return lin.transpose(-1, -2)

    def __call__(self, sample: torch.Tensor, n_iter: int, phase_init: str,
                 prec: Precision) -> torch.Tensor:
        cfg = self.cfg
        return griffinlim(self.magnitudes(sample), self.window, self.n_fft, self.hop, n_iter,
                          cfg["fgla_momentum"], cfg["num_raw_channels"] == 2,
                          cfg["stereo_coherence"], phase_init, prec)


class MDCTDualDecode:
    """The MS-MDCT dual format's DDEC conditioning (``mel_spec_to_linear``)
    and its inverse MDCT."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        sr = cfg["sample_rate"]
        n_bins = cfg["ms_window_length"] // 2 + 1
        f_max = cfg.get("ms_freq_max_override") or sr / 2
        raw = mel_filters(sr, n_bins, cfg["ms_num_filters"], cfg["ms_freq_min"], f_max,
                          slaney=True)
        self.pinv = pinv_t(raw.astype(np.float64))
        self.stft_density = mel_density(np.linspace(0, sr / 2, n_bins)).astype(np.float32)
        n = cfg["mdct_window_len"] // 2
        self.mdct_density = mel_density((np.arange(n) + 0.5) * sr
                                        / cfg["mdct_window_len"]).astype(np.float32)

    def mel_spec_to_linear(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ms = mel * cfg["raw_to_mel_spec_scale"] - cfg["raw_to_mel_spec_offset"]
        ms = ms.clamp_min(0.0) ** (1.0 / cfg["ms_abs_exponent"])
        lin = torch.einsum("bftc,nf->bntc", ms, torch.as_tensor(self.pinv, device=ms.device))
        lin = lin * torch.as_tensor(np.sqrt(self.stft_density), device=ms.device)[None, :, None,
                                                                                   None]
        return (lin[:, :-1] + cfg["mel_spec_to_linear_offset"]) / cfg["mel_spec_to_linear_scale"]

    def mdct_shape(self, batch: int, mel_frames: int) -> tuple:
        return (batch, self.cfg["mdct_window_len"] // 2, mel_frames, self.cfg["num_raw_channels"])

    def mdct_to_raw(self, coeffs: torch.Tensor) -> torch.Tensor:
        x = coeffs.permute(0, 3, 1, 2).float()
        x = x * torch.as_tensor(self.mdct_density, device=x.device)[:, None] \
            * self.cfg["raw_to_mdct_scale"]
        return imdct(x, self.cfg["mdct_window_len"])
