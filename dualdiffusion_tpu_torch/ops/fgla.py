"""Fast Griffin-Lim (FGLA) phase reconstruction with momentum and
stereo-coherent annealing (reference: src/modules/formats/old/
phase_recovery.py:39-129; JAX: dualdiffusion_tpu/ops/fgla.py).

``griffinlim`` runs the iteration as two kernels per step: K3
(ola_reframe, the only cross-frame step) then K2 (fgla_frame: forward DFT,
momentum, phase normalise, annealed magnitude, inverse DFT). K2's body is
rotated (forward DFT first) but it is the same iteration as the plain loop,
``griffinlim_reference``, which is the loop of ops/fgla.py:153-177 on
``torch.fft``. Setup (merged magnitude, phase init) and the final fp32
istft are plain torch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import dft_twiddles, fgla_frame, ola_reframe
from .stft import envelope, istft, pad_center, stft


def spsi_phase(mag: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Phase-locked SPSI initial phases from magnitudes (Beauregard, Harish
    & Wyse 2015; JAX: ops/fgla.py:33-86). mag: (..., frames, bins) linear
    magnitudes. Returns fp32 phases of the same shape."""
    k_bins = mag.shape[-1]
    a, b, c = mag[..., :-2], mag[..., 1:-1], mag[..., 2:]
    denom = a - 2.0 * b + c
    p = 0.5 * (a - c) / torch.where(denom.abs() > 1e-12, denom,
                                    torch.full_like(denom, math.inf))
    p = F.pad(p.clamp(-0.5, 0.5), (1, 1))
    idx = torch.arange(k_bins, device=mag.device)
    khat = idx.float() + p
    omega = 2.0 * math.pi * hop_length * khat / n_fft
    phi_acc = torch.cumsum(omega.float(), dim=-2)

    # per-frame local peaks; ties broken rightward (> left, >= right)
    left = F.pad(mag[..., :-1], (1, 0))
    right = F.pad(mag[..., 1:], (0, 1))
    is_peak = (mag > left) & (mag >= right)
    big = torch.full_like(idx, -10 * k_bins)
    lp = torch.cummax(torch.where(is_peak, idx, big), dim=-1).values
    rp = -torch.cummax(torch.where(is_peak, -idx, big).flip(-1), dim=-1).values.flip(-1)
    kp = torch.where((idx - lp) <= (rp - idx), lp, rp).clamp(0, k_bins - 1)
    phi_pk = torch.gather(phi_acc, -1, kp)
    return phi_pk + math.pi * (idx - kp).float()


def _setup(specgram, n_fft, hop_length, momentum, stereo, phase_init):
    if not 0 <= momentum < 1:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    if phase_init not in ("flat", "spsi"):
        raise ValueError(f"phase_init must be 'flat' or 'spsi', got {phase_init!r}")
    spec = specgram.float()
    merged = spec.mean(dim=1, keepdim=True).expand_as(spec) if stereo and spec.shape[1] > 1 \
        else spec
    if phase_init == "spsi":
        phi = spsi_phase(spec, n_fft, hop_length)
        ang0 = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    else:
        ang0 = torch.stack([torch.ones_like(spec), torch.zeros_like(spec)], dim=-1)
    return momentum / (1.0 + momentum), spec, merged, ang0


def _synthesize(ang_r, ang_i, spec, window, n_fft, hop_length, length):
    return istft(torch.complex(ang_r * spec, ang_i * spec), window, n_fft, hop_length,
                 length=length)


def griffinlim(specgram: torch.Tensor, window: np.ndarray, n_fft: int,
               hop_length: int, n_iter: int = 200, momentum: float = 0.99,
               stereo: bool = True, stereo_coherence: float = 0.67,
               length: Optional[int] = None, work_dtype: str = "float32",
               phase_init: str = "flat") -> torch.Tensor:
    """Reconstruct audio from magnitudes through the K3 + K2 kernel loop.

    specgram: (B, C, frames, bins) linear magnitudes (frames-major). Returns
    (B, C, T), T = (frames-1)*hop (or ``length``). The iterated state is
    stored in ``work_dtype`` ("float32" or "bfloat16") and computed in fp32;
    the final istft is fp32. On CPU tensors the kernels' plain versions run.
    """
    mom, spec, merged, ang0 = _setup(specgram, n_fft, hop_length, momentum, stereo,
                                     phase_init)
    if n_iter == 0:
        return _synthesize(ang0[..., 0], ang0[..., 1], spec, window, n_fft, hop_length, length)
    wd = getattr(torch, work_dtype)
    dev = spec.device
    f = spec.shape[-2]
    spec_w = spec.to(wd).contiguous()
    merged_w = merged.to(wd).contiguous()
    win = torch.as_tensor(pad_center(np.asarray(window, np.float64), n_fft),
                          dtype=torch.float32, device=dev)
    inv_env = torch.as_tensor((1.0 / envelope(window, n_fft, hop_length, f)).astype(np.float32),
                              device=dev)
    twiddle = dft_twiddles(n_fft, dev)

    def t_of(i: int) -> float:
        return i / n_iter - stereo_coherence

    # seed: y_0 = irfft(ang0 * interp(t_0)), with r := ang0 and no momentum
    _, y = fgla_frame(ang0.to(wd).contiguous(), None, spec_w, merged_w, t_of(0), mom,
                      twiddle, spectral_in=True)
    r_cur = r_old = None
    for i in range(n_iter):
        frames = ola_reframe(y, win, inv_env, hop_length)
        r_new, y = fgla_frame(frames, r_cur, spec_w, merged_w, t_of(i + 1), mom, twiddle,
                              inverse=i + 1 < n_iter)
        r_old, r_cur = r_cur, r_new
    n = r_cur.float()
    if r_old is not None:
        n = n - mom * r_old.float()
    mag = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1]) + 1e-12
    return _synthesize(n[..., 0] / mag, n[..., 1] / mag, spec, window, n_fft, hop_length,
                       length)


def griffinlim_reference(specgram: torch.Tensor, window: np.ndarray, n_fft: int,
                         hop_length: int, n_iter: int = 200, momentum: float = 0.99,
                         stereo: bool = True, stereo_coherence: float = 0.67,
                         length: Optional[int] = None, work_dtype: str = "float32",
                         phase_init: str = "flat") -> torch.Tensor:
    """The plain loop (JAX ops/fgla.py:153-177) on stft/istft: the reference
    the kernel loop is held against. Elementwise steps run in the work dtype;
    the transforms in fp32."""
    mom, spec, merged, ang0 = _setup(specgram, n_fft, hop_length, momentum, stereo,
                                     phase_init)
    wd = getattr(torch, work_dtype)
    spec_w, merged_w = spec.to(wd), merged.to(wd)
    ang_r, ang_i = ang0[..., 0].to(wd), ang0[..., 1].to(wd)
    prev_r = torch.zeros_like(ang_r)
    prev_i = torch.zeros_like(ang_i)
    for i in range(n_iter):
        t = i / n_iter - stereo_coherence
        interp = merged_w + (spec_w - merged_w) * t if t > 0 else merged_w
        x = torch.complex((ang_r * interp).float(), (ang_i * interp).float())
        r = stft(istft(x, window, n_fft, hop_length), window, n_fft, hop_length)
        rr, ri = r.real.to(wd), r.imag.to(wd)
        nr = rr - mom * prev_r
        ni = ri - mom * prev_i
        mag = torch.sqrt(nr * nr + ni * ni) + 1e-12
        ang_r, ang_i, prev_r, prev_i = nr / mag, ni / mag, rr, ri
    return _synthesize(ang_r.float(), ang_i.float(), spec, window, n_fft, hop_length, length)
