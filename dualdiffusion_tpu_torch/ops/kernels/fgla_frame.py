"""K2: the per-frame half of one Griffin-Lim iteration: forward real DFT,
momentum, phase normalise, annealed magnitude, inverse real DFT.

Two kernels, chosen by size before the launch (:func:`fgla_plan`): n_fft
6400 and 4096, the serving paths' sizes, take csrc/fgla_frame_hopper.cu
(three register-resident FFT passes, several frames a block); any other
even n_fft takes the Stockham kernel of csrc/fgla_frame.cu.

Replaces the spectral and DFT parts of dualdiffusion_tpu/ops/pallas/
fgla_iter.py (``_kernel`` via ``fgla_iter``), which hold the math of
fgla_spectral.py and the DFT stages of fgla_middle.py. The plain version is
the loop body of dualdiffusion_tpu/ops/fgla.py:153-170 on ``torch.fft``.

Complex state is real (..., bins, 2) in the work dtype (fp32 or bf16);
every step computes in fp32.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .build import library
from .common import FallbackRoute, check, on_cpu, ptr, stream_of

#: two buffers of n/2 complex fp32 must fit a block's shared memory (227 KB)
MAX_N = 227 * 1024 // 8


def fft_radices(n: int) -> list:
    """Stockham stage radices: 4s, then a 2, then odd primes."""
    out = []
    while n % 4 == 0:
        out.append(4)
        n //= 4
    if n % 2 == 0:
        out.append(2)
        n //= 2
    p = 3
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 2
    return out


@dataclass(frozen=True)
class FglaPlan:
    """How K2 runs a frame of n_fft samples (an m = n/2 complex DFT).

    route: "hopper" (csrc/fgla_frame_hopper.cu) or "stockham"
    (csrc/fgla_frame.cu). Hopper: each of ``threads`` threads of a frame
    holds ``points`` complex points in registers through three passes of
    ``radices`` (points x threads = m), ``frames`` frames a block; shared
    slot of point e: e + e // SMEM_PAD_EVERY. Stockham: ``radices`` are its
    stages, one shared-memory sweep each."""
    route: str
    radices: Tuple[int, ...]
    points: int = 0
    threads: int = 0
    frames: int = 0


#: m -> (points, threads a frame, frames a block, pass radices); the
#: kernel compiles the same plans (dd_fgla_frame_hopper_plan)
HOPPER_PLANS = {3200: (40, 80, 4, (40, 10, 8)), 2048: (32, 64, 4, (32, 8, 8))}
#: one padding slot every 32 complex points in the Hopper kernel's buffers
SMEM_PAD_EVERY = 32


#: ``with stockham_everywhere():`` K2 takes the Stockham kernel at every size
stockham_everywhere = FallbackRoute()


def fgla_plan(n: int, stockham_only: bool = False) -> FglaPlan:
    """The route and pass schedule K2 takes for n_fft ``n`` (even); the
    Stockham kernel at every size with ``stockham_only``."""
    m = n // 2
    if not stockham_only and n % 2 == 0 and m in HOPPER_PLANS:
        points, threads, frames, radices = HOPPER_PLANS[m]
        return FglaPlan("hopper", radices, points, threads, frames)
    return FglaPlan("stockham", tuple(fft_radices(m)))


def dft_twiddles(n: int, device) -> torch.Tensor:
    """(n, 2) fp32 table of exp(-2 pi i t / n), computed in fp64."""
    t = torch.arange(n, dtype=torch.float64, device=device) * (-2.0 * math.pi / n)
    return torch.stack([torch.cos(t), torch.sin(t)], dim=-1).float().contiguous()


def fgla_frame_plain(x: torch.Tensor, r_prev: Optional[torch.Tensor],
                     spec: torch.Tensor, merged: torch.Tensor, t: float, mom: float,
                     spectral_in: bool = False, inverse: bool = True,
                     compute: torch.dtype = torch.float32
                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """See :func:`fgla_frame`. ``compute``: the dtype every step runs in
    (float32 as in the kernels; float64 gives the reference the kernels are
    held against)."""
    wd = spec.dtype
    n = 2 * (spec.shape[-1] - 1)
    r_new = None
    if spectral_in:
        r = x.to(compute)
    else:
        r_new = torch.view_as_real(torch.fft.rfft(x.to(compute), dim=-1)).to(wd)
        r = r_new.to(compute)
    if r_prev is not None:
        r = r - mom * r_prev.to(compute)
    mag = torch.sqrt(r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]) + 1e-12
    mg = merged.to(compute)
    interp = mg + (spec.to(compute) - mg) * max(t, 0.0)
    y = None
    if inverse:
        xs = torch.complex(r[..., 0] / mag * interp, r[..., 1] / mag * interp)
        y = torch.fft.irfft(xs, n=n, dim=-1).to(wd)
    return r_new, y


def fgla_frame(x: torch.Tensor, r_prev: Optional[torch.Tensor],
               spec: torch.Tensor, merged: torch.Tensor, t: float, mom: float,
               twiddle: torch.Tensor, spectral_in: bool = False, inverse: bool = True
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One frame-local Griffin-Lim step over every frame.

    x: reframed windowed frames (..., F, n), or with ``spectral_in`` a
    spectrum (..., F, bins, 2) used as r directly (the seed call).
    r_prev: the previous forward spectrum (..., F, bins, 2), or None for 0.
    spec, merged: (..., F, bins) target and channel-merged magnitudes.
    t: annealing factor of the NEXT x. Returns (r, y): the forward spectrum
    of x (None with ``spectral_in``) and irfft of
    normalize(r - mom*r_prev) * (merged + relu(t)*(spec - merged)) as
    (..., F, n) frames (None without ``inverse``). All in the work dtype
    (spec's dtype). twiddle: :func:`dft_twiddles` (n) on the device.
    CPU tensors take the plain version.
    """
    bins = spec.shape[-1]
    n = 2 * (bins - 1)
    want = spec.shape + (2,) if spectral_in else spec.shape[:-1] + (n,)
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"x: expected {tuple(want)}, got {tuple(x.shape)}")
    if on_cpu(x, r_prev, spec, merged, twiddle):
        return fgla_frame_plain(x, r_prev, spec, merged, t, mom, spectral_in, inverse)
    if n > MAX_N:
        raise ValueError(f"n_fft {n} exceeds the {MAX_N} a block's shared memory holds")
    wd = spec.dtype
    for name, tensor in (("x", x), ("spec", spec), ("merged", merged), ("r_prev", r_prev)):
        if tensor is not None:
            check(tensor, name, (wd,))
    if merged.shape != spec.shape:
        raise ValueError("merged and spec shapes differ")
    if r_prev is not None and r_prev.shape != spec.shape + (2,):
        raise ValueError(f"r_prev: expected {tuple(spec.shape) + (2,)}, got {tuple(r_prev.shape)}")
    check(twiddle, "twiddle", (torch.float32,), shape=(n, 2))
    if wd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"work dtype {wd} is not float32 or bfloat16")
    plan = fgla_plan(n, stockham_everywhere.active)
    if plan.route == "hopper":
        # frames move 16 bytes at a time, spectra a complex pair at a time
        pair = 2 * spec.element_size()
        for name, tensor, align in (("x", x, pair if spectral_in else 16),
                                    ("r_prev", r_prev, pair)):
            if tensor is not None and tensor.data_ptr() % align:
                raise ValueError(f"{name}: the Hopper route needs a {align}-byte aligned "
                                 f"data pointer")
    rows = spec.numel() // bins
    r_new = None if spectral_in else torch.empty(spec.shape + (2,), dtype=wd, device=x.device)
    y = torch.empty(spec.shape[:-1] + (n,), dtype=wd, device=x.device) if inverse else None
    lib = library()
    frames_ptr = None if spectral_in else x.data_ptr()
    r_in_ptr = x.data_ptr() if spectral_in else None
    with torch.cuda.device(x.device):
        if plan.route == "hopper":
            err = lib.lib.dd_fgla_frame_hopper(
                frames_ptr, r_in_ptr, ptr(r_prev), ptr(r_new), ptr(y), spec.data_ptr(),
                merged.data_ptr(), twiddle.data_ptr(), rows, n, float(t), float(mom),
                int(wd == torch.bfloat16), stream_of(x))
        else:
            rad = (ctypes.c_int * len(plan.radices))(*plan.radices)
            err = lib.lib.dd_fgla_frame(
                frames_ptr, r_in_ptr, ptr(r_prev), ptr(r_new), ptr(y), spec.data_ptr(),
                merged.data_ptr(), twiddle.data_ptr(), rad, len(plan.radices), rows, n,
                float(t), float(mom), int(wd == torch.bfloat16), stream_of(x))
    lib.check(err, f"fgla_frame ({plan.route})")
    fgla_frame.launches += 1
    return r_new, y


fgla_frame.launches = 0
