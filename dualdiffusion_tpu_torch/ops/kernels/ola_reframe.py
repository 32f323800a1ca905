"""K3: window -> overlap-add -> 1/envelope -> crop -> reflect pad -> reframe
-> window, on natural-layout frames (csrc/ola_reframe.cu).

Replaces dualdiffusion_tpu/ops/pallas/ola_reframe.py (``_ola_reframe_kernel``
via ``ola_reframe``); the plain version is a torch port of
``ola_reframe_jnp`` (dualdiffusion_tpu/ops/fgla_fast.py:183-217).
"""

from __future__ import annotations

import torch

from ..stft import frame_signal, overlap_add, reflect_pad
from .build import library
from .common import check, on_cpu, stream_of

#: output frames per block; its padded-signal span must fit shared memory
FRAMES_PER_BLOCK = 16
SMEM_LIMIT = 227 * 1024


def ola_reframe_plain(y: torch.Tensor, win: torch.Tensor, inv_env: torch.Tensor,
                      hop: int) -> torch.Tensor:
    """y (..., F, n) -> (..., F, n), computed in fp32, stored in y's dtype."""
    n = y.shape[-1]
    sig = overlap_add(y.float() * win, hop) * inv_env
    half = n // 2
    core = sig[..., half:sig.shape[-1] - half]
    frames = frame_signal(reflect_pad(core, half), n, hop)
    return (frames * win).to(y.dtype)


def ola_reframe(y: torch.Tensor, win: torch.Tensor, inv_env: torch.Tensor,
                hop: int) -> torch.Tensor:
    """y: raw inverse-DFT frames (..., F, n) in the work dtype; win (n,) and
    inv_env ((F-1)*hop + n,) fp32. Returns the windowed re-framed frames.
    CPU tensors take the plain version."""
    f, n = y.shape[-2], y.shape[-1]
    if win.shape != (n,) or inv_env.shape != ((f - 1) * hop + n,):
        raise ValueError(f"win {tuple(win.shape)} / inv_env {tuple(inv_env.shape)} "
                         f"do not match F={f}, n={n}, hop={hop}")
    if (f - 1) * hop <= n // 2:
        raise ValueError(f"reflect pad of {n // 2} needs more than {(f - 1) * hop} samples")
    if on_cpu(y, win, inv_env):
        return ola_reframe_plain(y, win, inv_env, hop)
    check(y, "y", (torch.float32, torch.bfloat16))
    check(win, "win", (torch.float32,))
    check(inv_env, "inv_env", (torch.float32,))
    fpb = FRAMES_PER_BLOCK
    while fpb > 1 and ((fpb - 1) * hop + n) * 4 > SMEM_LIMIT:
        fpb //= 2
    if ((fpb - 1) * hop + n) * 4 > SMEM_LIMIT:
        raise ValueError(f"n_fft {n} does not fit shared memory")
    out = torch.empty_like(y)
    bc = y.numel() // (f * n)
    lib = library()
    with torch.cuda.device(y.device):
        err = lib.lib.dd_ola_reframe(y.data_ptr(), out.data_ptr(), win.data_ptr(),
                                     inv_env.data_ptr(), bc, f, n, hop, fpb,
                                     int(y.dtype == torch.bfloat16), stream_of(y))
    lib.check(err, "ola_reframe")
    ola_reframe.launches += 1
    return out


ola_reframe.launches = 0
