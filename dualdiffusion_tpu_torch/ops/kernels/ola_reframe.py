"""K3: window -> overlap-add -> 1/envelope -> crop -> reflect pad -> reframe
-> window, on natural-layout frames.

Two kernels, chosen by shape before the launch (:func:`ola_plan`): hop 256
with n_fft a multiple of 256 (both serving paths' shapes, 6400/256 and
4096/256) takes csrc/ola_reframe_hopper.cu (one warp a hop chunk, registers
only); every other shape takes the gather kernel of csrc/ola_reframe.cu.

Replaces dualdiffusion_tpu/ops/pallas/ola_reframe.py (``_ola_reframe_kernel``
via ``ola_reframe``); the plain version is a torch port of
``ola_reframe_jnp`` (dualdiffusion_tpu/ops/fgla_fast.py:183-217).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..stft import frame_signal, overlap_add, reflect_pad
from .build import library
from .common import FallbackRoute, check, on_cpu, stream_of

#: the gather route's output frames per block; its padded-signal span must fit shared memory
FRAMES_PER_BLOCK = 16
SMEM_LIMIT = 227 * 1024
#: the Hopper route's hop (32 lanes x 8 samples) and warps a block, as the kernel compiles them
HOPPER_HOP = 256
HOPPER_WARPS = 8


@dataclass(frozen=True)
class OlaPlan:
    """How K3 runs frames of n samples at hop ``hop``.

    route: "hopper" (csrc/ola_reframe_hopper.cu) or "gather"
    (csrc/ola_reframe.cu). Hopper: a frame is ``chunks`` = n / hop hop
    chunks; the ``edge_chunks`` padded chunks at each end of a row touch the
    reflect zones and are written by one edge block a row, which recomputes
    at most ``edge_signal_chunks`` signal chunks for each end; every other
    padded chunk is a signal chunk, owned by one warp. The edge blocks keep
    their signal chunks in a global scratch of ``scratch_floats`` a row, so
    the kernel uses no shared memory. Gather: a block
    builds the padded signal under ``frames_per_block`` output frames."""
    route: str
    chunks: int = 0
    edge_chunks: int = 0
    edge_signal_chunks: int = 0
    frames_per_block: int = 0

    @property
    def scratch_floats(self) -> int:
        """fp32 scratch a row (Hopper route): the edge block's signal chunks."""
        return 2 * self.edge_signal_chunks * HOPPER_HOP

    def interior_chunks(self, frames: int) -> int:
        """Padded chunks of a row that main warps own (Hopper route)."""
        return frames - 1 + self.chunks - 2 * self.edge_chunks


def chunk_counts(n: int, hop: int):
    """(R, E, ES) for frames of n = R hop chunks: the padded chunks at each
    end that touch the reflect zones (ceil(R/2): the crop of n/2 covers
    R/2 chunks) and the signal chunks their reflections read (E + 1)."""
    r = n // hop
    e = (r + 1) // 2
    return r, e, e + 1


#: ``with gather_everywhere():`` K3 takes the gather kernel at every shape
gather_everywhere = FallbackRoute()


def ola_plan(n: int, hop: int, gather_only: bool = False) -> OlaPlan:
    """The route K3 takes for frames of n samples at hop ``hop`` (the gather
    kernel at every shape with ``gather_only``)."""
    if not gather_only and hop == HOPPER_HOP and n % hop == 0:
        return OlaPlan("hopper", *chunk_counts(n, hop))
    fpb = FRAMES_PER_BLOCK
    while fpb > 1 and ((fpb - 1) * hop + n) * 4 > SMEM_LIMIT:
        fpb //= 2
    return OlaPlan("gather", frames_per_block=fpb)


def ola_reframe_plain(y: torch.Tensor, win: torch.Tensor, inv_env: torch.Tensor,
                      hop: int, compute: torch.dtype = torch.float32) -> torch.Tensor:
    """y (..., F, n) -> (..., F, n), computed in ``compute`` (fp32 as in the
    kernels; float64 gives a reference), stored in y's dtype."""
    n = y.shape[-1]
    sig = overlap_add(y.to(compute) * win.to(compute), hop) * inv_env.to(compute)
    half = n // 2
    core = sig[..., half:sig.shape[-1] - half]
    frames = frame_signal(reflect_pad(core, half), n, hop)
    return (frames * win.to(compute)).to(y.dtype)


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
    plan = ola_plan(n, hop, gather_everywhere.active)
    if plan.route == "hopper":
        # every lane moves 8 samples at a time as 16-byte vectors
        for name, tensor in (("y", y), ("win", win), ("inv_env", inv_env)):
            if tensor.data_ptr() % 16:
                raise ValueError(f"{name}: the Hopper route needs a 16-byte aligned data pointer")
    elif ((plan.frames_per_block - 1) * hop + n) * 4 > SMEM_LIMIT:
        raise ValueError(f"n_fft {n} does not fit shared memory")
    out = torch.empty_like(y)
    bc = y.numel() // (f * n)
    lib = library()
    with torch.cuda.device(y.device):
        if plan.route == "hopper":
            scratch = torch.empty((bc, plan.scratch_floats), device=y.device)
            err = lib.lib.dd_ola_reframe_hopper(y.data_ptr(), out.data_ptr(), win.data_ptr(),
                                                inv_env.data_ptr(), scratch.data_ptr(), bc, f, n,
                                                int(y.dtype == torch.bfloat16), stream_of(y))
        else:
            err = lib.lib.dd_ola_reframe(y.data_ptr(), out.data_ptr(), win.data_ptr(),
                                         inv_env.data_ptr(), bc, f, n, hop,
                                         plan.frames_per_block, int(y.dtype == torch.bfloat16),
                                         stream_of(y))
    lib.check(err, f"ola_reframe ({plan.route})")
    ola_reframe.launches += 1
    ola_reframe.routes[plan.route] += 1
    return out


ola_reframe.launches = 0
#: launches per route
ola_reframe.routes = {"hopper": 0, "gather": 0}
