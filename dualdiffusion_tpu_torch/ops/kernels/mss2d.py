"""K5 / K6: one block width of the fused 2-D multi-scale spectral loss and
its gradient (csrc/mss2d.cu), and the multi-scale loss built on them.

Replaces dualdiffusion_tpu/ops/pallas/mss2d.py: ``_mss2d_kernel`` (via
``mss2d_block_loss``, ``_mss2d_block_loss_fwd_impl``) and the custom-VJP
backward ``_mss2d_block_loss_bwd``. The plain forward is the strip-by-strip
math of ``_strip_loss_jnp``; the plain gradient is its autograd.

Each wrapper has two routes on the card, chosen by :func:`mss2d_route` from
the arguments before any launch; ``<wrapper>.routes`` counts the card's
calls per route, and both routes count as launches.

- "fft" (csrc/mss2d.cu): every transform a bw-point FFT in registers
  (``MSS2D_PLANS``), for bw 32 and 64, strides 1 to bw and a separable
  window (``_window_2d("flat_top", bw)`` is an outer product), which the
  kernels take as its 1-D factor. The DAE training path runs only this one.
- "dft" (csrc/mss2d_dft.cu): direct DFTs with the whole (bw, bw) window, for
  every other shape the JAX op takes: bw 1 to 128, any stride >= 1, any
  window.

The window and weights are numpy constants, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .build import library
from .common import check, on_cpu, ptr, stream_of

#: block widths the FFT kernels take (the trainer sends smaller ones to the unfold path)
KERNEL_WIDTHS = (32, 64)
#: the widest block the direct-DFT kernels take (one TPU lane tile, as in the JAX op)
MAX_BW = 128
#: floats of K6 direct-DFT scratch a call allocates at most (one row of positions at least)
DFT_SCRATCH_FLOATS = 1 << 26


@dataclass(frozen=True)
class Mss2dPlan:
    """How K5/K6 (csrc/mss2d.cu) run block width bw. Every transform is a
    bw-point complex FFT held by ``threads`` threads of 8 points each, in two
    passes of radix 8 and radix ``threads``; a thread block walks ``cols``
    column blocks side by side. ``z_stride`` and ``q_stride`` are the row
    strides (complex) of the stage-1 ring and the gradient ring, ``x_slots``
    the complex slots of one FFT's shared exchange slice."""
    threads: int
    cols: int
    z_stride: int
    q_stride: int
    x_slots: int


#: bw -> plan; the kernel compiles the same plans (dd_mss2d_plan)
MSS2D_PLANS = {64: Mss2dPlan(8, 1, 66, 34, 72), 32: Mss2dPlan(4, 4, 36, 20, 44)}


def _grid(shape, bw: int, stride: int) -> Tuple[int, int, int, int, int]:
    bc, h, w = shape
    if h < bw or w < bw:
        raise ValueError(f"images {h} x {w} are smaller than the block width {bw}")
    return bc, h, w, (h - bw) // stride + 1, (w - bw) // stride + 1


def mss2d_block_loss_plain(sample: torch.Tensor, target: torch.Tensor, bw: int, stride: int,
                           window: np.ndarray, weight: np.ndarray) -> torch.Tensor:
    """(BC, H, W) x2 fp32 -> (BC,): per image, the sum over block positions
    and bins of weight * | |rfft2(sample block * window)| - |rfft2(target
    block * window)| |, one row strip of blocks at a time."""
    bc, _, _, n_rows, _ = _grid(sample.shape, bw, stride)
    win = torch.as_tensor(window, dtype=torch.float32, device=sample.device)
    wgt = torch.as_tensor(weight, dtype=torch.float32, device=sample.device)

    def mags(strip):  # (BC, bw, W) -> (BC, nC, bw, bins)
        blocks = strip.unfold(-1, bw, stride).permute(0, 2, 1, 3)
        return torch.fft.rfft2(blocks * win).abs()

    total = torch.zeros((bc,), device=sample.device)
    for i in range(n_rows):
        rows = slice(i * stride, i * stride + bw)
        d = (mags(sample[:, rows]) - mags(target[:, rows])).abs()
        total = total + (d * wgt).sum(dim=(1, 2, 3))
    return total


def mss2d_block_loss_grad_plain(sample, target, g, bw, stride, window, weight,
                                need_target: bool = True):
    """The gradient of ``(mss2d_block_loss_plain(...) * g).sum()`` with
    respect to sample (and target), by autograd."""
    with torch.enable_grad():
        s = sample.detach().requires_grad_()
        t = target.detach().requires_grad_(need_target)
        loss = (mss2d_block_loss_plain(s, t, bw, stride, window, weight) * g).sum()
        grads = torch.autograd.grad(loss, [s, t] if need_target else [s])
    return grads[0], (grads[1] if need_target else None)


_TABLES: Dict[tuple, tuple] = {}


def _rank1_factor(window: np.ndarray):
    """w1 with outer(w1, w1) == window, or None."""
    w = np.asarray(window, np.float64)
    p = int(np.argmax(np.abs(np.diag(w))))
    if w[p, p] <= 0:
        return None
    w1 = w[:, p] / np.sqrt(w[p, p])
    if np.abs(np.outer(w1, w1) - w).max() > 1e-5 * np.abs(w).max():
        return None
    return w1


def mss2d_route(bw: int, stride: int, window: np.ndarray) -> str:
    """The kernel a call on the card takes: "fft" for bw in
    ``KERNEL_WIDTHS``, strides 1 to bw and a window that is a symmetric
    outer product w1 w1^T; "dft" for every other shape."""
    if bw in KERNEL_WIDTHS and 1 <= stride <= bw and _rank1_factor(window) is not None:
        return "fft"
    return "dft"


def _tables(bw: int, route: str, window: np.ndarray, weight: np.ndarray, device) -> tuple:
    """(E, window, weight) on ``device``: the twiddles E[m] =
    e^{-2 pi i m / bw} as interleaved fp32 (bw, 2), built in float64, and
    the window as ``route`` takes it (its 1-D factor, or whole)."""
    key = (bw, route, np.asarray(window, np.float32).tobytes(),
           np.asarray(weight, np.float32).tobytes(), str(device))
    if key not in _TABLES:
        e = np.exp(-2j * np.pi * np.arange(bw) / bw)
        tabs = (np.stack([e.real, e.imag], -1),
                _rank1_factor(window) if route == "fft" else window, weight)
        _TABLES[key] = tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                             for a in tabs)
    return _TABLES[key]


def _check_inputs(sample, target, bw, stride, window, weight) -> str:
    """Checks a call on the card and returns its route (:func:`mss2d_route`)."""
    if stride < 1 or not 1 <= bw <= MAX_BW:
        raise ValueError(f"block width {bw} / stride {stride}: the kernels take bw 1 to "
                         f"{MAX_BW} and strides >= 1")
    if np.shape(window) != (bw, bw) or np.shape(weight) != (bw, bw // 2 + 1):
        raise ValueError(f"window {np.shape(window)} / weight {np.shape(weight)} do not "
                         f"fit block width {bw}")
    check(sample, "sample", (torch.float32,), ndim=3)
    check(target, "target", (torch.float32,), shape=sample.shape)
    return mss2d_route(bw, stride, window)


def mss2d_block_loss(sample: torch.Tensor, target: torch.Tensor, bw: int, stride: int,
                     window: np.ndarray, weight: np.ndarray) -> torch.Tensor:
    """K5: (BC, H, W) x2 fp32, reflect-padded by bw/2 -> (BC,) fp32 sums.
    CPU tensors take the plain version."""
    if on_cpu(sample, target):
        return mss2d_block_loss_plain(sample, target, bw, stride, window, weight)
    route = _check_inputs(sample, target, bw, stride, window, weight)
    bc, h, w, n_rows, n_cols = _grid(sample.shape, bw, stride)
    e, win, wgt = _tables(bw, route, window, weight, sample.device)
    out = torch.empty((bc,), device=sample.device)
    lib = library()
    with torch.cuda.device(sample.device):
        if route == "fft":
            partial = torch.empty((bc, -(-n_cols // MSS2D_PLANS[bw].cols)), device=sample.device)
            err = lib.lib.dd_mss2d_fwd(sample.data_ptr(), target.data_ptr(), bc, h, w, bw,
                                       stride, n_rows, n_cols, e.data_ptr(), win.data_ptr(),
                                       wgt.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                       stream_of(sample))
        else:
            partial = torch.empty((bc, n_rows * n_cols), device=sample.device)
            err = lib.lib.dd_mss2d_dft_fwd(sample.data_ptr(), target.data_ptr(), bc, h, w, bw,
                                           stride, n_rows, n_cols, e.data_ptr(), win.data_ptr(),
                                           wgt.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                           stream_of(sample))
    lib.check(err, f"mss2d_block_loss ({route})")
    mss2d_block_loss.launches += 1
    mss2d_block_loss.routes[route] += 1
    return out


def mss2d_block_loss_grad(sample: torch.Tensor, target: torch.Tensor, g: torch.Tensor, bw: int,
                          stride: int, window: np.ndarray, weight: np.ndarray,
                          need_target: bool = True):
    """K6: the gradient of ``(mss2d_block_loss(sample, target, ...) * g).sum()``
    -> (d_sample, d_target or None), (BC, H, W) fp32. Deterministic. CPU
    tensors take the plain version."""
    if on_cpu(sample, target, g):
        return mss2d_block_loss_grad_plain(sample, target, g, bw, stride, window, weight,
                                           need_target)
    route = _check_inputs(sample, target, bw, stride, window, weight)
    bc, h, w, n_rows, n_cols = _grid(sample.shape, bw, stride)
    check(g, "g", (torch.float32,), shape=(bc,))
    e, win, wgt = _tables(bw, route, window, weight, sample.device)
    n_grad = 2 if need_target else 1
    ds = torch.empty_like(sample)
    dt = torch.empty_like(target) if need_target else None
    lib = library()
    with torch.cuda.device(sample.device):
        if route == "fft":
            q = torch.empty((n_grad, bc, h, n_cols, bw), device=sample.device)   # D_j[y, c]
            err = lib.lib.dd_mss2d_bwd(sample.data_ptr(), target.data_ptr(), g.data_ptr(), bc, h,
                                       w, bw, stride, n_rows, n_cols, n_grad, e.data_ptr(),
                                       win.data_ptr(), wgt.data_ptr(), q.data_ptr(),
                                       ds.data_ptr(), ptr(dt), stream_of(sample))
        else:
            row = n_grad * bc * n_cols * bw * bw          # scratch floats per row of positions
            chunk = max(1, min(n_rows, DFT_SCRATCH_FLOATS // row))
            p = torch.empty((n_grad, bc, chunk, n_cols, bw, bw), device=sample.device)
            err = lib.lib.dd_mss2d_dft_bwd(sample.data_ptr(), target.data_ptr(), g.data_ptr(),
                                           bc, h, w, bw, stride, n_rows, n_cols, n_grad, chunk,
                                           e.data_ptr(), win.data_ptr(), wgt.data_ptr(),
                                           p.data_ptr(), ds.data_ptr(), ptr(dt),
                                           stream_of(sample))
    lib.check(err, f"mss2d_block_loss_grad ({route})")
    mss2d_block_loss_grad.launches += 1
    mss2d_block_loss_grad.routes[route] += 1
    return ds, dt


mss2d_block_loss.launches = 0
mss2d_block_loss_grad.launches = 0
#: launches per route
mss2d_block_loss.routes = {"fft": 0, "dft": 0}
mss2d_block_loss_grad.routes = {"fft": 0, "dft": 0}


class Mss2dBlockLossFn(torch.autograd.Function):
    """``mss2d_block_loss`` with K6 as its backward (the plain versions on
    CPU tensors). dTarget is computed only when target requires grad."""

    @staticmethod
    def forward(ctx, sample, target, bw: int, stride: int, window: np.ndarray,
                weight: np.ndarray):
        ctx.save_for_backward(sample, target)
        ctx.args = (bw, stride, window, weight)
        return mss2d_block_loss(sample, target, bw, stride, window, weight)

    @staticmethod
    def backward(ctx, g):
        sample, target = ctx.saved_tensors
        need_s, need_t = ctx.needs_input_grad[:2]
        ds, dt = mss2d_block_loss_grad(sample, target, g.contiguous(), *ctx.args,
                                       need_target=need_t)
        return (ds if need_s else None), dt, None, None, None, None


def mss2d_loss_fused(sample: torch.Tensor, target: torch.Tensor,
                     block_widths: Tuple[int, ...] = (8, 16, 32, 64), block_overlap: int = 8,
                     use_midside: bool = False) -> torch.Tensor:
    """Multi-scale 2-D MSS over (B, C, H, W) pairs with the flat-top window
    and product frequency weights -> per-sample (B,) losses, the semantics of
    ``training.losses.MSSLoss2D`` (ortho FFT scaling folded into the
    weights; mean over positions, channels and bins). ``use_midside``: the
    "stack" mid/side transform on whole images. Widths in ``KERNEL_WIDTHS``
    take K5/K6; the others (8 and 16 in the defaults) take the unfold +
    rfft2 path, outside any kernel, as in the JAX package."""
    from ...models.mp import midside_transform
    from ...training.losses import _window_2d, product_weights, unfold_2d
    if use_midside:  # MSSLoss2D's "stack": sum/difference without the 1/sqrt2
        sample = midside_transform(sample, 1) * np.sqrt(2.0)
        target = midside_transform(target, 1) * np.sqrt(2.0)
    b, c, h, w = sample.shape
    s = sample.reshape(-1, h, w).float()
    t = target.reshape(-1, h, w).float()
    total = torch.zeros((b,), device=sample.device)
    for bw in block_widths:
        if bw > w:
            continue
        stride = max(bw // block_overlap, 1)
        pad = bw // 2
        win = _window_2d("flat_top", bw)
        weight_o = product_weights(bw) / bw   # the ortho FFT's 1/bw on magnitudes
        if bw not in KERNEL_WIDTHS:
            wt = torch.as_tensor(win, device=sample.device)
            d = (torch.fft.rfft2(unfold_2d(sample, bw, stride) * wt).abs()
                 - torch.fft.rfft2(unfold_2d(target, bw, stride) * wt).abs()).abs()
            total = total + (d * torch.as_tensor(weight_o, device=sample.device)).mean(
                dim=(1, 2, 3, 4, 5))
            continue
        sp = F.pad(s[:, None], (pad, pad, pad, pad), mode="reflect")[:, 0]
        tp = F.pad(t[:, None], (pad, pad, pad, pad), mode="reflect")[:, 0]
        _, _, _, n_rows, n_cols = _grid(sp.shape, bw, stride)
        norm = c * n_rows * n_cols * bw * (bw // 2 + 1)
        per_bc = Mss2dBlockLossFn.apply(sp, tp, bw, stride, win, weight_o)
        total = total + per_bc.reshape(b, c).sum(dim=1) / norm
    return total
