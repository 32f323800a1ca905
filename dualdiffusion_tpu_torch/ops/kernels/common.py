"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import contextlib

import torch


class FallbackRoute:
    """``with <instance>():`` makes a wrapper take its fallback kernel at
    every shape, so its routes can be compared on one shape; the wrapper
    reads ``active`` when it plans a call."""

    def __init__(self):
        self.active = False

    @contextlib.contextmanager
    def __call__(self):
        prev, self.active = self.active, True
        try:
            yield
        finally:
            self.active = prev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when every tensor lies on one CUDA device (the kernel runs)."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check(t: torch.Tensor, name: str, dtypes, ndim=None, shape=None) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


@contextlib.contextmanager
def no_tf32():
    """Full fp32 convolutions and matmuls inside (cuDNN defaults to TF32)."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
