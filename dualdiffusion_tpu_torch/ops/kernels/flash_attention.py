"""K7: online-softmax attention over (B, H, L, D), forward only
(csrc/flash_attention.cu).

Replaces dualdiffusion_tpu/ops/pallas/flash_attention.py (``_attn_kernel``
via ``flash_attention``). The plain version is the fp32 masked softmax of
tests/test_flash_attention.py ``sdpa_ref``, with the kernel's rule that a
row whose keys are all masked emits 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .build import library
from .common import no_tf32, on_cpu, stream_of

#: head widths the kernel is instantiated for
HEAD_DIMS = tuple(range(16, 129, 16))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None, window: Optional[int] = None,
                          causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale, masked) v in fp32 (TF32 off), stored in q's
    dtype; fully masked rows give 0."""
    l, d = q.shape[-2:]
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(d))
    idx = torch.arange(l, device=q.device)
    offset = idx[:, None] - idx[None, :]              # query i - key j
    visible = torch.ones((l, l), dtype=torch.bool, device=q.device)
    if window is not None:
        visible &= offset.abs() <= window
    if causal:
        visible &= offset >= 0
    with no_tf32():
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
        p = p.masked_fill(~visible.any(-1, keepdim=True), 0.0)
        out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it (unit stride along D, 16-byte
    aligned rows and start), else a contiguous copy."""
    step = 16 // t.element_size()
    if t.stride(-1) == 1 and all(s % step == 0 for s in t.stride()[:3]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, window: Optional[int] = None,
                    causal: bool = False) -> torch.Tensor:
    """q/k/v (B, H, L, D) -> (B, H, L, D) in q's dtype. ``window=w`` keeps
    keys with |i - j| <= w, ``causal`` keys with j <= i. CUDA tensors take
    K7 (bf16 on the tensor cores, fp32 with fp32 FMA; D a multiple of 16 up
    to 128); CPU tensors take the plain version. A dense q (such as the
    UNet's transposed (B, L, H, D) views) gives an output with its strides."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, H, L, D) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, h, l, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(d))
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale, window, causal)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v: one dtype of bfloat16 or float32, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not a multiple of 16 in 16..128")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65535")
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    out = torch.empty_like(q)          # q's (dense) strides, so q's layout
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = library()
    with torch.cuda.device(q.device):
        err = lib.lib.dd_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), strides, b, h, l, d, scale,
                                         -1 if window is None else int(window), int(causal),
                                         int(q.dtype == torch.bfloat16), stream_of(q))
    lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
