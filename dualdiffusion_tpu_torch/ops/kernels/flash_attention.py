"""K7: online-softmax attention over (B, H, L, D), forward only
(csrc/flash_attention.cu up to D 256, csrc/flash_attention_wide.cu above).

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

#: the widest head of csrc/flash_attention.cu's kernels; wider heads take
#: the D-chunked kernel of csrc/flash_attention_wide.cu
MAX_TILE_HEAD_DIM = 256


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


def _strides(t: torch.Tensor) -> tuple:
    """The (b, h, l) element strides, with a size-1 dim's (arbitrary in
    torch) replaced by its contiguous one."""
    st, n = t.stride(), t.shape
    if n[0] > 1 and n[1] > 1 and n[2] > 1:
        return st[:3]
    dense = (n[1] * n[2] * n[3], n[2] * n[3], n[3])
    return tuple(st[i] if n[i] > 1 else dense[i] for i in range(3))


def _kernel_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v as the kernel reads them: each tensor itself where TMA can
    (unit stride along D, D a multiple of 8, 16-byte aligned start and
    (b, h, l) strides), else a contiguous copy; when D is not a multiple of
    8, copies of all three zero-padded to the next multiple."""
    d = q.shape[-1]
    if d % 8:
        padded = [t.new_zeros(t.shape[:-1] + (d + 8 - d % 8,)) for t in (q, k, v)]
        for dst, src in zip(padded, (q, k, v)):
            dst[..., :d] = src
        return padded
    step = 16 // q.element_size()

    def readable(t):
        sb, sh, sl = _strides(t)
        return (t.stride(3) == 1 and sb % step == 0 and sh % step == 0 and sl % step == 0
                and min(sb, sh, sl) > 0 and t.data_ptr() % 16 == 0)
    return [t if readable(t) else t.clone(memory_format=torch.contiguous_format)
            for t in (q, k, v)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, window: Optional[int] = None,
                    causal: bool = False) -> torch.Tensor:
    """q/k/v (B, H, L, D) -> (B, H, L, D) in q's dtype. ``window=w`` keeps
    keys with |i - j| <= w, ``causal`` keys with j <= i. CUDA tensors take
    K7 (bf16 on the tensor cores and fp32 with fp32 FMA up to D 256, both
    with FMA on a D-chunked kernel above; any B * H); CPU tensors take the
    plain version. A dense q (such as the UNet's transposed
    (B, L, H, D) views) gives an output with its strides; a D that is not a
    multiple of 8 gives a view of a padded output."""
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
    if scale < 0:        # the bf16 kernel scales inside its exponent, which needs scale >= 0
        q, scale = -q, -scale
    q, k, v = _kernel_views(q, k, v)
    out = torch.empty_like(q)          # q's (dense) strides, so q's layout
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in _strides(t)))
    lib = library()
    fn = (lib.lib.dd_flash_attention if q.shape[-1] <= MAX_TILE_HEAD_DIM
          else lib.lib.dd_flash_attention_wide)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, l,
                 q.shape[-1], scale, -1 if window is None else int(window), int(causal),
                 int(q.dtype == torch.bfloat16), stream_of(q))
    lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out if out.shape[-1] == d else out[..., :d]


flash_attention.launches = 0
