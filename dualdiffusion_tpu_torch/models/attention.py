"""Attention utilities: partial RoPE and (sliding-window) scaled dot-product
attention (JAX: dualdiffusion_tpu/models/attention.py; reference:
src/modules/rope.py:26-101, src/modules/sliding_attention.py:31-127).

``scaled_dot_product_attention`` takes the einsum + fp32 softmax route below
``FLASH_MIN_SEQ``, on the CPU and under ``training=True``, and the flash
kernel K7 (ops/kernels/flash_attention.py) for long sequences on the card,
as the JAX package takes its Pallas kernel on a TPU.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import flash_attention

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def build_rope_tables(length: int, rope_ch: int, base: float = 10000.0,
                      scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables of shape (length, rope_ch//2), float32 host constants
    (reference: rope.py:48-62)."""
    assert rope_ch % 2 == 0, "rope_ch must be even"
    if rope_ch == 0:
        return (np.zeros((length, 0), np.float32),) * 2
    inv_freq = 1.0 / (base ** (np.arange(0, rope_ch, 2, dtype=np.float64) / rope_ch))
    pos = np.arange(length, dtype=np.float64) * scale
    ang = np.outer(pos, inv_freq)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope_rotate_partial(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2*cos.shape[-1] channels of x pairwise
    (reference: rope.py:26-46). x: (..., L, D); cos/sin broadcastable to
    (..., L, rope_ch//2). Output layout groups rotated evens then odds then
    the tail, matching the reference."""
    rope_ch = cos.shape[-1] * 2
    x_rot = x[..., :rope_ch]
    x_even = x_rot[..., 0::2]
    x_odd = x_rot[..., 1::2]
    r_even = x_even * cos - x_odd * sin
    r_odd = x_odd * cos + x_even * sin
    return torch.cat([r_even, r_odd, x[..., rope_ch:]], dim=-1)


def rope_self_test(n: int = 31, t0: Optional[int] = None, rope_ch: int = 2) -> bool:
    """Same-sign RoPE sanity check (reference: rope.py:81-101): with Q
    holding [1,0] only at t0 and K holding [1,0] everywhere (pre-rotation),
    attention from t0 must peak at t0."""
    t0 = t0 if t0 is not None else n // 4
    d = n
    cos, sin = (torch.from_numpy(t) for t in build_rope_tables(n, rope_ch))
    q = torch.zeros((1, 1, n, d))
    q[0, 0, t0, 0] = 1.0
    k = torch.zeros((1, 1, n, d))
    k[:, :, :, 0] = 1.0
    v = torch.eye(n, d)[None, None]
    qr = rope_rotate_partial(q, cos, sin)
    kr = rope_rotate_partial(k, cos, sin)
    logits = torch.einsum("bhqd,bhkd->bhqk", qr, kr) / np.sqrt(d)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    return int(torch.argmax(out[0, 0, t0])) == t0


# ---------------------------------------------------------------------------
# (sliding-window) attention
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _band_mask(seq_len: int, window: int, causal: bool) -> np.ndarray:
    q = np.arange(seq_len)[:, None]
    k = np.arange(seq_len)[None, :]
    if causal:
        return (q >= k) & (q - k <= window)
    return np.abs(q - k) <= window


#: flash kernel dispatch threshold, the JAX package's, so both packages take
#: the same route at the same L; the H100's crossover between K7 and the
#: einsum route is measured by chip_smoke.py and written in PERF.md
FLASH_MIN_SEQ = 2048


def _use_flash(seq_len: int, device: torch.device) -> bool:
    return seq_len >= FLASH_MIN_SEQ and device.type == "cuda"


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     window: Optional[int] = None, causal: bool = False) -> torch.Tensor:
    """The einsum + fp32 softmax route (JAX attention.py:104-114): logits in
    the inputs' dtype, probabilities rounded back to it."""
    l = q.shape[-2]
    if window is not None:
        mask = torch.from_numpy(_band_mask(l, window, causal)).to(q.device)
    elif causal:
        mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    else:
        mask = None
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None, causal: bool = False,
                                 training: bool = False) -> torch.Tensor:
    """SDPA with automatic route choice. q/k/v: (B, H, L, D) -> (B, H, L, D).

    Sequences of at least ``FLASH_MIN_SEQ`` on the card take K7 (online
    softmax, O(L*window) for bands); shorter ones, CPU tensors and
    ``training=True`` take the einsum route: K7 has no backward, as the
    JAX package's Pallas kernel has no VJP.
    """
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
    if _use_flash(q.shape[-2], q.device) and not training:
        return flash_attention(q, k, v, scale=scale, window=window, causal=causal)
    return einsum_attention(q, k, v, scale, window, causal)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             window_size: int, causal: bool = False,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Banded SDPA. q/k/v: (B, H, L, D) -> (B, H, L, D)."""
    return scaled_dot_product_attention(q, k, v, scale=scale, window=window_size,
                                        causal=causal)
