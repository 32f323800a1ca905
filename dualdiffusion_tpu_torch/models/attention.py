"""Scaled dot-product attention, the einsum + softmax path of
dualdiffusion_tpu/models/attention.py:84-114.

The UNet attends over the freq axis, where the sequence is at most a few
dozen positions at the configurations the port serves; the JAX package
also takes this path there (its flash kernel starts at L >= 2048).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: (B, H, L, D) -> (B, H, L, D); softmax in fp32."""
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)
