"""K1: 3x3 stride-1 zero-padded grouped conv, NHWC bf16 (csrc/grouped_conv3x3.cu).

Replaces dualdiffusion_tpu/ops/pallas/grouped_conv.py (``_kernel_v2`` and
``_kernel``, reached through ``grouped_conv2d_3x3_pre``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import library
from .common import check, no_tf32, on_cpu, stream_of


def prepare_weights(w: torch.Tensor, groups: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(G*cog, cig, 3, 3) -> the kernel layout (G, 9*cig, cog), K order
    (dy, dx, cig). Done once per module, not per call."""
    co, cig = w.shape[0], w.shape[1]
    cog = co // groups
    wt = w.reshape(groups, cog, cig, 3, 3).permute(0, 3, 4, 2, 1)
    return wt.reshape(groups, 9 * cig, cog).to(dtype).contiguous()


def grouped_conv3x3_plain(x: torch.Tensor, wt: torch.Tensor,
                          groups: int) -> torch.Tensor:
    """Plain version: F.conv2d(groups=G) in fp32 with TF32 off, output in
    x's dtype. x (B, H, W, G*cig), wt (G, 9*cig, cog)."""
    g, k9, cog = wt.shape
    cig = k9 // 9
    w = wt.float().reshape(g, 3, 3, cig, cog).permute(0, 4, 3, 1, 2)
    w = w.reshape(g * cog, cig, 3, 3)
    with no_tf32():
        y = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1, groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def grouped_conv3x3(x: torch.Tensor, wt: torch.Tensor,
                    groups: int) -> torch.Tensor:
    """NHWC x (B, H, W, G*cig) conv prepared weights wt (G, 9*cig, cog) ->
    (B, H, W, G*cog), fp32 accumulation. CPU tensors take the plain version."""
    if wt.dim() != 3 or wt.shape[0] != groups or wt.shape[1] % 9:
        raise ValueError(f"wt: expected (G={groups}, 9*cig, cog), got {tuple(wt.shape)}")
    b, h, w, c = x.shape
    cig, cog = wt.shape[1] // 9, wt.shape[2]
    if c != groups * cig:
        raise ValueError(f"x has {c} channels, weights expect {groups} x {cig}")
    if on_cpu(x, wt):
        return grouped_conv3x3_plain(x, wt, groups)
    check(x, "x", (torch.bfloat16,), ndim=4)
    check(wt, "wt", (torch.bfloat16,))
    out = torch.empty((b, h, w, groups * cog), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.lib.dd_grouped_conv3x3(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                         b, h, w, groups, cig, cog, stream_of(x))
    lib.check(err, "grouped_conv3x3")
    grouped_conv3x3.launches += 1
    return out


grouped_conv3x3.launches = 0
