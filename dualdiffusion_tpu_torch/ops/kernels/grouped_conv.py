"""K1: 3x3 stride-1 zero-padded grouped conv, NHWC bf16, and its backward:
dgrad through K1 on rotated weights, wgrad through K4. Each has two CUDA
kernels: the Hopper one (wgmma fed by TMA: csrc/grouped_conv3x3_hopper.cu,
csrc/grouped_conv3x3_wgrad_hopper.cu) for channel counts that are multiples
of 8 on 16-byte aligned tensors (TMA's rules: ``hopper_takes``), and the
WMMA one (csrc/grouped_conv3x3.cu, csrc/grouped_conv3x3_wgrad.cu) for the
other shapes.

Replaces dualdiffusion_tpu/ops/pallas/grouped_conv.py (``_kernel_v2`` and
``_kernel``, reached through ``grouped_conv2d_3x3_pre``, and the custom VJP's
``_vjp_bwd``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import library
from .common import check, no_tf32, on_cpu, stream_of

#: input channels per K4 block: the WMMA kernel's kKC, the Hopper kernel's kMC
_WGRAD_KC = {False: 32, True: 64}
#: K4 blocks to aim for, in waves of the card's SMs: the WMMA kernel fits
#: several blocks on an SM, the Hopper kernel one
_WGRAD_WAVES = {False: 4, True: 2}


def hopper_takes(cig: int, cog: int, *ptrs: int) -> bool:
    """Whether K1 and K4 take their Hopper kernels, given the channel counts
    and the operands' data pointers: TMA needs channel counts that are
    multiples of 8 (16-byte strides) and 16-byte aligned tensors."""
    bits = 0
    for p in ptrs:
        bits |= p
    return cig % 8 == 0 and cog % 8 == 0 and bits % 16 == 0


def prepare_weights(w: torch.Tensor, groups: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(G*cog, cig, 3, 3) -> the kernel layout (G, 9*cig, cog), K order
    (dy, dx, cig). Done once per module, not per call."""
    co, cig = w.shape[0], w.shape[1]
    cog = co // groups
    wt = w.reshape(groups, cog, cig, 3, 3).permute(0, 3, 4, 2, 1)
    return wt.reshape(groups, 9 * cig, cog).to(dtype).contiguous()


def dgrad_weights(wt: torch.Tensor) -> torch.Tensor:
    """Kernel-layout weights (G, 9*cig, cog) -> the weights whose conv of the
    output gradient is the input gradient: (G, 9*cog, cig), io-swapped and
    taps reversed, (dy, dx) -> (2-dy, 2-dx) (JAX ``_dgrad_weights``)."""
    g, k9, cog = wt.shape
    cig = k9 // 9
    wd = wt.reshape(g, 9, cig, cog).flip(1).transpose(2, 3)
    return wd.reshape(g, 9 * cog, cig).contiguous()


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
    px, pw, po = x.data_ptr(), wt.data_ptr(), out.data_ptr()
    fn = (lib.lib.dd_grouped_conv3x3_hopper if hopper_takes(cig, cog, px, pw, po)
          else lib.lib.dd_grouped_conv3x3)
    with torch.cuda.device(x.device):
        err = fn(px, pw, po, b, h, w, groups, cig, cog, stream_of(x))
    lib.check(err, "grouped_conv3x3")
    grouped_conv3x3.launches += 1
    return out


grouped_conv3x3.launches = 0


def grouped_conv3x3_wgrad_plain(x: torch.Tensor, gy: torch.Tensor,
                                groups: int) -> torch.Tensor:
    """Plain version of K4: the exact 9-tap reduction of JAX ``_wgrad`` in
    fp32 (TF32 off), in the kernel layout (G, 9*cig, cog), result in x's dtype:
    dW[g, (dy*3+dx)*cig + i, o] = sum_{b,h,w} x_pad[b, h+dy, w+dx, g*cig+i]
    * gy[b, h, w, g*cog+o]."""
    b, h, w, c = x.shape
    cig, cog = c // groups, gy.shape[-1] // groups
    xg = F.pad(x.float(), (0, 0, 1, 1, 1, 1)).reshape(b, h + 2, w + 2, groups, cig)
    gyg = gy.float().reshape(b, h, w, groups, cog)
    with no_tf32():
        taps = [torch.einsum("bhwgi,bhwgo->gio", xg[:, dy:dy + h, dx:dx + w], gyg)
                for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=1).reshape(groups, 9 * cig, cog).to(x.dtype)


def _wgrad_splits(device: torch.device, bh: int, groups: int, cig: int, cog: int,
                  hopper: bool) -> int:
    """How many blocks share one output tile's sum over the B*H rows: enough
    for a few waves of the card's SMs, every split keeping at least one row."""
    bn = 64 if cog % 64 == 0 else 32
    tiles = groups * -(-cig // _WGRAD_KC[hopper]) * -(-cog // bn)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nsplit = max(1, min(bh, -(-_WGRAD_WAVES[hopper] * sms // tiles)))
    rows = -(-bh // nsplit)
    return -(-bh // rows)


def grouped_conv3x3_wgrad(x: torch.Tensor, gy: torch.Tensor,
                          groups: int) -> torch.Tensor:
    """The weight gradient of K1 in its weight layout: x (B, H, W, G*cig) and
    the output gradient gy (B, H, W, G*cog) -> (G, 9*cig, cog) in x's dtype,
    fp32 accumulation. CPU tensors take the plain version."""
    if x.dim() != 4 or gy.dim() != 4 or x.shape[:3] != gy.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)} and gy {tuple(gy.shape)} must share (B, H, W)")
    b, h, w, c = x.shape
    if c % groups or gy.shape[-1] % groups:
        raise ValueError(f"channels {c} -> {gy.shape[-1]} do not split into {groups} groups")
    cig, cog = c // groups, gy.shape[-1] // groups
    if on_cpu(x, gy):
        return grouped_conv3x3_wgrad_plain(x, gy, groups)
    check(x, "x", (torch.bfloat16,), ndim=4)
    check(gy, "gy", (torch.bfloat16,), ndim=4)
    hopper = hopper_takes(cig, cog, x.data_ptr(), gy.data_ptr())
    nsplit = _wgrad_splits(x.device, b * h, groups, cig, cog, hopper)
    partial = torch.empty((nsplit, groups, 9 * cig, cog), dtype=torch.float32, device=x.device)
    out = torch.empty((groups, 9 * cig, cog), dtype=x.dtype, device=x.device)
    lib = library()
    fn = (lib.lib.dd_grouped_conv3x3_wgrad_hopper if hopper
          else lib.lib.dd_grouped_conv3x3_wgrad)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), gy.data_ptr(), partial.data_ptr(), out.data_ptr(), b, h, w,
                 groups, cig, cog, nsplit, stream_of(x))
    lib.check(err, "grouped_conv3x3_wgrad")
    grouped_conv3x3_wgrad.launches += 1
    return out


grouped_conv3x3_wgrad.launches = 0


class GroupedConv3x3Fn(torch.autograd.Function):
    """K1 with its backward (JAX ``grouped_conv2d_3x3``'s custom VJP):
    x (B, H, W, G*cig) and prepared weights wt (G, 9*cig, cog), both in x's
    dtype. dgrad is K1 on ``dgrad_weights(wt)``; wgrad is K4. Every call
    takes the kernels on CUDA tensors and the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wt: torch.Tensor, groups: int) -> torch.Tensor:
        ctx.groups = groups
        ctx.save_for_backward(x, wt)
        return grouped_conv3x3(x, wt, groups)

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        x, wt = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = grouped_conv3x3(gy, dgrad_weights(wt), ctx.groups)
        if ctx.needs_input_grad[1]:
            gw = grouped_conv3x3_wgrad(x, gy, ctx.groups).to(wt.dtype)
        return gx, gw, None
