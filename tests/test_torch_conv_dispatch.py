"""Which CUDA kernel K1 (forward and dgrad) and K4 take, decided on the CPU.

``hopper_takes`` sends channel counts that are multiples of 8 on 16-byte
aligned tensors to the Hopper kernels (wgmma fed by TMA, whose boxes need
16-byte strides and bases), and every other shape to the WMMA kernels. The
reference-scale UNet's grouped convs (``chip_smoke.grouped_conv_shapes``,
built on the meta device) must all take the Hopper kernels.
"""

import pytest
import torch

import chip_smoke
from dualdiffusion_tpu_torch.models import UNet
from dualdiffusion_tpu_torch.ops.kernels import hopper_takes


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _takes(cig, cog, *tensors):
    return hopper_takes(cig, cog, *(t.data_ptr() for t in tensors))


def _operands(b, h, w, groups, cig, cog, offset=0):
    """x, prepared weights, gy and the output as K1 and K4 get them, on the
    CPU; ``offset`` elements shift x off its allocation's start."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="cpu")
    x = t(b * h * w * groups * cig + offset)[offset:].view(b, h, w, groups * cig)
    return x, t(groups, 9 * cig, cog), t(b, h, w, groups * cog), t(b, h, w, groups * cog)


@pytest.mark.parametrize("batch", [2, 8])
def test_main_path_shapes_take_the_hopper_kernels(batch):
    ucfg = chip_smoke.ref_scale_configs()[0]
    unet = UNet(ucfg, device="meta")
    shapes = chip_smoke.grouped_conv_shapes(unet, batch, 32, 688)
    assert len(shapes) == 68 and len(set(shapes)) == 39
    groups = ucfg.mlp_groups
    for b, h, w, cin, cout in set(shapes):
        cig, cog = cin // groups, cout // groups
        x, wt, gy, out = _operands(1, 1, 2, groups, cig, cog)
        assert _takes(cig, cog, x, wt, out)               # forward
        assert _takes(cog, cig, gy, wt, x)                # dgrad: K1 on rotated weights
        assert _takes(cig, cog, x, gy)                    # K4


@pytest.mark.parametrize("b,h,w,groups,cig,cog", [(2, 4, 70, 4, 12, 20), (1, 3, 5, 2, 8, 4),
                                                  (2, 3, 9, 1, 40, 6)])
def test_odd_channel_counts_take_the_wmma_kernels(b, h, w, groups, cig, cog):
    x, wt, gy, out = _operands(b, h, w, groups, cig, cog)
    assert not _takes(cig, cog, x, wt, out)
    assert not _takes(cig, cog, x, gy)


def test_unaligned_tensors_take_the_wmma_kernels():
    """A 2-byte offset breaks TMA's 16-byte base rule; 8 elements keep it."""
    for offset, want in ((1, False), (8, True)):
        x, wt, gy, out = _operands(1, 2, 8, 2, 16, 32, offset=offset)
        assert _takes(16, 32, x, wt, out) is want
        assert _takes(16, 32, x, gy) is want
