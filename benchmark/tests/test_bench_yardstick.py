"""The frozen counts against the figures they were taken from, and the
trace reduction on made-up events."""

import pytest

from benchmark.common import HERE, load_json
from benchmark.yardstick import peaks, trace, work

REF = load_json(HERE / "configs" / "ref_scale.json")
EDM = load_json(HERE / "configs" / "edm2_default.json")
LAT_H, LAT_W = 32, 688          # 45 s latents of both configurations


def test_k1_forward_at_batch_2_is_723_gflop():
    k = work.k1_work(REF["unet"], 2, LAT_H, LAT_W)
    assert len(work.grouped_conv_shapes(REF["unet"], 2, LAT_H, LAT_W)) == 68
    assert k["flops"] / 1e9 == pytest.approx(723.2, abs=0.05)
    assert peaks.bound_s(k["flops"], k["bytes"], "bf16") * 1e3 == pytest.approx(0.731, abs=5e-4)


def test_k4_backward_at_batch_8_is_2893_gflop():
    # the weight gradient of every grouped conv: the forward's products at batch 8
    assert work.k1_work(REF["unet"], 8, LAT_H, LAT_W)["flops"] / 1e9 == \
        pytest.approx(2892.9, abs=0.05)


def test_k2_and_k3_bytes_a_call():
    # one 45 s stereo Griffin-Lim iteration: B 1, C 2, F 5504, n_fft 6400, bf16
    assert work.k2_work(2, 5504, 6400, 2)["bytes"] / 1e6 == pytest.approx(704.6, abs=0.05)
    assert work.k3_work(2, 5504, 6400, 256, 2)["bytes"] / 1e6 == pytest.approx(287.5, abs=0.05)


def test_dense_unet_takes_no_k1():
    assert work.grouped_conv_shapes(EDM["unet"], 2, LAT_H, LAT_W) == []


@pytest.mark.parametrize("name, cfg, h, w", [("ref_scale unet", REF["unet"], LAT_H, LAT_W),
                                             ("edm2 unet", EDM["unet"], LAT_H, LAT_W),
                                             ("edm2 ddec", EDM["ddec"], 256, 5504)])
def test_unet_flops_match_the_ports_count(name, cfg, h, w):
    from dualdiffusion_tpu_torch.models import UNetConfig
    from dualdiffusion_tpu_torch.utils import config_from_dict
    from dualdiffusion_tpu_torch.utils.perf import unet_fwd_flops
    assert work.unet_fwd_flops(cfg, 2, h, w) == pytest.approx(
        unet_fwd_flops(config_from_dict(UNetConfig, cfg), 2, h, w), rel=1e-12)


def test_dae_decode_flops_count_every_conv():
    # a 1-level DAE: latents-in 3x3, one block (two 3x3 convs, no skip), out 5x5
    cfg = dict(EDM["dae"], channel_mult_dec=[1], channel_mult_enc=[1], model_channels=4,
               num_dec_layers_per_block=0, latent_channels=2, mlp_multiplier=2, out_channels=2)
    want = 2 * 3 * 5 * (2 * 4 * 9 + 4 * 8 * 9 + 8 * 4 * 9 + 4 * 2 * 25)
    assert work.dae_decode_flops(cfg, 3, 5, 1) == want


def test_busy_time_is_the_union_of_operations():
    ops = [("a", 0, 10), ("b", 5, 12), ("c", 20, 30), ("d", 22, 25)]
    assert trace.busy_us(ops) == 22
    assert trace.matching_us(ops, ("a", "d")) == 13


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    device = [("k1", 0, 10), ("k2", 110, 120), ("k3", 125, 130)]
    host = [("outer", 0, 200), ("inner", 40, 90), ("other", 95, 100)]
    assert trace.idle_gaps(device, host) == {"inner": 100 / 1e6}
    out = trace.breakdown([{"device": device, "host": host}])
    assert out["device_ops"][0] == ["k1", 10 / 1e6]
    assert out["idle_gaps"] == [["inner", 100 / 1e6]]
