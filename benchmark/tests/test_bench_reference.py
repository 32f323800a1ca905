"""The plain reference against the port's plain CPU route at a tiny size.

With the port's activations, its DAE and its Griffin-Lim state switched to
float32, a request through ``Pipeline.generate`` and the reference's
stage-by-stage recomputation of it agree to float32 rounding: the reference
is the same math. In the port's own precision (bfloat16) the gaps are those
of bfloat16, about the reference's own in bfloat16 (the numbers, the gaps
over those, near 1), and the control's (float8) are several times larger."""

import copy

import pytest
import torch

from benchmark import common
from benchmark.tests.tiny import tiny_config, tiny_traffic

CELLS = [("ref_scale", "generate_b16"), ("edm2_default", "generate_b1")]


def session(config_name, traffic_name, seed, float32, monkeypatch):
    config = tiny_config(config_name)
    traffic = tiny_traffic(common.traffic_file(traffic_name))
    if float32:
        import dualdiffusion_tpu_torch.models.unet as port_unet
        monkeypatch.setattr(port_unet, "ACT_DTYPE", torch.float32)
        config = copy.deepcopy(config)
        config["dae"]["compute_dtype"] = "float32"
        if "fgla_work_dtype" in config["format"]:
            config["format"]["fgla_work_dtype"] = "float32"
    s = common.entry("generate").Session(config, traffic, seed, "cpu")
    s.window(0.0)
    s.free()
    return s


@pytest.mark.parametrize("config_name, traffic_name", CELLS)
def test_reference_is_the_ports_math_in_float32(config_name, traffic_name, monkeypatch):
    torch.manual_seed(0)
    gaps = session(config_name, traffic_name, 5, True, monkeypatch).check(3)
    last = "audio_sc" if traffic_name == "generate_b16" else "audio"
    assert set(gaps) == {"latents", "mel", last}
    assert max(gaps.values()) < 2e-4, gaps


@pytest.mark.parametrize("config_name, traffic_name", CELLS)
def test_port_in_bfloat16_and_the_control(config_name, traffic_name, monkeypatch):
    s = session(config_name, traffic_name, 6, False, monkeypatch)
    port, control = s.check(4), s.check(4, control=True)
    # each number is the port's gap over the stated precision's own gap
    assert 0.3 < port["latents"] < 3 and 0.3 < port["mel"] < 3, port
    assert all(control[k] > 2 * port[k] for k in ("latents", "mel")), (port, control)
