"""The benchmark's readers of the program's spans (``benchmark/yardstick/
spans.py`` and the metrics that use it) on made-up traced parts with known
gaps, and on the spans of a tiny profiled sampler run of the port."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402
from benchmark.yardstick import spans  # noqa: E402
from benchmark.yardstick.readers import idle_pct  # noqa: E402
from benchmark.yardstick.trace import split_events  # noqa: E402

LAYERS = ("sampler", "model", "pipeline")
NEW = ["idle_sampler_pct.serve", "idle_model_pct.serve", "idle_pipeline_pct.serve",
       "weight_preps_per_forward.serve", "forward_host_ms.serve"]


def read(name: str, run: dict):
    return common.metric_reader(name)(run)


def steps_part(weight: float = 50.0) -> dict:
    """A sampler part of one step and one forward: the device idle 10 us in
    the step's own code, 20 us in a block, 5 us in a weight prep, 40 us in
    the forward between blocks, 7 us where no span is open; 100 us of wall
    time. Host operations that are not spans (``aten::``) never decide."""
    host = [("dd.sampler.step", 0, 85), ("dd.model.forward", 12, 80),
            ("dd.model.block", 14, 40), ("aten::mm", 15, 39),
            ("dd.model.weight_prep", 16, 22), ("dd.model.block", 70, 79),
            ("dd.model.block", 81, 82)]
    device = [("k0", 0, 1), ("k1", 11, 14), ("k2", 17, 19), ("k3", 19, 20),
              ("k4", 40, 41), ("k5", 81, 83), ("k6", 92, 100)]
    # gaps: 1-11 step (10), 14-17 prep (3), 20-40 block (20), 41-81 forward (40),
    # 83-92 none (9)
    return {"name": "unet_steps", "weight": weight, "wall_s": 100e-6, "host": host,
            "device": device, "work": {}}


def decode_part() -> dict:
    host = [("dd.model.forward", 0, 30), ("dd.model.weight_prep", 1, 3),
            ("dd.pipeline.fgla", 30, 60), ("aten::add", 31, 59)]
    device = [("k", 0, 2), ("k", 5, 30), ("k", 35, 60)]
    # gaps: 2-5 prep (3), 30-35 fgla (5)
    return {"name": "decode", "weight": 1.0, "wall_s": 60e-6, "host": host, "device": device,
            "work": {}}


def test_each_gap_goes_to_the_innermost_span_at_its_middle():
    us = 1e-6
    assert spans.idle_by_layer(steps_part()) == pytest.approx(
        {"sampler": 10 * us, "model": 63 * us, None: 9 * us})
    assert spans.idle_by_layer(decode_part()) == pytest.approx({"model": 3 * us,
                                                                "pipeline": 5 * us})


def test_idle_shares_weight_the_parts_and_stay_within_idle_pct():
    run = {"parts": [steps_part(50.0), decode_part()]}
    wall = 50 * 100 + 60
    want = {"sampler": 50 * 10 / wall, "model": (50 * 63 + 3) / wall, "pipeline": 5 / wall}
    got = {layer: read(f"idle_{layer}_pct.serve", run) for layer in LAYERS}
    assert got == pytest.approx({k: 100 * v for k, v in want.items()})
    assert sum(got.values()) <= idle_pct(run)
    assert idle_pct(run) == pytest.approx(100 * (50 * (10 + 3 + 20 + 40 + 9) + 8) / wall)


def test_every_gap_counts_however_short():
    part = dict(steps_part(), device=[("k", 0, 16.5), ("k", 16.6, 100)])
    assert spans.idle_by_layer(part) == {"model": pytest.approx(0.1e-6)}


def test_span_counts_and_host_time_of_the_sampler_parts():
    a, b = steps_part(50.0), dict(steps_part(25.0), name="ddec_steps")
    b["host"] = b["host"] + [("dd.model.forward", 200, 230), ("dd.model.weight_prep", 201, 202),
                             ("dd.model.weight_prep", 203, 204)]
    run = {"parts": [a, b, decode_part()]}
    # the decode part's forward and prep are not the sampler's
    assert read("weight_preps_per_forward.serve", run) == pytest.approx(
        (50 * 1 + 25 * 3) / (50 * 1 + 25 * 2))
    assert read("forward_host_ms.serve", run) == pytest.approx(
        (50 * 68 + 25 * (68 + 30)) / (50 * 1 + 25 * 2) / 1e3)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_spans(name):
    """A program without spans (a parent commit's) leaves every reader
    empty-handed, as does a run without traced parts."""
    parts = []
    for p in (steps_part(), decode_part()):
        parts.append(dict(p, host=[h for h in p["host"] if not h[0].startswith("dd.")]))
    assert read(name, {"parts": parts}) is None
    assert read(name, {"parts": []}) is None


def test_the_readers_see_the_ports_spans():
    """A tiny latent sampler of the port, its second step profiled from a
    chunk callback as the benchmark profiles its steps: the weight preps a
    forward are the UNet's layers outside K1, and each forward took host
    time."""
    from dualdiffusion_tpu_torch.models.layers import MPConv
    from dualdiffusion_tpu_torch.sampling import SampleParams
    from test_torch_trace import request, tiny_pipeline
    torch.set_num_threads(1)
    pipe = tiny_pipeline("fgla")
    request(pipe)                          # K1's weights cached, as after the warm-up
    prof = profile(activities=[ProfilerActivity.CPU])

    def callback(done, _sample):
        (prof.start if done == 1 else prof.stop)()
        return False
    shape = pipe.modules["dae"].module.get_latent_shape(pipe.format.get_sample_shape(1))
    emb = torch.randn((1, 1024), generator=torch.Generator().manual_seed(3))
    pipe.diffusion_decode(SampleParams(steps=2), shape, emb, torch.Generator().manual_seed(1),
                          chunk_size=1, chunk_callback=callback)
    device, host = split_events(prof)
    run = {"parts": [{"name": "unet_steps", "weight": 50.0, "wall_s": 1.0, "host": host,
                      "device": device, "work": {}}]}
    convs = [m for m in pipe.modules["unet"].module.core.modules() if isinstance(m, MPConv)]
    k1 = [m for m in convs if m.groups > 1 and m.kernel == (3, 3)]
    assert k1 and read("weight_preps_per_forward.serve", run) == len(convs) - len(k1)
    assert spans.sampler_spans(run, "dd.model.forward")[0] == 50.0 * 2
    assert read("forward_host_ms.serve", run) > 0
    assert read("idle_model_pct.serve", run) is None      # no device operation on the CPU
