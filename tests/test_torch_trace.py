"""The port's spans (``utils/trace.py``) under ``torch.profiler``: one tiny
``Pipeline.generate`` on each decode path (Griffin-Lim on a spectrogram
pipeline, the DDEC on an MS-MDCT dual one) records every ``dd.`` span as a
host CPU operation, never a user annotation, nested in its caller's, as
often as the request runs it. Also the ``timings`` keys of ``generate``
and the CFG embedding of one prompt at batch 2.

The file imports no JAX. The ``cuda`` test holds the same profile on the
card: no ``dd.`` name among the device's events.

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
from dualdiffusion_tpu_torch.models.formats import (MSMDCTDualFormat, MSMDCTDualFormatConfig,
                                                    SpectrogramFormat, SpectrogramFormatConfig)
from dualdiffusion_tpu_torch.models.layers import MPConv
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
from dualdiffusion_tpu_torch.sampling import SampleParams

UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
# a 64-frame, 64-bin mel spectrogram (tests/test_torch_pipeline.py)
SPEC_KW = dict(window_duration_ms=40, padded_duration_ms=40, num_frequencies=64,
               default_raw_length=63 * 256)
# the tiny DDEC and MS-MDCT dual format of tests/test_torch_ddec.py
DDEC_KW = dict(in_channels=2, out_channels=2, in_channels_emb=0, in_num_freqs=32,
               in_psd_freqs=128, sigma_max=20.0, sigma_min=3e-5, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, mlp_multiplier=2,
               logvar_channels=32, double_midblock=True, add_constant_channel=True)
MS_KW = dict(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
             default_raw_length=63 * 32)
STEPS, FGLA_ITERS = 2, 2
#: the spans a request opens on each decode path
SPANS = {"fgla": {"dd.pipeline.generate", "dd.sampler.run", "dd.sampler.step",
                  "dd.model.forward", "dd.model.precondition", "dd.model.block",
                  "dd.model.weight_prep", "dd.pipeline.fgla"},
         "ddec": {"dd.pipeline.generate", "dd.sampler.run", "dd.sampler.step",
                  "dd.model.forward", "dd.model.precondition", "dd.model.block",
                  "dd.model.weight_prep", "dd.pipeline.mel_to_linear", "dd.pipeline.imdct"}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny_pipeline(decode: str, device="cpu") -> Pipeline:
    """A seeded tiny pipeline whose gains are 1 (zero gains would switch
    branches off)."""
    gen = torch.Generator().manual_seed(5)
    models = {"unet": UNet(UNetConfig(**UNET_KW)),
              "dae": DAE(DAEConfig(**DAE_KW))}
    if decode == "ddec":
        models["ddec"] = UNet(UNetConfig(**DDEC_KW))
        fcfg = MSMDCTDualFormatConfig(**MS_KW)
        fmt = ModuleHandle("format", "format:ms_mdct_dual", fcfg, MSMDCTDualFormat(fcfg))
    else:
        fcfg = SpectrogramFormatConfig(**SPEC_KW)
        fmt = ModuleHandle("format", "format:spectrogram", fcfg, SpectrogramFormat(fcfg))
    modules = {"format": fmt}
    for name, m in models.items():
        m.init_weights(gen)
        with torch.no_grad():
            for p in m.parameters():
                if p.dim() == 0:
                    p.fill_(1.0)
        modules[name] = ModuleHandle(name, name, m.cfg, m.to(device).eval())
    return Pipeline(modules)


def request(pipe: Pipeline, batch: int = 1, emb=None, **kw):
    device = next(pipe.modules["unet"].module.parameters()).device
    if emb is None:
        emb = torch.randn((1, 1024), generator=torch.Generator().manual_seed(3)).to(device)
    params = SampleParams(steps=STEPS, batch_size=batch, num_fgla_iters=FGLA_ITERS)
    gen = torch.Generator(device=device).manual_seed(7)
    return pipe.generate(params, gen, prompt_embedding=emb, **kw)


def profiled(pipe: Pipeline, activities=(ProfilerActivity.CPU,)):
    """The ``dd.`` events of a profiled request, after one that warms K1's
    weight cache."""
    request(pipe)
    with profile(activities=list(activities)) as prof:
        request(pipe)
    return prof, [e for e in prof.events() if e.name.startswith("dd.")]


def tree(spans):
    """(span, parent) for each span: its innermost enclosing span in time,
    None for a root. Fails where two spans overlap without nesting."""
    out, stack = [], []
    for e in sorted(spans, key=lambda e: (e.time_range.start, -e.time_range.end)):
        while stack and stack[-1].time_range.end <= e.time_range.start:
            stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            assert parent.time_range.end >= e.time_range.end, (parent.name, e.name)
        out.append((e, parent))
        stack.append(e)
    return out


def rescaled_per_forward(pipe: Pipeline, run) -> list:
    """For each model forward that ``run`` makes (the UNets' and the DAE
    decode), in order: its ``MPConv`` calls that take no K1 weight, every
    call that is not a grouped 3x3 conv on a 2-D input."""
    counts = []

    def conv_hook(m, args):
        if counts and not m._uses_kernel(args[0], m.groups):
            counts[-1] += 1
    hooks = []
    for name in ("unet", "dae", "ddec"):
        if name not in pipe.modules:
            continue
        module = pipe.modules[name].module
        hooks += [m.register_forward_pre_hook(conv_hook) for m in module.modules()
                  if isinstance(m, MPConv)]
        if isinstance(module, UNet):
            hooks.append(module.core.register_forward_pre_hook(lambda *_: counts.append(0)))
    dae = pipe.modules["dae"].module
    decode = dae.decode

    def counted_decode(*args, **kw):
        counts.append(0)
        return decode(*args, **kw)
    dae.decode = counted_decode
    try:
        run()
    finally:
        del dae.decode
        for h in hooks:
            h.remove()
    return counts


@pytest.mark.parametrize("decode", ["fgla", "ddec"])
def test_every_span_is_a_nested_host_operation(decode):
    _, spans = profiled(tiny_pipeline(decode))
    assert {e.name for e in spans} == SPANS[decode]
    for e in spans:
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation, e.name
    parents = {e.name: set() for e in spans}
    for e, parent in tree(spans):
        parents[e.name].add(parent.name if parent is not None else None)
    assert parents["dd.pipeline.generate"] == {None}
    assert parents["dd.sampler.run"] == {"dd.pipeline.generate"}
    assert parents["dd.sampler.step"] == {"dd.sampler.run"}
    # the UNets' forwards inside the steps; the DAE decode in the request itself
    assert parents["dd.model.forward"] == {"dd.sampler.step", "dd.pipeline.generate"}
    assert parents["dd.model.precondition"] == {"dd.model.forward"}
    assert parents["dd.model.block"] == {"dd.model.forward"}
    assert parents["dd.model.weight_prep"] <= {"dd.model.block", "dd.model.precondition",
                                               "dd.model.forward", "dd.sampler.run"}
    if decode == "ddec":
        assert parents["dd.pipeline.mel_to_linear"] == {"dd.pipeline.generate"}
        assert parents["dd.pipeline.imdct"] == {"dd.pipeline.generate"}
    else:
        assert parents["dd.pipeline.fgla"] == {"dd.pipeline.generate"}


@pytest.mark.parametrize("decode", ["fgla", "ddec"])
def test_span_counts_follow_the_request(decode):
    """Steps per sampler stage, two forwards a step (Heun; the latent UNet
    under CFG runs both halves of the batch in one), one DAE decode, a
    block span per op of each UNet forward."""
    pipe = tiny_pipeline(decode)
    _, spans = profiled(pipe)
    count = {n: sum(e.name == n for e in spans) for n in SPANS[decode]}
    stages = 2 if decode == "ddec" else 1
    assert count["dd.pipeline.generate"] == 1
    assert count["dd.sampler.run"] == stages
    assert count["dd.sampler.step"] == STEPS * stages
    assert count["dd.model.forward"] == 2 * STEPS * stages + 1
    assert count["dd.model.precondition"] == 2 * STEPS * stages
    ops = len(pipe.modules["unet"].module.core.schedule)
    if decode == "ddec":
        ops += len(pipe.modules["ddec"].module.core.schedule)
    assert count["dd.model.block"] == 2 * STEPS * ops


@pytest.mark.parametrize("decode", ["fgla", "ddec"])
def test_weight_preps_are_the_layers_outside_k1s_cache(decode):
    """Inside each forward, one ``dd.model.weight_prep`` per ``MPConv`` call
    that re-scales its weight: every one but the grouped 3x3 convs, whose
    K1 weights stay cached from the first request."""
    pipe = tiny_pipeline(decode)
    _, spans = profiled(pipe)
    forwards = sorted((e for e in spans if e.name == "dd.model.forward"),
                      key=lambda e: e.time_range.start)
    preps = [e.time_range.start for e in spans if e.name == "dd.model.weight_prep"]
    got = [sum(f.time_range.start <= s <= f.time_range.end for s in preps) for f in forwards]
    assert got == rescaled_per_forward(pipe, lambda: request(pipe))
    # the latent UNet's forwards: each of its layers but the K1 ones
    core = pipe.modules["unet"].module.core
    convs = [m for m in core.modules() if isinstance(m, MPConv)]
    k1 = [m for m in convs if m.groups > 1 and m.kernel == (3, 3)]
    assert k1 and got[:2 * STEPS] == [len(convs) - len(k1)] * (2 * STEPS)


def test_timings_keep_their_keys_in_order():
    pipe = tiny_pipeline("fgla")
    t = {}
    request(pipe, timings=t)
    assert list(t) == ["sampler", "dae_decode", "fgla"]
    assert all(v > 0 for v in t.values())
    pipe = tiny_pipeline("ddec")
    t = {}
    request(pipe, timings=t)
    assert list(t) == ["sampler", "dae_decode", "ddec", "mdct_to_raw"]
    t = {}
    audio = torch.randn((2, MS_KW["default_raw_length"]), generator=torch.Generator()
                        .manual_seed(1))
    request(pipe, input_audio=audio, timings=t)
    assert list(t) == ["encode", "sampler", "dae_decode", "ddec", "mdct_to_raw"]


def test_one_prompt_embedding_serves_a_batch():
    """A (1, E) prompt embedding at batch 2 gives the latents of the same
    embedding expanded to (2, E)."""
    pipe = tiny_pipeline("fgla")
    emb = torch.randn((1, 1024), generator=torch.Generator().manual_seed(3))
    one = request(pipe, batch=2, emb=emb)["latents"]
    two = request(pipe, batch=2, emb=emb.expand(2, 1024).clone())["latents"]
    assert one.shape[0] == 2
    np.testing.assert_array_equal(one.numpy(), two.numpy())


@pytest.mark.cuda
def test_spans_never_reach_the_device_timeline():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prof, spans = profiled(tiny_pipeline("ddec", "cuda"),
                           (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert device, "the profile holds no device operation"
    assert not [e.name for e in device if "dd." in e.name]
    assert {e.name for e in spans} == SPANS["ddec"]
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in spans)
