"""``encode_input_audio`` and ``generate`` with ``input_audio``,
``input_latents``, ``inpainting_mask`` and ``seamless_loop`` on tiny
JAX-written models against the JAX package, with JAX's key splits (k1 for
the latent stage, k2 for the DDEC's) replayed as explicit noise and
shifts: the checks for both decode modes, and the Griffin-Lim model's
cases (the DDEC model's: tests/test_torch_generate_inputs_ddec.py).

<-> dualdiffusion_tpu/pipelines/pipeline.py ``diffusion_decode``,
``encode_input_audio`` and ``generate``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.convert import convert_unet_to_inpainting as jax_convert
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import SpectrogramFormat as JaxSpectrogramFormat
from dualdiffusion_tpu.models.formats import SpectrogramFormatConfig as JaxFormatConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import ModuleHandle as JaxModuleHandle
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu_torch.pipelines import Pipeline
from dualdiffusion_tpu_torch.sampling import SampleParams
from test_torch_ddec import _jax_pipeline as _jax_ddec_pipeline
from test_torch_generate_options import _gains, _rel_l2, _rel_max, replay
from test_torch_training import set_trunk_dtype


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
              compute_dtype="float32")
# 128 frames of a 40 ms / 8 ms-hop, 64-bin mel: (1, 16, 32, 8) latents, long
# enough for the seamless crossfade (16,128 samples at hop 256)
FMT_KW = dict(window_duration_ms=40, padded_duration_ms=40, num_frequencies=64,
              default_raw_length=127 * 256)
GEN_STEPS = 2


@functools.lru_cache(maxsize=None)
def _jax_fgla_pipeline():
    key_u, key_d = jax.random.split(jax.random.PRNGKey(16))
    ucfg, dcfg = JaxUNetConfig(**UNET_KW), JaxDAEConfig(**DAE_KW)
    unet, dae = JaxUNet(ucfg), JaxDAE(dcfg)
    uvars = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 16, 32, 8)), jnp.ones((1,)),
                                        jnp.zeros((1, 1024)), method=JaxUNet.init_all))(key_u)
    dvars = jax.jit(dae.init)(key_d, jnp.zeros((1, 64, 128, 2)))
    fcfg = JaxFormatConfig(**FMT_KW)
    return JaxPipeline({
        "unet": JaxModuleHandle("unet", "unet", ucfg, unet, _gains(uvars, 17)),
        "dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
        "format": JaxModuleHandle("format", "format:spectrogram", fcfg,
                                  JaxSpectrogramFormat(fcfg)),
    })


def _jax_long_ddec_pipeline():
    """The DDEC model of tests/test_torch_ddec.py on 256 mel frames (8,160
    samples at hop 32), long enough for the seamless crossfade (2,016)."""
    jpipe = _jax_ddec_pipeline()
    h = jpipe.modules["format"]
    cfg = dataclasses.replace(h.config, default_raw_length=255 * 32)
    return JaxPipeline(dict(jpipe.modules, format=JaxModuleHandle(
        "format", h.module_type, cfg, type(h.module)(cfg))))


def _model_dir(tmp_path, mode, inpainting, long=False):
    jpipe = (_jax_fgla_pipeline() if mode == "fgla" else
             _jax_long_ddec_pipeline() if long else _jax_ddec_pipeline())
    d = tmp_path / "model"
    jpipe.save_pretrained(d)
    if inpainting:
        jax_convert(d)
    return d


def _audio(fmt, seed):
    t = fmt.get_raw_crop_width() - 1000    # shorter than the crop: zero-padded
    return np.random.default_rng(seed).standard_normal((2, t)).astype(np.float32) * 0.2


def check_encode_input_audio(tmp_path, mode):
    """Crop or pad, format-encode, DAE-encode (fp32 DAE on the spectrogram
    model: 1e-4 of max; the DDEC model's DAE runs bf16 in both: 3e-2)."""
    d = _model_dir(tmp_path, mode, False)
    jpipe = JaxPipeline.from_pretrained(d)
    pipe = Pipeline.from_pretrained(d, device="cpu")
    audio = _audio(pipe.format, 18)
    want = jpipe.encode_input_audio(audio)
    got = pipe.encode_input_audio(torch.from_numpy(audio))
    assert got.dtype == torch.float32
    assert _rel_max(got, want) <= (1e-4 if mode == "fgla" else 3e-2)
    longer = np.concatenate([audio, audio], axis=-1)[None]
    assert _rel_max(pipe.encode_input_audio(longer), jpipe.encode_input_audio(longer)) <= \
        (1e-4 if mode == "fgla" else 3e-2)


def check_generate_options(tmp_path, monkeypatch, mode, kind):
    """``generate`` from an init sample on a JAX-written model, with the JAX
    key's k1 (latent stage) and k2 (DDEC stage) draws replayed, in fp32 UNet
    trunks: img2img from audio at strength 0.5 (one of two steps), from
    latents at strength 1 (both steps), and inpainting (a mask over the
    first half of the latent columns), which substitutes the converted
    ``unet_inpainting`` (8 + 8 + 1 inputs) and runs the whole
    schedule whatever the strength. Latents to 1e-3 of max and the mel to
    1e-2 on the spectrogram model, whose DAE runs fp32; the DDEC model's DAE
    encodes and decodes in bf16 in both packages, rounding at different
    places: latents to 1e-2, the mel to 3e-2. Under "fgla" the audio's own
    mel spectrogram to 0.1 relative L2, under "ddec" the audio to 0.1 (the
    bf16 DAE's mel conditions the DDEC stage)."""
    set_trunk_dtype(monkeypatch, "float32")
    d = _model_dir(tmp_path, mode, kind == "inpainting")
    jpipe = JaxPipeline.from_pretrained(d)
    pipe = Pipeline.from_pretrained(d, device="cpu")
    fmt = pipe.format
    lat_shape = pipe.modules["dae"].module.get_latent_shape(fmt.get_sample_shape(1))
    rng = np.random.default_rng(19)
    prompt = rng.standard_normal((1, 1024)).astype(np.float32)
    strength = {"input_audio": 0.5, "input_latents": 1.0, "inpainting": 0.25}[kind]
    jkw, kw = {}, {}
    if kind == "input_latents":
        lat = rng.standard_normal(lat_shape).astype(np.float32)
        jkw["input_latents"], kw["input_latents"] = jnp.asarray(lat), torch.from_numpy(lat)
    else:
        audio = _audio(fmt, 20)
        jkw["input_audio"], kw["input_audio"] = audio, torch.from_numpy(audio)
    if kind == "inpainting":
        mask = np.zeros((1, 1, lat_shape[2], 1), np.float32)
        mask[..., : lat_shape[2] // 2, :] = 1.0
        jkw["inpainting_mask"], kw["inpainting_mask"] = mask, torch.from_numpy(mask)
    key = jax.random.PRNGKey(21)
    jparams = JaxSampleParams(steps=GEN_STEPS, num_fgla_iters=3, img2img_strength=strength)
    want = jpipe.generate(jparams, key, prompt_embedding=jnp.asarray(prompt), decode_mode=mode,
                          **jkw)
    run_steps = GEN_STEPS if kind != "input_audio" else 1
    assert want["debug"]["sample_std"].shape == (run_steps,)
    k1, k2, _ = jax.random.split(key, 3)
    init, noise, _ = replay(k1, lat_shape, run_steps)
    if mode == "ddec":
        mdct_shape = fmt.get_mdct_shape_for_mel_frames(1, fmt.get_sample_shape(1)[2])
        kw["ddec_init_noise"], kw["ddec_step_noise"], _ = replay(k2, mdct_shape, GEN_STEPS)
    used = []
    if kind == "inpainting":
        conv = pipe.modules["unet_inpainting"].module
        assert conv.core.enc_conv_in.w_mp.shape[1] == 8 + 8 + 1
        monkeypatch.setattr(conv, "forward", (lambda f: lambda *a, **k: used.append(1) or
                                              f(*a, **k))(conv.forward))
    dbg = {}
    got = pipe.generate(SampleParams(steps=GEN_STEPS, num_fgla_iters=3,
                                     img2img_strength=strength),
                        prompt_embedding=torch.from_numpy(prompt), decode_mode=mode,
                        init_noise=init, step_noise=noise, debug=dbg, **kw)
    assert dbg["sample_std"].shape == (run_steps,)
    if kind == "inpainting":
        assert len(used) == 2 * GEN_STEPS    # Heun: two forwards a step, every step
    assert got["raw"].shape == tuple(want["raw"].shape)
    assert torch.isfinite(got["raw"]).all()
    bf16_dae = mode == "ddec"
    assert _rel_max(got["latents"], want["latents"]) <= (1e-2 if bf16_dae else 1e-3)
    assert _rel_max(got["sample"], want["sample"]) <= (3e-2 if bf16_dae else 1e-2)
    if mode == "fgla":
        jfmt = jpipe.format
        assert _rel_l2(fmt.raw_to_sample(got["raw"]), jfmt.raw_to_sample(want["raw"])) < 0.1
    else:
        assert _rel_l2(got["raw"], want["raw"]) < 0.1


def check_seamless_generate(tmp_path, monkeypatch, mode):
    """``generate`` with ``seamless_loop`` on a JAX-written model, JAX's
    shifts and noise replayed for both stages, fp32 UNet trunks: under the
    DDEC the PSD reference rolls with the MDCT sample. The audio is the
    crossfaded loop, int((32 - 0.5) * hop) * 2 samples shorter than the
    crop. Latents to 1e-3 of max; under "fgla" the audio's mel spectrogram
    to 0.1 relative L2; under "ddec" (whose DAE decodes in bf16 in both
    packages) the mel to 3e-2 of max and the audio to 0.1 relative L2."""
    set_trunk_dtype(monkeypatch, "float32")
    d = _model_dir(tmp_path, mode, False, long=True)
    jpipe = JaxPipeline.from_pretrained(d)
    pipe = Pipeline.from_pretrained(d, device="cpu")
    fmt = pipe.format
    lat_shape = pipe.modules["dae"].module.get_latent_shape(fmt.get_sample_shape(1))
    key = jax.random.PRNGKey(22)
    params = dict(steps=GEN_STEPS, num_fgla_iters=3, seamless_loop=True)
    want = jpipe.generate(JaxSampleParams(**params), key, decode_mode=mode)
    k1, k2, _ = jax.random.split(key, 3)
    init, noise, shifts = replay(k1, lat_shape, GEN_STEPS)
    kw = {}
    if mode == "ddec":
        mdct_shape = fmt.get_mdct_shape_for_mel_frames(1, fmt.get_sample_shape(1)[2])
        kw["ddec_init_noise"], kw["ddec_step_noise"], kw["ddec_step_shifts"] = \
            replay(k2, mdct_shape, GEN_STEPS)
        assert len(set(kw["ddec_step_shifts"])) > 1
    dbg = {}
    got = pipe.generate(SampleParams(**params), decode_mode=mode, init_noise=init,
                        step_noise=noise, step_shifts=shifts, debug=dbg, **kw)
    assert dbg["step_shifts"] == shifts
    hop = 256 if mode == "fgla" else fmt.config.ms_hop_length
    assert got["raw"].shape == tuple(want["raw"].shape) == \
        (1, 2, fmt.get_raw_crop_width() - int(31.5 * hop) * 2)
    assert _rel_max(got["latents"], want["latents"]) <= 1e-3
    if mode == "fgla":
        assert _rel_l2(fmt.raw_to_sample(got["raw"]),
                       jpipe.format.raw_to_sample(want["raw"])) < 0.1
    else:
        assert dbg["ddec"]["step_shifts"] == kw["ddec_step_shifts"]
        assert _rel_max(got["sample"], want["sample"]) <= 3e-2
        assert _rel_l2(got["raw"], want["raw"]) < 0.1


# The spectrogram model's cases; the DDEC model's are in
# tests/test_torch_generate_inputs_ddec.py (a file of their own, so that
# the test runner's workers can take the two halves apart).

def test_encode_input_audio_matches_jax(tmp_path):
    check_encode_input_audio(tmp_path, "fgla")


@pytest.mark.parametrize("kind", ["input_audio", "input_latents", "inpainting"])
def test_generate_options_match_jax(tmp_path, monkeypatch, kind):
    check_generate_options(tmp_path, monkeypatch, "fgla", kind)


def test_seamless_generate_matches_jax(tmp_path, monkeypatch):
    check_seamless_generate(tmp_path, monkeypatch, "fgla")
