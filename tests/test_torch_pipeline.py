"""The whole slice against the JAX package: a tiny model directory written
by the JAX ``save_pretrained`` loads in the port's ``from_pretrained``, and
the port's ``generate`` (sampler -> DAE decode -> mel unscale + SPSI
Griffin-Lim) reproduces JAX ``generate`` on raw audio, with the JAX key
splits replayed as explicit noise. Also the other direction: a directory the
port writes loads in the JAX package with identical weights."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import SpectrogramFormat as JaxSpectrogramFormat
from dualdiffusion_tpu.models.formats import SpectrogramFormatConfig as JaxFormatConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import ModuleHandle as JaxModuleHandle
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu_torch.pipelines import Pipeline
from dualdiffusion_tpu_torch.sampling import SampleParams

UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
# 64 frames of a 40 ms / 8 ms-hop, 64-bin mel spectrogram
FMT_KW = dict(window_duration_ms=40, padded_duration_ms=40, num_frequencies=64,
              default_raw_length=63 * 256)
STEPS, FGLA_ITERS = 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    key_u, key_d = jax.random.split(jax.random.PRNGKey(11))
    ucfg, dcfg = JaxUNetConfig(**UNET_KW), JaxDAEConfig(**DAE_KW)
    unet, dae = JaxUNet(ucfg), JaxDAE(dcfg)
    uvars = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 16, 16, 8)), jnp.ones((1,)),
                                        jnp.zeros((1, 1024)), method=JaxUNet.init_all))(key_u)
    dvars = jax.jit(dae.init)(key_d, jnp.zeros((1, 64, 64, 2)))
    rng = np.random.default_rng(4)

    def gains(path, leaf):  # zero-initialised gains get values (bench.py:265)
        return (jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
                if leaf.ndim == 0 and "gain" in getattr(path[-1], "key", "") else leaf)
    uvars = jax.tree_util.tree_map_with_path(gains, uvars)
    fcfg = JaxFormatConfig(**FMT_KW)
    return JaxPipeline({
        "unet": JaxModuleHandle("unet", "unet", ucfg, unet, uvars),
        "dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
        "format": JaxModuleHandle("format", "format:spectrogram", fcfg,
                                  JaxSpectrogramFormat(fcfg)),
    })


def test_generate_matches_jax_on_a_jax_written_model(tmp_path):
    """Both packages run the UNet and DAE in bf16 and round at different
    places: latents agree to 5e-2 of max after two Heun steps, the DAE's mel
    to 3e-2. Phase recovery in fp32 from the same mel agrees to 2e-3
    (relative L2). End to end, the mel inverse and SPSI peak picking turn
    the mel's few-percent bf16 differences into different phases, so the
    generated audio is compared through its own mel spectrogram (0.2
    relative L2; measured 0.10), not sample by sample."""
    jpipe = _jax_pipeline()
    jpipe.save_pretrained(tmp_path / "model")
    key = jax.random.PRNGKey(3)
    prompt = np.random.default_rng(5).standard_normal((1, 1024)).astype(np.float32)
    jparams = JaxSampleParams(steps=STEPS, num_fgla_iters=FGLA_ITERS)
    want = jpipe.generate(jparams, key, prompt_embedding=jnp.asarray(prompt),
                          decode_mode="fgla")

    # replay the draws generate -> diffusion_decode -> edm_sample makes
    k_sampler = jax.random.split(key, 3)[0]
    k_loop, nk = jax.random.split(k_sampler)
    lat_shape = tuple(want["latents"].shape)
    init = jax.random.normal(jax.random.split(nk)[0], lat_shape, jnp.float32)
    step_noise = []
    for _ in range(STEPS):
        k_loop, k_noise, _ = jax.random.split(k_loop, 3)
        step_noise.append(torch.from_numpy(np.array(
            jax.random.normal(jax.random.split(k_noise)[0], lat_shape, jnp.float32))))

    pipe = Pipeline.from_pretrained(tmp_path / "model", device="cpu")
    got = pipe.generate(SampleParams(steps=STEPS, num_fgla_iters=FGLA_ITERS),
                        prompt_embedding=torch.from_numpy(prompt), decode_mode="fgla",
                        init_noise=torch.from_numpy(np.array(init)), step_noise=step_noise)

    def rel_max(a, b):
        b = np.asarray(b, np.float32)
        return np.abs(a.float().numpy() - b).max() / np.abs(b).max()

    def rel_l2(a, b):
        b = np.asarray(b, np.float32)
        return np.linalg.norm(a.float().numpy() - b) / np.linalg.norm(b)

    fmt = pipe.format
    with torch.no_grad():
        mel_from_jax_latents = pipe.modules["dae"].module.decode(
            torch.from_numpy(np.array(want["latents"])))
        raw_from_jax_mel = fmt.sample_to_raw(torch.from_numpy(np.array(want["sample"])),
                                             n_fgla_iters=FGLA_ITERS, phase_init="spsi")
        out_mel = [fmt.raw_to_sample(torch.from_numpy(np.array(r))) for r in
                   (got["raw"], want["raw"])]
    assert got["raw"].shape == tuple(want["raw"].shape) == (1, 2, 63 * 256)
    # stage by stage, each stage fed the JAX stage's output
    assert rel_max(got["latents"], want["latents"]) < 5e-2
    assert rel_max(mel_from_jax_latents, want["sample"]) < 3e-2
    assert rel_l2(raw_from_jax_mel, want["raw"]) < 2e-3
    # end to end: the audio's own mel spectrogram
    assert rel_l2(got["sample"], want["sample"]) < 6e-2
    assert rel_l2(out_mel[0], out_mel[1].numpy()) < 0.2


def test_port_written_model_loads_in_jax(tmp_path):
    """Port save_pretrained -> JAX from_pretrained: same module types,
    configs and bit-identical weights."""
    jpipe = _jax_pipeline()
    jpipe.save_pretrained(tmp_path / "jax")
    Pipeline.from_pretrained(tmp_path / "jax", device="cpu").save_pretrained(tmp_path / "port")
    back = JaxPipeline.from_pretrained(tmp_path / "port")
    assert sorted(back.modules) == sorted(jpipe.modules)
    for name, h in jpipe.modules.items():
        b = back.modules[name]
        assert b.module_type == h.module_type and b.config == h.config
        if h.variables is not None:
            fa, fb = _flatten(h.variables), _flatten(b.variables)
            assert sorted(fa) == sorted(fb)
            assert all(np.array_equal(fa[k], fb[k]) for k in fa), name


def test_generate_refuses_an_init_sample_of_another_shape(tmp_path):
    """``input_latents`` must have the latent shape (JAX pipeline.py:586-589
    asserts it; the port raises ValueError before it samples): here the
    (1, 16, 16, 8) latents of the 64-frame mel, not (1, 16, 8, 8) or
    (1, 16, 16, 4)."""
    jpipe = _jax_pipeline()
    jpipe.save_pretrained(tmp_path / "model")
    pipe = Pipeline.from_pretrained(tmp_path / "model", device="cpu")
    params = SampleParams(steps=1, num_fgla_iters=1)
    for shape in ((1, 16, 8, 8), (1, 16, 16, 4)):
        with pytest.raises(AssertionError):
            jpipe.generate(JaxSampleParams(steps=1, num_fgla_iters=1), jax.random.PRNGKey(0),
                           input_latents=jnp.zeros(shape))
        with pytest.raises(ValueError, match="latent shape"):
            pipe.generate(params, torch.Generator().manual_seed(0),
                          input_latents=torch.zeros(shape))
    out = pipe.generate(params, torch.Generator().manual_seed(0),
                        input_latents=torch.zeros((1, 16, 16, 8)))
    assert out["latents"].shape == (1, 16, 16, 8)


def test_from_pretrained_defaults_to_the_card(tmp_path, monkeypatch):
    """``from_pretrained`` loads onto the card unless the caller asks for
    the CPU: with no card, a call without ``device`` raises instead of
    loading onto the CPU."""
    _jax_pipeline().save_pretrained(tmp_path / "model")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline.from_pretrained(tmp_path / "model")
    assert Pipeline.from_pretrained(tmp_path / "model", device="cpu").modules
