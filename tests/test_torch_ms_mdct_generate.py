"""``generate`` on an ``ms_mdct_dual`` pipeline against the JAX package: a
tiny model directory (format + DAE + UNet) written by the JAX
``save_pretrained`` loads in the port's ``from_pretrained``, and the port's
``generate`` decodes through the format's FGLA fallback
(``sample_to_raw_fgla``: mel -> linear PSD -> SPSI Griffin-Lim on the
``ms_window_length`` STFT grid), as JAX ``generate`` picks it, with the JAX
key splits replayed as explicit noise.

<-> dualdiffusion_tpu/models/formats/ms_mdct_dual.py ``sample_to_raw_fgla``
and dualdiffusion_tpu/pipelines/pipeline.py ``generate``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import MSMDCTDualFormat as JaxMSMDCTDualFormat
from dualdiffusion_tpu.models.formats import MSMDCTDualFormatConfig as JaxFormatConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import ModuleHandle as JaxModuleHandle
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.pipelines import Pipeline
from dualdiffusion_tpu_torch.sampling import SampleParams

UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
# a 32-filter mel on a 256-point STFT, hop 32 (the MDCT's 64-sample window /
# 2): 64 frames, so (1, 32, 64, 2) mel and (1, 8, 16, 8) latents
FMT_KW = dict(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
              default_raw_length=63 * 32)
STEPS, FGLA_ITERS = 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    key_u, key_d = jax.random.split(jax.random.PRNGKey(21))
    ucfg, dcfg = JaxUNetConfig(**UNET_KW), JaxDAEConfig(**DAE_KW)
    unet, dae = JaxUNet(ucfg), JaxDAE(dcfg)
    uvars = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 8, 16, 8)), jnp.ones((1,)),
                                        jnp.zeros((1, 1024)), method=JaxUNet.init_all))(key_u)
    dvars = jax.jit(dae.init)(key_d, jnp.zeros((1, 32, 64, 2)))
    rng = np.random.default_rng(6)

    def gains(path, leaf):  # zero-initialised gains get values (bench.py:265)
        return (jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
                if leaf.ndim == 0 and "gain" in getattr(path[-1], "key", "") else leaf)
    uvars = jax.tree_util.tree_map_with_path(gains, uvars)
    fcfg = JaxFormatConfig(**FMT_KW)
    return JaxPipeline({
        "unet": JaxModuleHandle("unet", "unet", ucfg, unet, uvars),
        "dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
        "format": JaxModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                  JaxMSMDCTDualFormat(fcfg)),
    })


def _rel_max(a, b):
    b = np.asarray(b, np.float32)
    return np.abs(np.asarray(a, np.float32) - b).max() / np.abs(b).max()


def _rel_l2(a, b):
    b = np.asarray(b, np.float32)
    return np.linalg.norm(np.asarray(a, np.float32) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("phase_init", ["spsi", "flat"])
def test_sample_to_raw_fgla_matches_jax(phase_init):
    """The FGLA fallback decode in fp32 from the same mel: one mel inverse,
    then Griffin-Lim through the same transforms in another summation order
    (1e-3 relative L2 after 3 iterations)."""
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((1, 32, 64, 2)).astype(np.float32) * 0.5
    want = JaxMSMDCTDualFormat(JaxFormatConfig(**FMT_KW)).sample_to_raw_fgla(
        jnp.asarray(mel), n_fgla_iters=FGLA_ITERS, phase_init=phase_init)
    got = MSMDCTDualFormat(MSMDCTDualFormatConfig(**FMT_KW)).sample_to_raw_fgla(
        torch.from_numpy(mel), n_fgla_iters=FGLA_ITERS, phase_init=phase_init)
    assert got.shape == tuple(want.shape) == (1, 2, 63 * 32)
    assert _rel_l2(got.numpy(), want) < 1e-3


def test_ms_mdct_dual_generate_matches_jax(tmp_path):
    """Both packages run the UNet and DAE in bf16 and round at different
    places: latents agree to 5e-2 of max after two Heun steps, the DAE's mel
    to 3e-2. The port's FGLA decode of the JAX mel agrees with the JAX audio
    to 1e-3 (relative L2, fp32). End to end, SPSI's peak picking turns the
    mel's bf16 differences into different phases, so the generated audio is
    compared through its own mel spectrogram (0.2 relative L2)."""
    jpipe = _jax_pipeline()
    jpipe.save_pretrained(tmp_path / "model")
    key = jax.random.PRNGKey(8)
    prompt = np.random.default_rng(9).standard_normal((1, 1024)).astype(np.float32)
    want = jpipe.generate(JaxSampleParams(steps=STEPS, num_fgla_iters=FGLA_ITERS), key,
                          prompt_embedding=jnp.asarray(prompt), decode_mode="fgla")

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
    assert isinstance(pipe.format, MSMDCTDualFormat)
    got = pipe.generate(SampleParams(steps=STEPS, num_fgla_iters=FGLA_ITERS),
                        prompt_embedding=torch.from_numpy(prompt),
                        init_noise=torch.from_numpy(np.array(init)), step_noise=step_noise)

    fmt = pipe.format
    with torch.no_grad():
        mel_from_jax_latents = pipe.modules["dae"].module.decode(
            torch.from_numpy(np.array(want["latents"])))
        raw_from_jax_mel = fmt.sample_to_raw_fgla(torch.from_numpy(np.array(want["sample"])),
                                                  n_fgla_iters=FGLA_ITERS, phase_init="spsi")
        out_mel = [fmt.raw_to_sample(torch.from_numpy(np.array(r))) for r in
                   (got["raw"], want["raw"])]
    assert got["raw"].shape == tuple(want["raw"].shape) == (1, 2, 63 * 32)
    assert lat_shape == (1, 8, 16, 8)
    assert torch.isfinite(got["raw"]).all()
    # stage by stage, each stage fed the JAX stage's output
    assert _rel_max(got["latents"].numpy(), want["latents"]) < 5e-2
    assert _rel_max(mel_from_jax_latents.numpy(), want["sample"]) < 3e-2
    assert _rel_l2(raw_from_jax_mel.numpy(), want["raw"]) < 1e-3
    # end to end: the audio's own mel spectrogram
    assert _rel_l2(got["sample"].numpy(), want["sample"]) < 6e-2
    assert _rel_l2(out_mel[0].numpy(), out_mel[1].numpy()) < 0.2
