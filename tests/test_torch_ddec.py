"""The DDEC decode against the JAX package: the MS-MDCT format's DDEC helpers,
the UNet's PSD fold and constant channel, and ``generate(decode_mode="auto")``
on a tiny JAX-written model directory with a ``"ddec"`` module, with the JAX
key splits replayed as explicit noise (k1 for the latent stage, k2 for the
DDEC's).

<-> dualdiffusion_tpu/models/formats/ms_mdct_dual.py (``get_mdct_shape_for_mel_frames``,
``normalize_psd``, ``raw_to_mdct_phase_psd``), dualdiffusion_tpu/models/unet.py
``precondition`` and dualdiffusion_tpu/pipelines/pipeline.py ``generate``.
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
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.pipelines import Pipeline
from dualdiffusion_tpu_torch.sampling import SampleParams
from dualdiffusion_tpu_torch.weights import load_flat, to_flat
from test_torch_training import set_trunk_dtype

UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
# the DDEC of configs/models/edm2_ddec_mclt_b1a/ddec.json at a tiny width:
# 128 PSD rows fold 4 to a model row, so 2 + 4 x 2 + 1 input channels
DDEC_KW = dict(in_channels=2, out_channels=2, in_channels_emb=0, in_num_freqs=32,
               in_psd_freqs=128, sigma_max=20.0, sigma_min=3e-5, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, mlp_multiplier=2,
               logvar_channels=32, double_midblock=True, add_constant_channel=True)
# a 32-filter mel on a 256-point STFT, hop 32 (the MDCT's 64-sample window /
# 2): 64 frames, so (1, 32, 64, 2) mel, (1, 128, 64, 2) linear PSD,
# (1, 32, 64, 2) MDCT and (1, 8, 16, 8) latents
FMT_KW = dict(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
              default_raw_length=63 * 32)
MDCT_SHAPE, LIN_SHAPE = (1, 32, 64, 2), (1, 128, 64, 2)
STEPS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float32)


def _gains(variables, seed):
    """Every zero-initialised scalar gain gets a value (bench.py:265)."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        return (jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
                if leaf.ndim == 0 and "gain" in getattr(path[-1], "key", "") else leaf)
    return jax.tree_util.tree_map_with_path(fix, variables)


@functools.lru_cache(maxsize=None)
def _jax_ddec_vars():
    ddec = JaxUNet(JaxUNetConfig(**DDEC_KW))
    v = jax.jit(lambda k: ddec.init(k, jnp.zeros(MDCT_SHAPE), jnp.ones((1,)), None,
                                    jnp.zeros(LIN_SHAPE), method=JaxUNet.init_all))(
        jax.random.PRNGKey(31))
    return _gains(v, 32)


@functools.lru_cache(maxsize=None)
def _jax_pipeline(with_ddec: bool = True):
    key_u, key_d = jax.random.split(jax.random.PRNGKey(21))
    ucfg, dcfg = JaxUNetConfig(**UNET_KW), JaxDAEConfig(**DAE_KW)
    unet, dae = JaxUNet(ucfg), JaxDAE(dcfg)
    uvars = jax.jit(lambda k: unet.init(k, jnp.zeros((1, 8, 16, 8)), jnp.ones((1,)),
                                        jnp.zeros((1, 1024)), method=JaxUNet.init_all))(key_u)
    dvars = jax.jit(dae.init)(key_d, jnp.zeros((1, 32, 64, 2)))
    fcfg = JaxFormatConfig(**FMT_KW)
    modules = {
        "unet": JaxModuleHandle("unet", "unet", ucfg, unet, _gains(uvars, 6)),
        "dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
        "format": JaxModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                  JaxMSMDCTDualFormat(fcfg)),
    }
    if with_ddec:
        ddcfg = JaxUNetConfig(**DDEC_KW)
        modules["ddec"] = JaxModuleHandle("ddec", "ddec", ddcfg, JaxUNet(ddcfg),
                                          _jax_ddec_vars())
    return JaxPipeline(modules)


def _formats():
    return (JaxMSMDCTDualFormat(JaxFormatConfig(**FMT_KW)),
            MSMDCTDualFormat(MSMDCTDualFormatConfig(**FMT_KW)))


def _replayed_noise(key, shape, steps):
    """The draws JAX edm_sample makes from ``key``: (x_T noise, step noises)."""
    k_loop, nk = jax.random.split(key)
    init = jax.random.normal(jax.random.split(nk)[0], shape, jnp.float32)
    step_noise = []
    for _ in range(steps):
        k_loop, k_noise, _ = jax.random.split(k_loop, 3)
        step_noise.append(torch.from_numpy(np.array(
            jax.random.normal(jax.random.split(k_noise)[0], shape, jnp.float32))))
    return torch.from_numpy(np.array(init)), step_noise


# ---------------------------------------------------------------------------
# (a) the format's DDEC helpers, fp32
# ---------------------------------------------------------------------------

def test_mdct_shape_for_mel_frames_and_psd_scaling_match_jax():
    """The MDCT grid aligned with the mel's frames, and the PSD's affine
    normalization and its inverse (relative L2 <= 1e-5)."""
    jfmt, fmt = _formats()
    for b, frames in ((1, 64), (3, 5504)):
        assert fmt.get_mdct_shape_for_mel_frames(b, frames) == \
            tuple(jfmt.get_mdct_shape_for_mel_frames(b, frames))
    assert fmt.get_mdct_shape_for_mel_frames(1, 64) == MDCT_SHAPE
    psd = np.random.default_rng(40).standard_normal(MDCT_SHAPE).astype(np.float32)
    for name in ("normalize_psd", "unnormalize_psd"):
        got = getattr(fmt, name)(torch.from_numpy(psd))
        assert _rel_l2(_np(got), getattr(jfmt, name)(jnp.asarray(psd))) <= 1e-5
    back = fmt.unnormalize_psd(fmt.normalize_psd(torch.from_numpy(psd)))
    assert _rel_l2(_np(back), psd) <= 1e-5


def test_mdct_shape_for_mel_frames_needs_equal_hops():
    cfg = MSMDCTDualFormatConfig(**FMT_KW)
    fmt = MSMDCTDualFormat(cfg)
    # the two hops are one property today; a config that parts them must fail
    fmt.config = type("Parted", (), {"ms_hop_length": 256, "mdct_frame_hop_length": 32,
                                     "mdct_num_frequencies": 32, "num_raw_channels": 2})()
    with pytest.raises(ValueError):
        fmt.get_mdct_shape_for_mel_frames(1, 64)


@pytest.mark.parametrize("rotate", [False, True])
def test_raw_to_mdct_phase_psd_matches_jax(rotate):
    """The phase/psd split at B = 1 (JAX's rotation lines its angles up with
    the channel axis at other batch sizes), with JAX's random rotation angle
    passed in as ``theta``: relative L2 <= 1e-5 for both."""
    jfmt, fmt = _formats()
    raw = np.random.default_rng(41).standard_normal((1, 2, 63 * 32)).astype(np.float32)
    key = jax.random.PRNGKey(42)
    want_phase, want_psd = jfmt.raw_to_mdct_phase_psd(jnp.asarray(raw), rotate, key)
    theta = (torch.from_numpy(np.array(jax.random.uniform(key, (1,)) * 2 * jnp.pi))
             if rotate else None)
    phase, psd = fmt.raw_to_mdct_phase_psd(torch.from_numpy(raw), theta)
    assert phase.shape == psd.shape == tuple(want_psd.shape) == MDCT_SHAPE
    assert _rel_l2(_np(phase), want_phase) <= 1e-5
    assert _rel_l2(_np(psd), want_psd) <= 1e-5


def test_mel_spec_to_linear_and_mdct_to_raw_match_jax():
    """The DDEC stage's two format transforms: mel -> linear PSD (the
    conditioning) and MDCT coefficients -> audio (relative L2 <= 1e-5)."""
    jfmt, fmt = _formats()
    rng = np.random.default_rng(43)
    mel = rng.standard_normal((1, 32, 64, 2)).astype(np.float32) * 0.5
    coeffs = rng.standard_normal(MDCT_SHAPE).astype(np.float32)
    lin = fmt.mel_spec_to_linear(torch.from_numpy(mel))
    assert lin.shape == LIN_SHAPE
    assert _rel_l2(_np(lin), jfmt.mel_spec_to_linear(jnp.asarray(mel))) <= 1e-5
    raw = fmt.mdct_to_raw(torch.from_numpy(coeffs))
    assert raw.shape == (1, 2, 63 * 32)
    assert _rel_l2(_np(raw), jfmt.mdct_to_raw(jnp.asarray(coeffs))) <= 1e-5


# ---------------------------------------------------------------------------
# (b) the DDEC forward with the PSD fold and the constant channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trunk,tol", [("bfloat16", 3e-2), ("float32", 1e-4)])
def test_ddec_forward_with_psd_matches_jax(monkeypatch, trunk, tol):
    """D(x) - c_skip x on JAX weights: 3e-2 of max in the bf16 trunk, where
    the two packages round at different places (as
    tests/test_torch_models.py), 1e-4 in an fp32 trunk. The PSD rows and
    channels all carry distinct values, so a fold in another axis order
    fails the fp32 bound."""
    set_trunk_dtype(monkeypatch, trunk)
    jvars = _jax_ddec_vars()
    rng = np.random.default_rng(44)
    x = rng.standard_normal((2,) + MDCT_SHAPE[1:]).astype(np.float32) * 3.0
    ref = rng.standard_normal((2,) + LIN_SHAPE[1:]).astype(np.float32)
    sigma = np.array([4.0, 0.3], np.float32)
    junet = JaxUNet(JaxUNetConfig(**DDEC_KW))
    want = jax.jit(lambda v, a, s, r: junet.apply(v, a, s, None, r))(
        jvars, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(ref))
    tunet = UNet(UNetConfig(**DDEC_KW)).eval()
    load_flat(tunet, _flatten(jvars))
    with torch.no_grad():
        got = tunet(torch.from_numpy(x), torch.from_numpy(sigma), None, torch.from_numpy(ref))
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1)
    assert _rel_max(_np(got) - c_skip * x, np.asarray(want) - c_skip * x) < tol


def test_ddec_weights_round_trip_and_ref_needs_psd():
    """The weight bridge carries a DDEC's parameters: the input conv takes
    2 + 4 x 2 + 1 channels and JAX flat -> port -> flat is the identity.
    An ``x_ref`` given to a UNet without ``in_psd_freqs`` is the inpainting
    reference, concatenated as input channels (JAX unet.py:583-587): without
    the PSD fold a 128-row reference does not fit the sample's 32 rows."""
    flat = _flatten(_jax_ddec_vars())
    tunet = UNet(UNetConfig(**DDEC_KW))
    load_flat(tunet, flat)
    assert tunet.core.enc_conv_in.weight.shape[1] == 11
    back = to_flat(tunet)
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    plain = UNet(UNetConfig(**dict(DDEC_KW, in_psd_freqs=0, add_constant_channel=False)))
    with pytest.raises(RuntimeError):
        plain(torch.zeros(MDCT_SHAPE), torch.ones(1), None, torch.zeros(LIN_SHAPE))


# ---------------------------------------------------------------------------
# (c)-(e) generate on a JAX-written model directory
# ---------------------------------------------------------------------------

def test_generate_auto_takes_the_ddec_as_jax_does(tmp_path):
    """``from_pretrained`` loads a JAX-written directory with a "ddec"
    module and ``generate(decode_mode="auto")`` decodes through it. Both
    packages run the UNet, DAE and DDEC in bf16 and round at different
    places. Stage by stage, each stage fed the JAX stage's output: latents
    to 5e-2 of max after two Heun steps, the DAE's mel to 3e-2, the linear
    PSD (fp32) to 1e-5 relative L2, the DDEC's coefficients after two Heun
    steps to 3e-2 of max, the inverse MDCT (fp32) to 1e-5 relative L2. End
    to end, the mel's bf16 differences pass through the PSD conditioning
    into the coefficients: 6e-2 relative L2 on the mel, and on the audio,
    which is linear in the coefficients."""
    jpipe = _jax_pipeline()
    jpipe.save_pretrained(tmp_path / "model")
    key = jax.random.PRNGKey(8)
    prompt = np.random.default_rng(9).standard_normal((1, 1024)).astype(np.float32)
    jparams = JaxSampleParams(steps=STEPS)
    want = jpipe.generate(jparams, key, prompt_embedding=jnp.asarray(prompt))
    k1, k2, _ = jax.random.split(key, 3)
    jfmt = jpipe.format
    want_lin = jfmt.mel_spec_to_linear(want["sample"])
    want_coeffs, _ = jpipe.diffusion_decode(jparams, k2, sample_shape=MDCT_SHAPE,
                                            x_ref=want_lin, module_name="ddec")
    assert _rel_l2(jfmt.mdct_to_raw(want_coeffs), want["raw"]) <= 1e-6

    init, step_noise = _replayed_noise(k1, (1, 8, 16, 8), STEPS)
    ddec_init, ddec_noise = _replayed_noise(k2, MDCT_SHAPE, STEPS)
    pipe = Pipeline.from_pretrained(tmp_path / "model", device="cpu")
    assert pipe.modules["ddec"].module_type == "ddec"
    params = SampleParams(steps=STEPS)
    timings = {}
    got = pipe.generate(params, prompt_embedding=torch.from_numpy(prompt),
                        init_noise=init, step_noise=step_noise, ddec_init_noise=ddec_init,
                        ddec_step_noise=ddec_noise, timings=timings)
    assert list(timings) == ["sampler", "dae_decode", "ddec", "mdct_to_raw"]
    assert sorted(got) == ["latents", "raw", "sample"]
    assert got["raw"].shape == tuple(want["raw"].shape) == (1, 2, 63 * 32)
    assert torch.isfinite(got["raw"]).all()

    fmt = pipe.format
    with torch.no_grad():
        mel_from_jax_latents = pipe.modules["dae"].module.decode(
            torch.from_numpy(np.array(want["latents"])))
        lin_from_jax_mel = fmt.mel_spec_to_linear(torch.from_numpy(np.array(want["sample"])))
        coeffs_from_jax_lin = pipe.diffusion_decode(
            params, MDCT_SHAPE, init_noise=ddec_init, step_noise=ddec_noise,
            module_name="ddec", x_ref=torch.from_numpy(np.array(want_lin)))
        raw_from_jax_coeffs = fmt.mdct_to_raw(torch.from_numpy(np.array(want_coeffs)))
    # stage by stage, each stage fed the JAX stage's output
    assert _rel_max(_np(got["latents"]), want["latents"]) < 5e-2
    assert _rel_max(_np(mel_from_jax_latents), want["sample"]) < 3e-2
    assert _rel_l2(_np(lin_from_jax_mel), want_lin) <= 1e-5
    assert _rel_max(_np(coeffs_from_jax_lin), want_coeffs) < 3e-2
    assert _rel_l2(_np(raw_from_jax_coeffs), want["raw"]) <= 1e-5
    # end to end
    assert _rel_l2(_np(got["sample"]), want["sample"]) < 6e-2
    assert _rel_l2(_np(got["raw"]), want["raw"]) < 6e-2


def test_generate_auto_without_a_ddec_takes_griffin_lim(tmp_path):
    """Without a "ddec" module, "auto" is "fgla": the same audio as an
    explicit "fgla" decode, and a Griffin-Lim stage in the timings."""
    _jax_pipeline(with_ddec=False).save_pretrained(tmp_path / "model")
    pipe = Pipeline.from_pretrained(tmp_path / "model", device="cpu")
    params = SampleParams(steps=1, num_fgla_iters=2)
    outs = {}
    for mode in ("auto", "fgla"):
        timings = {}
        outs[mode] = pipe.generate(params, torch.Generator().manual_seed(3),
                                   decode_mode=mode, timings=timings)["raw"]
        assert list(timings) == ["sampler", "dae_decode", "fgla"]
    assert torch.equal(outs["auto"], outs["fgla"])


def test_ddec_decode_without_a_ddec_raises_as_jax_does(tmp_path):
    """``decode_mode="ddec"`` on a pipeline without a "ddec" module: JAX
    raises KeyError looking the module up, and so does the port (before it
    samples)."""
    jpipe = _jax_pipeline(with_ddec=False)
    with pytest.raises(KeyError):
        jpipe.generate(JaxSampleParams(steps=1), jax.random.PRNGKey(0), decode_mode="ddec")
    jpipe.save_pretrained(tmp_path / "model")
    pipe = Pipeline.from_pretrained(tmp_path / "model", device="cpu")
    with pytest.raises(KeyError):
        pipe.generate(SampleParams(steps=1), torch.Generator().manual_seed(0),
                      decode_mode="ddec")
