"""The generation options of the port's sampler and models against the JAX
package: img2img entry, the seamless loop (with and without a reference),
chunked and aborted sampling, the debug values, the seamless crossfade and
the stereo fix of ``edm_sample``; the UNet's inpainting reference channels;
and the inpainting conversion and weight blending of ``models/convert.py``.
The pipeline's options are in tests/test_torch_generate_inputs.py.

<-> dualdiffusion_tpu/sampling/sampler.py, models/unet.py ``precondition``
and models/convert.py.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.convert import combine_models as jax_combine_models
from dualdiffusion_tpu.models.convert import convert_unet_to_inpainting as jax_convert
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.pipelines.pipeline import load_module as jax_load_module
from dualdiffusion_tpu.pipelines.pipeline import save_module as jax_save_module
from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu.sampling import edm_sample as jax_edm_sample
from dualdiffusion_tpu.sampling.sampler import _draw_noise as jax_draw_noise
from dualdiffusion_tpu.sampling.sampler import seamless_loop_crossfade as jax_crossfade
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.models.convert import combine_models, convert_unet_to_inpainting
from dualdiffusion_tpu_torch.pipelines.pipeline import load_module
from dualdiffusion_tpu_torch.sampling import SampleParams, edm_sample, seamless_loop_crossfade
from dualdiffusion_tpu_torch.sampling.sampler import draw_noise
from dualdiffusion_tpu_torch.weights import load_flat
from test_torch_training import set_trunk_dtype

SHAPE = (1, 8, 16, 4)
STEPS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float32)


def _rel_max(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _rel_l2(a, b):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    assert a.shape == b.shape
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def replay(key, shape, run_steps, stereo_fix=0.0):
    """The draws JAX ``edm_sample`` makes from ``key``: x_T noise, then per
    step run the re-added noise (after the stereo fix, which the port's
    ``step_noise`` takes) and the seamless-loop shift on W."""
    key, nk = jax.random.split(key)
    init = jax_draw_noise(nk, shape, stereo_fix)
    noise, shifts = [], []
    for _ in range(run_steps):
        key, k_noise, k_shift = jax.random.split(key, 3)
        noise.append(torch.from_numpy(np.array(jax_draw_noise(k_noise, shape, stereo_fix))))
        shifts.append(int(jax.random.randint(k_shift, (), 0, shape[-2])))
    return torch.from_numpy(np.array(init)), noise, shifts


def _denoise(xp, x, sigma, ref=None):
    """A smooth stand-in for D(x; sigma) whose two CFG halves differ and whose
    output depends on the reference and on the position along W."""
    b = SHAPE[0]
    scale = xp.asarray([1.0] * b + [0.6] * (x.shape[0] - b), dtype=xp.float32)
    s = sigma.reshape(-1, 1, 1, 1)
    out = x / (1.0 + s * s) * scale.reshape(-1, 1, 1, 1) + 0.1 * xp.sin(x)
    if ref is not None:
        out = out + 0.3 * xp.tanh(ref[..., : x.shape[-1]])
    return out


def _port_denoise(x, s, ref=None):
    return _denoise(torch, x, s, ref)


def _jax_denoise(x, s, ref=None):
    return _denoise(jnp, x, s, ref)


# ---------------------------------------------------------------------------
# edm_sample: fp32 throughout, 1e-5 of max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strength", [0.0, 0.3, 0.5, 1.0])
def test_img2img_init_sample_matches_jax(strength):
    """img2img enters the schedule at ``steps - round(steps * strength)``
    and runs only that many steps' draws; strength 0 runs none and returns
    the init sample with sigma_min's noise, normalized. The debug values
    come along."""
    key = jax.random.PRNGKey(7)
    init_sample = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    jparams = JaxSampleParams(steps=STEPS, img2img_strength=strength)
    want, jdbg = jax_edm_sample(_jax_denoise, SHAPE, jparams, 200.0, 0.03, 1.0, key,
                                init_sample=jnp.asarray(init_sample))
    run_steps = int(round(STEPS * strength))
    init, noise, _ = replay(key, SHAPE, run_steps)
    dbg = {}
    got = edm_sample(_port_denoise, SHAPE, SampleParams(steps=STEPS, img2img_strength=strength),
                     200.0, 0.03, 1.0, init_sample=torch.from_numpy(init_sample),
                     init_noise=init, step_noise=noise, debug=dbg)
    assert _rel_max(got, want) <= 1e-5
    np.testing.assert_array_equal(dbg["sigma_schedule"], jdbg["sigma_schedule"])
    assert sorted(dbg) == sorted(jdbg)
    for k in ("sample_std", "cfg_output_mean", "cfg_output_std"):
        if run_steps:
            assert dbg[k].shape == (run_steps,)
            np.testing.assert_allclose(_np(dbg[k]), np.asarray(jdbg[k]), rtol=1e-4, atol=1e-6)
    if strength == 0.0:
        # the init sample plus noise at the schedule's last sigma (sigma_min
        # 0.03 of sigma_data 1), normalized: 0.05 relative L2 of it
        want0 = init_sample / (1e-4 + np.sqrt(np.mean(init_sample ** 2)))
        assert 0.01 < _rel_l2(got, want0) <= 0.05


@pytest.mark.parametrize("with_ref,use_cfg", [(False, True), (True, True), (True, False)])
def test_seamless_loop_matches_jax(with_ref, use_cfg):
    """Each step rolls the sample (and the reference, which the denoiser
    adds in) by JAX's shift, pads it circularly by 32 columns (more than W
    = 16: the pad wraps twice), and crops and un-rolls the result."""
    key = jax.random.PRNGKey(8)
    ref = (np.random.default_rng(2).standard_normal((SHAPE[0] * (1 + use_cfg),) + SHAPE[1:])
           .astype(np.float32) if with_ref else None)
    kw = dict(steps=STEPS, seamless_loop=True)
    want, _ = jax_edm_sample(_jax_denoise, SHAPE, JaxSampleParams(**kw), 200.0, 0.03, 1.0, key,
                             use_cfg=use_cfg,
                             x_ref=None if ref is None else jnp.asarray(ref))
    init, noise, shifts = replay(key, SHAPE, STEPS)
    assert len(set(shifts)) > 1
    got = edm_sample(_port_denoise, SHAPE, SampleParams(**kw), 200.0, 0.03, 1.0,
                     init_noise=init, step_noise=noise, step_shifts=shifts, use_cfg=use_cfg,
                     x_ref=None if ref is None else torch.from_numpy(ref))
    assert _rel_max(got, want) <= 1e-5


def test_seamless_loop_draws_its_shifts_from_the_generator():
    """Without ``step_shifts`` the shifts come from the generator: same
    seed, same sample; the roll moves the sample (another result than
    without the loop)."""
    def run(seed, loop=True):
        return edm_sample(_port_denoise, SHAPE, SampleParams(steps=3, seamless_loop=loop),
                          200.0, 0.03, 1.0, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(0, loop=False)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()


def test_chunked_and_aborted_sampling_match_jax():
    """Chunks of 2 over 5 steps call back after steps 2, 4 and 5 with the
    un-normalized sample, as JAX's chunked scan does, and give the unchunked
    result; a callback that returns True after the first chunk stops the
    run, whose partial sample (normalized) agrees with JAX's."""
    key = jax.random.PRNGKey(9)
    init, noise, _ = replay(key, SHAPE, STEPS)
    params = SampleParams(steps=STEPS)
    whole = edm_sample(_port_denoise, SHAPE, params, 200.0, 0.03, 1.0, init_noise=init,
                       step_noise=noise)
    calls, jcalls = [], []

    def record(to):
        return lambda n, s: to.append((n, _np(s).copy())) and False
    chunked = edm_sample(_port_denoise, SHAPE, params, 200.0, 0.03, 1.0, init_noise=init,
                         step_noise=noise, chunk_size=2, chunk_callback=record(calls))
    assert torch.equal(chunked, whole)
    jax_edm_sample(_jax_denoise, SHAPE, JaxSampleParams(steps=STEPS), 200.0, 0.03, 1.0, key,
                   chunk_size=2, chunk_callback=record(jcalls))
    assert [n for n, _ in calls] == [n for n, _ in jcalls] == [2, 4, 5]
    for (_, s), (_, js) in zip(calls, jcalls):
        assert _rel_max(s, js) <= 1e-5

    def stop(n, s):
        return True
    want, jdbg = jax_edm_sample(_jax_denoise, SHAPE, JaxSampleParams(steps=STEPS), 200.0, 0.03,
                                1.0, key, chunk_size=2, chunk_callback=stop)
    dbg = {}
    got = edm_sample(_port_denoise, SHAPE, params, 200.0, 0.03, 1.0, init_noise=init,
                     step_noise=noise, chunk_size=2, chunk_callback=stop, debug=dbg)
    assert _rel_max(got, want) <= 1e-5
    assert dbg["sample_std"].shape == jdbg["sample_std"].shape == (2,)
    # one chunk holding every step calls nothing back, as in JAX
    none = []
    edm_sample(_port_denoise, SHAPE, params, 200.0, 0.03, 1.0, init_noise=init,
               step_noise=noise, chunk_size=STEPS, chunk_callback=lambda n, s: none.append(n))
    assert none == []


@pytest.mark.parametrize("length", [40000, 24192])
def test_seamless_loop_crossfade_matches_jax(length):
    """The crossfade of a (2, 2, length) loop at hop 256: 16,128 samples
    shorter, fp32 to 1e-6 of max, down to 1.5 x 16,128 samples, where the
    two blended ends meet. Shorter audio raises (JAX's scatter drops what
    does not fit and returns what it has)."""
    raw = np.random.default_rng(3).standard_normal((2, 2, length)).astype(np.float32)
    want = jax_crossfade(jnp.asarray(raw), 256)
    got = seamless_loop_crossfade(torch.from_numpy(raw), 256)
    assert got.shape == tuple(want.shape) == (2, 2, length - int(31.5 * 256) * 2)
    assert _rel_max(got, want) <= 1e-6
    with pytest.raises(ValueError, match="24192 samples"):
        seamless_loop_crossfade(torch.from_numpy(raw[..., :24191]), 256)


def test_stereo_fix_matches_jax_draw_noise(monkeypatch):
    """``draw_noise`` with the stereo fix against JAX ``_draw_noise``: the
    same two normal draws (JAX's ``split(key)`` pair, fed to the port's
    ``torch.randn`` in the order it draws) give the same correlated noise;
    and ``edm_sample`` drawing every noise that way reproduces JAX's sampler
    with ``stereo_fix`` 0.5 (1e-5 of max)."""
    shape = (1, 8, 16, 2)
    queue = []

    def fake_randn(size, generator=None, device=None):
        a = queue.pop(0)
        assert tuple(a.shape) == tuple(size)
        return torch.from_numpy(np.array(a))

    def queue_draws(key):
        k1, k2 = jax.random.split(key)
        queue.extend([jax.random.normal(k1, shape, jnp.float32),
                      jax.random.normal(k2, shape, jnp.float32)])

    monkeypatch.setattr(torch, "randn", fake_randn)
    key = jax.random.PRNGKey(10)
    queue_draws(key)
    got = draw_noise(shape, 0.5, torch.Generator(), "cpu")
    assert not queue
    assert _rel_max(got, jax_draw_noise(key, shape, 0.5)) <= 1e-6
    assert not np.allclose(_np(got)[..., 0], _np(got)[..., 1])

    key, nk = jax.random.split(jax.random.PRNGKey(11))
    queue_draws(nk)
    for _ in range(3):
        key, k_noise, _ = jax.random.split(key, 3)
        queue_draws(k_noise)
    params = dict(steps=3, stereo_fix=0.5)

    def den(xp):
        return lambda x, s: x / (1.0 + s.reshape(-1, 1, 1, 1) ** 2) + 0.1 * xp.sin(x)
    want, _ = jax_edm_sample(den(jnp), shape, JaxSampleParams(**params), 200.0, 0.03, 1.0,
                             jax.random.PRNGKey(11), use_cfg=False)
    got = edm_sample(den(torch), shape, SampleParams(**params), 200.0, 0.03, 1.0,
                     generator=torch.Generator(), use_cfg=False)
    assert not queue
    assert _rel_max(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the UNet's inpainting reference channels and the conversion
# ---------------------------------------------------------------------------

INP_KW = dict(in_channels=4, out_channels=4, model_channels=16, channel_mult=(1, 2),
              num_layers_per_block=1, channels_per_head=16, logvar_channels=32,
              mlp_multiplier=2, mlp_groups=2)


def _gains(variables, seed):
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        return (jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
                if leaf.ndim == 0 and "gain" in getattr(path[-1], "key", "") else leaf)
    return jax.tree_util.tree_map_with_path(fix, variables)


@functools.lru_cache(maxsize=None)
def _jax_unet_vars(in_channels):
    cfg = JaxUNetConfig(**dict(INP_KW, in_channels=in_channels))
    v = jax.jit(lambda k: JaxUNet(cfg).init(k, jnp.zeros((1, 8, 16, 4)), jnp.ones((1,)), None,
                                            None if in_channels == 4 else
                                            jnp.zeros((1, 8, 16, in_channels - 4)),
                                            method=JaxUNet.init_all))(jax.random.PRNGKey(12))
    return cfg, _gains(v, 13)


@pytest.mark.parametrize("trunk,tol", [("bfloat16", 3e-2), ("float32", 1e-4)])
def test_unet_forward_with_reference_and_mask_matches_jax(monkeypatch, trunk, tol):
    """A UNet with 4 + 4 + 1 inputs on JAX weights, fed the reference and
    mask channels: D(x) - c_skip x to 3e-2 of max in the bf16 trunk, 1e-4 in
    an fp32 trunk."""
    set_trunk_dtype(monkeypatch, trunk)
    cfg, jvars = _jax_unet_vars(9)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 8, 16, 4)).astype(np.float32) * 3.0
    ref = rng.standard_normal((2, 8, 16, 5)).astype(np.float32)
    sigma = np.array([4.0, 0.3], np.float32)
    want = jax.jit(lambda v, a, s, r: JaxUNet(cfg).apply(v, a, s, None, r))(
        jvars, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(ref))
    unet = UNet(UNetConfig(**dict(INP_KW, in_channels=9))).eval()
    load_flat(unet, _flatten(jvars))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(sigma), None, torch.from_numpy(ref))
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1)
    assert _rel_max(_np(got) - c_skip * x, np.asarray(want) - c_skip * x) < tol


def _write_jax_unet_dir(path):
    cfg, jvars = _jax_unet_vars(4)
    jax_save_module(path, "unet", "unet", cfg, jvars)
    (path / "model_index.json").write_text(json.dumps({"modules": {"unet": "unet"}}))


def test_convert_unet_to_inpainting_matches_jax(tmp_path, monkeypatch):
    """The port's and JAX's conversions of one JAX-written UNet write the
    same config, the same model index and the same weights (the input conv
    grown by 4 + 1 zero channels); each package loads the other's. With a
    zero reference the converted UNet computes what JAX's converted UNet
    computes (fp32 trunk, 1e-4 of max). That is the original's output only
    up to the input conv's inference scale 1 / sqrt(fan_in), which the
    extra channels change (both packages skip the weight normalization at
    inference): the converted UNet equals the original with its input conv
    scaled by sqrt(4 / 9) (1e-4), and equals the original itself when the
    output gain is zero, as JAX tests/test_models_extra.py:96 holds it."""
    set_trunk_dtype(monkeypatch, "float32")
    for d in ("jax", "port"):
        _write_jax_unet_dir(tmp_path / d)
    jax_convert(tmp_path / "jax")
    out = convert_unet_to_inpainting(tmp_path / "port")
    assert out == tmp_path / "port" / "unet_inpainting"
    for f in ("model_index.json", "unet_inpainting/unet_inpainting.json"):
        assert json.loads((tmp_path / "port" / f).read_text()) == \
            json.loads((tmp_path / "jax" / f).read_text())
    _, jcfg, jvars = jax_load_module(tmp_path / "port", "unet_inpainting")
    _, _, jvars_jax = jax_load_module(tmp_path / "jax", "unet_inpainting")
    fa, fb = _flatten(jvars), _flatten(jvars_jax)
    assert sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert jcfg.in_channels == 9
    _, cfg, conv = load_module(tmp_path / "jax", "unet_inpainting", "cpu")
    _, _, orig = load_module(tmp_path / "jax", "unet", "cpu")
    assert cfg.in_channels == 9 and conv.core.enc_conv_in.w_mp.shape[1] == 9

    x = np.random.default_rng(15).standard_normal((1, 8, 16, 4)).astype(np.float32)
    zero_ref = np.zeros((1, 8, 16, 5), np.float32)
    sigma = np.array([1.0], np.float32)
    want = jax.jit(lambda v, a, sg, r: JaxUNet(jcfg).apply(v, a, sg, None, r))(
        jvars_jax, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(zero_ref))
    args = (torch.from_numpy(x), torch.from_numpy(sigma))
    with torch.no_grad():
        y_new = conv(*args, None, torch.from_numpy(zero_ref))
        assert _rel_max(y_new, want) <= 1e-4
        orig.core.enc_conv_in.w_mp.mul_((4 / 9) ** 0.5)
        assert _rel_max(y_new, orig(*args)) <= 1e-4
        orig.core.enc_conv_in.w_mp.mul_((9 / 4) ** 0.5)
        assert _rel_max(y_new, orig(*args)) > 1e-2
        for m in (conv, orig):
            m.core.out_gain.zero_()
        assert _rel_max(conv(*args, None, torch.from_numpy(zero_ref)), orig(*args)) <= 1e-6


def test_combine_models_matches_jax(tmp_path):
    """(1 - t) A + t B of two JAX-written UNets: the same weights from both
    packages (fp32, to 1 ulp)."""
    _write_jax_unet_dir(tmp_path / "a")
    cfg, jvars = _jax_unet_vars(4)
    b_vars = jax.tree_util.tree_map(lambda v: v * 1.5 + 0.25, jvars)
    jax_save_module(tmp_path / "b", "unet", "unet", cfg, b_vars)
    jax_combine_models(tmp_path / "a", tmp_path / "b", "unet", 0.3, tmp_path / "out_jax")
    combine_models(tmp_path / "a", tmp_path / "b", "unet", 0.3, tmp_path / "out_port")
    _, _, want = jax_load_module(tmp_path / "out_jax", "unet")
    _, _, got = jax_load_module(tmp_path / "out_port", "unet")
    fa, fb = _flatten(got), _flatten(want)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=2e-7, atol=1e-7)
