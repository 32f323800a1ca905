"""The stereo-folded 3-D UNet of the port against the JAX package on the CPU:
rank-3 MPConv (the stereo wrap, Z padding, W reflect padding, groups),
``resample_3d``, the tiny d1 UNet (tests/test_reference_parity.py) with
"full", "freq" and "time" attention and the ln-freq channel, dropout, the
latent shape and one rank-5 train step, on weights initialised by JAX and
carried over by ``dualdiffusion_tpu_torch.weights``.

<-> dualdiffusion_tpu/models/layers.py:531-625, mp.py:136, unet.py:115-709.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models import layers as jlayers
from dualdiffusion_tpu.models import mp as jmp
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.sigma_sampler import SigmaSampler as JaxSigmaSampler
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import UNetTrainConfig as JaxUNetTrainConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu.training.train_state import make_unet_train_step as jax_make_step
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.models import layers as tlayers
from dualdiffusion_tpu_torch.models import mp as tmp
from dualdiffusion_tpu_torch.models.unet import mp_dropout
from dualdiffusion_tpu_torch.training import (SigmaSamplerConfig, UNetTrainConfig,
                                              build_optimizer, draw_unet_step,
                                              init_train_state, make_unet_train_step)
from dualdiffusion_tpu_torch.training.sigma_sampler import SigmaSampler
from dualdiffusion_tpu_torch.weights import load_flat, to_flat
from test_torch_train_step import _jax_draws
from test_torch_training import set_trunk_dtype

#: the d1 options of tests/test_reference_parity.py (the JAX UNet against
#: the reference's unet_edm2_d1), "full" attention at level 1
D1_KW = dict(in_channels=4, out_channels=4, in_channels_emb=16, in_num_freqs=8,
             model_channels=8, channel_mult=(1, 2), channel_mult_noise=2,
             channel_mult_emb=2, channels_per_head=8, num_layers_per_block=1,
             attn_levels=(1,), attn_axis="full", mlp_multiplier=2, mlp_groups=2,
             emb_linear_groups=2, logvar_channels=16, double_midblock=True,
             midblock_attn=True, use_3d=True, io_kernel_z=2, conv_w_pad="reflect",
             io_bias=False, always_skip=True, add_constant_channel=True,
             add_ln_freqs_channel=True)
X_SHAPE = (2, 2, 8, 12, 4)          # (B, Z, H, W, C)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# ---------------------------------------------------------------------------
# MPConv rank 3 and resample_3d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("pad", ["zeros", "reflect"])
@pytest.mark.parametrize("kernel", [(1, 3, 3), (2, 3, 3), (3, 3, 3), (2, 1, 1), (1, 1, 1)])
def test_mpconv_rank3_matches_jax(kernel, pad, groups):
    """fp32 on both sides: float rounding, 1e-5 of max. The input's Z is 2
    (stereo), W 7 (odd, so reflect padding shows at both edges); the
    weights are JAX's, scaled so the training-time weight norm matters."""
    rng = np.random.default_rng(sum(kernel) + 7 * groups)
    x = rng.standard_normal((2, 2, 5, 7, 8)).astype(np.float32)
    jm = jlayers.MPConv(8, 12, kernel, groups=groups, w_pad_mode=pad, use_bias=True)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros(x.shape))
    variables = jax.tree_util.tree_map(lambda a: a * 3.0, variables)
    tm = tlayers.MPConv(8, 12, kernel, groups=groups, w_pad_mode=pad, use_bias=True)
    load_flat(tm, _flatten(variables))
    for training in (False, True):
        want = jm.apply(variables, jnp.asarray(x), training=training)
        got = tm(torch.from_numpy(x), training=training)
        assert got.shape == want.shape
        assert _rel_err(got.detach().numpy(), want) < 1e-5


def test_mpconv_2d_reflect_pads_with_zeros_as_jax():
    """JAX pads W by reflection in 3D convs only; a 2D conv with
    ``w_pad_mode="reflect"`` pads with zeros (layers.py:524-530), and so
    does the port."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 9, 8)).astype(np.float32)
    jm = jlayers.MPConv(8, 8, (3, 3), w_pad_mode="reflect")
    variables = jm.init(jax.random.PRNGKey(2), jnp.zeros(x.shape))
    tm = tlayers.MPConv(8, 8, (3, 3), w_pad_mode="reflect")
    load_flat(tm, _flatten(variables))
    zeros = tlayers.MPConv(8, 8, (3, 3))
    load_flat(zeros, _flatten(variables))
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        assert torch.equal(got, zeros(torch.from_numpy(x)))
    assert _rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("mode", ["keep", "down", "up"])
def test_resample_3d_matches_jax(mode):
    x = np.random.default_rng(3).standard_normal((2, 2, 6, 10, 3)).astype(np.float32)
    want = jmp.resample_3d(jnp.asarray(x), mode)
    got = tmp.resample_3d(torch.from_numpy(x), mode)
    assert got.shape == want.shape and got.shape[1] == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the tiny d1 UNet
# ---------------------------------------------------------------------------

def _nonzero_gains(variables, seed):
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        name = getattr(path[-1], "key", "")
        if leaf.ndim == 0 and "gain" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fix, variables)


@functools.lru_cache(maxsize=None)
def _jax_d1_vars():
    """One init serves every attention axis: the parameters are the same."""
    unet = JaxUNet(JaxUNetConfig(**D1_KW))
    v = jax.jit(lambda k: unet.init(k, jnp.zeros(X_SHAPE), jnp.ones((2,)), jnp.zeros((2, 16)),
                                    method=JaxUNet.init_all))(jax.random.PRNGKey(0))
    return _nonzero_gains(v, 0)


def _inputs():
    rng = np.random.default_rng(41)
    x = rng.standard_normal(X_SHAPE).astype(np.float32) * 2.0
    emb_in = rng.standard_normal((2, 16)).astype(np.float32)
    sigma = np.array([3.0, 0.5], np.float32)
    ln_freqs = np.log2(np.linspace(40.0, 8000.0, X_SHAPE[2])).astype(np.float32)
    return x, emb_in, sigma, ln_freqs


def _d1_pair(**overrides):
    junet = JaxUNet(JaxUNetConfig(**{**D1_KW, **overrides}))
    tunet = UNet(UNetConfig(**{**D1_KW, **overrides})).eval()
    load_flat(tunet, _flatten(_jax_d1_vars()))
    return junet, tunet


@pytest.mark.parametrize("pass_ln_freqs", [True, False])
@pytest.mark.parametrize("axis", ["full", "freq", "time"])
def test_d1_unet_matches_jax(axis, pass_ln_freqs):
    """bf16 trunks on both sides, which round at different places (JAX's CPU
    grouped convs sum their taps in bf16): the network branch (output minus
    c_skip * x) to 3e-2 of its max, as the 2-D UNet test; embeddings (fp32)
    to 1e-5."""
    junet, tunet = _d1_pair(attn_axis=axis)
    jvars = _jax_d1_vars()
    x, emb_in, sigma, ln_freqs = _inputs()
    lf = ln_freqs if pass_ln_freqs else None
    j_emb = junet.apply(jvars, jnp.asarray(emb_in), jnp.ones((2,)), method=JaxUNet.get_embeddings)
    want = jax.jit(lambda v, a, s, e, f: junet.apply(v, a, s, e, ln_freqs=f))(
        jvars, jnp.asarray(x), jnp.asarray(sigma), j_emb,
        None if lf is None else jnp.asarray(lf))
    with torch.no_grad():
        t_emb = tunet.get_embeddings(torch.from_numpy(emb_in), torch.ones(2))
        got = tunet(torch.from_numpy(x), torch.from_numpy(sigma), t_emb,
                    ln_freqs=None if lf is None else torch.from_numpy(lf))
    assert _rel_err(t_emb.numpy(), j_emb) < 1e-5
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1, 1)
    assert got.shape == X_SHAPE and got.dtype == torch.float32
    assert _rel_err(got.numpy() - c_skip * x, np.asarray(want) - c_skip * x) < 3e-2


def test_d1_unet_fp32_trunk_matches_jax(monkeypatch):
    """Both trunks in fp32: float rounding alone, 1e-4 of max."""
    set_trunk_dtype(monkeypatch, "float32")
    junet, tunet = _d1_pair(attn_axis="freq")
    jvars = _jax_d1_vars()
    x, emb_in, sigma, ln_freqs = _inputs()
    j_emb = junet.apply(jvars, jnp.asarray(emb_in), jnp.ones((2,)), method=JaxUNet.get_embeddings)
    want = jax.jit(junet.apply)(jvars, jnp.asarray(x), jnp.asarray(sigma), j_emb)
    with torch.no_grad():
        got = tunet(torch.from_numpy(x), torch.from_numpy(sigma),
                    tunet.get_embeddings(torch.from_numpy(emb_in), torch.ones(2)))
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1, 1)
    assert _rel_err(got.numpy() - c_skip * x, np.asarray(want) - c_skip * x) < 1e-4


def test_unported_fields_are_only_the_tpu_ones():
    """W-packing alone is refused; ``remat_blocks`` builds, with dropout too."""
    UNet(UNetConfig(**D1_KW, dropout=0.1))
    UNet(UNetConfig(**{**D1_KW, "use_3d": False, "conv_w_pad": "reflect"}))
    assert UNet(UNetConfig(**D1_KW, dropout=0.1, remat_blocks=True)).cfg.remat_blocks
    with pytest.raises(NotImplementedError):
        UNet(UNetConfig(**{**D1_KW, "w_pack_channels": 128}))


@pytest.mark.parametrize("shape", [(3, 37, 70, 4), (2, 2, 37, 70, 4)])
def test_get_latent_shape_matches_jax(shape):
    cfg = dict(D1_KW, channel_mult=(1, 2, 3))
    want = JaxUNet(JaxUNetConfig(**cfg)).get_latent_shape(shape)
    got = UNet(UNetConfig(**cfg)).get_latent_shape(shape)
    assert got == tuple(want)
    assert got[-3:-1] == (36, 68)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_mp_dropout_matches_jax_on_a_given_mask():
    """JAX unet.py:264 on one keep mask, in fp32 (XLA may fuse the bf16 trunk's
    two roundings into one): float rounding, 1e-6."""
    rng = np.random.default_rng(6)
    y = rng.standard_normal((2, 2, 4, 6, 8)).astype(np.float32)
    keep = rng.uniform(size=y.shape) < 0.8
    jy = jnp.asarray(y)
    want = jnp.where(jnp.asarray(keep), jy / (1.0 - 0.2), 0.0) * (1.0 - 0.2) ** 0.5
    got = mp_dropout(torch.from_numpy(y), 0.2, torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert mp_dropout(torch.from_numpy(y).bfloat16(), 0.2,
                      torch.from_numpy(keep)).dtype == torch.bfloat16


def test_dropout_is_off_outside_training_and_drawn_from_the_generator():
    """At training=False a dropout model equals JAX's (which drops nothing
    then either) and the same model without dropout; in training its masks
    come from ``dropout_generator``: one seed, one output."""
    jvars = _jax_d1_vars()
    junet, tunet = _d1_pair(attn_axis="time", dropout=0.25)
    _, plain = _d1_pair(attn_axis="time")
    x, emb_in, sigma, _ = _inputs()
    want = jax.jit(junet.apply)(jvars, jnp.asarray(x), jnp.asarray(sigma), None)
    xt, st = torch.from_numpy(x), torch.from_numpy(sigma)
    with torch.no_grad():
        got = tunet(xt, st)
        assert torch.equal(got, plain(xt, st))

        def train(seed):
            return tunet(xt, st, training=True,
                         dropout_generator=torch.Generator().manual_seed(seed))
        a, b, c = train(1), train(1), train(2)
    c_skip = (1.0 / (sigma ** 2 + 1.0)).reshape(-1, 1, 1, 1, 1)
    assert _rel_err(got.numpy() - c_skip * x, np.asarray(want) - c_skip * x) < 3e-2
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_step_dropout_draws_replay():
    """The train step draws a dropout seed per microbatch when the model
    drops out; the same draws give the same step."""
    tc = UNetTrainConfig(sigma=SigmaSamplerConfig(), grad_accum_steps=1)
    batch = {"samples": torch.from_numpy(
        np.random.default_rng(8).standard_normal(X_SHAPE).astype(np.float32))}
    sampler = SigmaSampler(tc.sigma)
    draws = draw_unet_step(torch.Generator().manual_seed(3), sampler, tc, 2, X_SHAPE, False, 0,
                           dropout=True)
    assert draws.micro[0].dropout_seed is not None
    losses = []
    for _ in range(2):
        model = UNet(UNetConfig(**{**D1_KW, "in_channels_emb": 0, "dropout": 0.2}))
        model.init_weights(torch.Generator().manual_seed(0))
        opt = build_optimizer("adamw", model.parameters(), 1e-3)
        state = init_train_state(model, opt, None, tc.sigma, torch.Generator())
        losses.append(float(make_unet_train_step(opt, None, tc, 2)(state, batch, draws)["loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


# ---------------------------------------------------------------------------
# one rank-5 train step
# ---------------------------------------------------------------------------

def test_rank5_train_step_matches_jax(monkeypatch):
    """One step of the tiny d1 UNet on (B, Z, H, W, C) samples with "freq"
    attention, conditioning dropout and perturbation and input
    perturbation, gradient accumulation 2, fp32 trunks, the port fed JAX's
    draws: loss and grad norm to 1e-5 relative, params to lr/20 (as the
    2-D step's test)."""
    set_trunk_dtype(monkeypatch, "float32")
    cfg = dict(D1_KW, attn_axis="freq")
    junet = JaxUNet(JaxUNetConfig(**cfg))
    jvars = _jax_d1_vars()
    lr, n = 1e-3, 4
    kw = dict(conditioning_dropout=0.25, conditioning_perturbation=0.05,
              input_perturbation=0.3, grad_accum_steps=2, num_loss_buckets=4)
    jtc = JaxUNetTrainConfig(sigma=JaxSigmaConfig(), **kw)
    jopt = joptim.build_optimizer("adamw", lr)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])

    def unet_apply(p, x, sigma, emb, ref, k, x_perturbed=None):
        return junet.apply(p, x, sigma, emb, training=True, x_perturbed=x_perturbed)

    jstep = jax.jit(jax_make_step(
        unet_apply, lambda p, e, m: junet.apply(p, e, m, method=JaxUNet.get_embeddings),
        lambda p, s: junet.apply(p, s, method=JaxUNet.get_sigma_loss_logvar),
        jopt, jbank, jtc, n))
    jstate = jax_init_train_state(jvars, jopt, jbank, jtc.sigma, jax.random.PRNGKey(3))

    model = UNet(UNetConfig(**cfg))
    load_flat(model, _flatten(jvars))
    opt = build_optimizer("adamw", model.parameters(), lr)
    tc = UNetTrainConfig(sigma=SigmaSamplerConfig(), **kw)
    tstep = make_unet_train_step(opt, None, tc, n)
    tstate = init_train_state(model, opt, None, tc.sigma, torch.Generator())

    rng = np.random.default_rng(12)
    shape = (n,) + X_SHAPE[1:]
    batch = {"samples": rng.standard_normal(shape).astype(np.float32),
             "embeddings": rng.standard_normal((n, 16)).astype(np.float32)}
    _, draws = _jax_draws(jstate.rng, JaxSigmaSampler(jtc.sigma), jtc, n,
                          (n // 2,) + shape[1:], (n // 2, 32))
    jstate, jlogs = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tlogs = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    for name in ("loss", "grad_norm"):
        assert abs(float(tlogs[name]) - float(jlogs[name])) <= 1e-5 * abs(float(jlogs[name]))
    want_p, got_p = _flatten(jstate.params), to_flat(model)
    assert set(want_p) == set(got_p)
    for k in want_p:
        assert np.abs(got_p[k] - want_p[k]).max() <= lr / 20, k


def test_d1_weights_carry_across_name_for_name():
    """The JAX d1 tree through ``load_flat`` and back through ``to_flat``:
    every name, shape and value, rank-5 conv weights included, and no bias
    on the in conv (``io_bias=False``)."""
    flat = _flatten(_jax_d1_vars())
    model = UNet(UNetConfig(**D1_KW))
    load_flat(model, flat)
    got = to_flat(model)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v).reshape(got[k].shape), err_msg=k)
        assert got[k].shape == np.asarray(v).shape, k
    assert got["params/core/enc_conv_in/w_mp"].shape == (8, 6, 2, 3, 3)
    assert "params/core/enc_conv_in/bias" not in got
