"""Parity of the port's primitive library with the JAX package, on the CPU:
the MP and spectral functions of ``models/mp.py``, the filtered resamplers,
``normalize_weight``, ``AdaptiveGroupBalance`` (with its weights carried
through ``weights.load_flat`` / ``to_flat``) and ``FilteredDownsample2D``
of ``models/layers.py``, MPConv's per-sample gains (forward and the gain's
gradient in training, tensor-parallel and FSDP over two gloo ranks),
``register_module``, ``stft_num_frames`` and ``custom_collate``.

The same numpy inputs (from a seed) go through both packages in fp32; the
outputs agree to 1e-5 of their largest magnitude. Random functions replay
JAX's key splits and take the draws.

<-> dualdiffusion_tpu/models/mp.py, layers.py, tests/test_mp.py.
"""

import inspect
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dualdiffusion_tpu.models as jmodels
import dualdiffusion_tpu_torch.models as tmodels
import dualdiffusion_tpu_torch.pipelines.pipeline as tpipeline
import torch_parallel_ranks as ranks
from dualdiffusion_tpu.dataset.dataloader import custom_collate as jax_custom_collate
from dualdiffusion_tpu.models import layers as jlayers
from dualdiffusion_tpu.models import mp as jmp
from dualdiffusion_tpu.ops.stft import stft_num_frames as jax_stft_num_frames
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.dataset import custom_collate
from dualdiffusion_tpu_torch.models import layers as tlayers
from dualdiffusion_tpu_torch.models import mp as tmp
from dualdiffusion_tpu_torch.ops import stft_num_frames
from dualdiffusion_tpu_torch.pipelines import (ModuleHandle, Pipeline, get_module_class,
                                               register_module)
from dualdiffusion_tpu_torch.weights import load_flat, to_flat

TOL = 1e-5
KEY = jax.random.PRNGKey(7)
T_G = np.array([0.1, 0.35, 0.6, 0.9], np.float32)
T_BG = np.array([[0.2, 0.5, 0.7, 0.4], [0.9, 0.15, 0.3, 0.6]], np.float32)
X4, X5, X3 = (2, 8, 12, 8), (2, 2, 8, 12, 8), (2, 16, 6)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, err


def _hp_draws(shape):
    """JAX ``randn_like_hp_2d``'s draws for an input of ``shape``."""
    kr, ki = jax.random.split(KEY)
    half = shape[:-3] + (shape[-3], shape[-2] // 2 + 1, shape[-1])
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, half, jnp.float32)))
                 for k in (kr, ki))


def _crop_draws(b, range_h, range_w, dropout):
    """JAX ``random_crop_2d``'s draws: (keep, h, w)."""
    kd, kh, kw = jax.random.split(KEY, 3)
    keep = jax.random.uniform(kd, (b,)) >= dropout
    h = jax.random.randint(kh, (b,), 0, max(range_h, 1))
    w = jax.random.randint(kw, (b,), 0, max(range_w, 1))
    return tuple(torch.from_numpy(np.array(a)) for a in (keep, h, w))


def _flt(name, **kw):
    """A filtered resampler of both packages, by name, with keywords."""
    return (lambda x: getattr(jlayers, name)(x, **kw),
            lambda x: getattr(tlayers, name)(x, **kw))


def _fd2d(kernel, stride):
    return (lambda x: jlayers.FilteredDownsample2D(kernel, stride).apply({}, x),
            lambda x: tlayers.FilteredDownsample2D(kernel, stride)(x))


#: name -> (JAX function, port function, input shapes); each function takes
#: its inputs as arrays of its own package and returns an array or a tuple
FUNCTIONS = {
    "mp_sum_groups_t_g": (lambda a, b: jmp.mp_sum_groups(a, b, jnp.asarray(T_G), 4),
                          lambda a, b: tmp.mp_sum_groups(a, b, torch.from_numpy(T_G), 4),
                          [X4, X4]),
    "mp_sum_groups_t_bg": (lambda a, b: jmp.mp_sum_groups(a, b, jnp.asarray(T_BG), 4),
                           lambda a, b: tmp.mp_sum_groups(a, b, torch.from_numpy(T_BG), 4),
                           [X4, X4]),
    "mp_sum_groups_5d": (lambda a, b: jmp.mp_sum_groups(a, b, jnp.asarray(T_BG), 4),
                         lambda a, b: tmp.mp_sum_groups(a, b, torch.from_numpy(T_BG), 4),
                         [X5, X5]),
    "mp_cat_interleave": (lambda a, b: jmp.mp_cat_interleave(a, b, t=0.3),
                          lambda a, b: tmp.mp_cat_interleave(a, b, t=0.3), [X4, X4]),
    "mp_cat_interleave_dim1": (lambda a, b: jmp.mp_cat_interleave(a, b, axis=1),
                               lambda a, b: tmp.mp_cat_interleave(a, b, dim=1), [X4, X4]),
    "resample_1d_down": (lambda x: jmp.resample_1d(x, "down"),
                         lambda x: tmp.resample_1d(x, "down"), [X3]),
    "resample_1d_up": (lambda x: jmp.resample_1d(x, "up"),
                       lambda x: tmp.resample_1d(x, "up"), [X3]),
    "patchify_2d": (lambda x: jmp.patchify_2d(x, 2, 3),
                    lambda x: tmp.patchify_2d(x, 2, 3), [X4]),
    "unpatchify_2d": (lambda x: jmp.unpatchify_2d(x, 2, 4),
                      lambda x: tmp.unpatchify_2d(x, 2, 4), [(2, 4, 3, 16)]),
    "space_to_channel_2d": (jmp.space_to_channel_2d, tmp.space_to_channel_2d, [X4]),
    "channel_to_space_2d": (jmp.channel_to_space_2d, tmp.channel_to_space_2d, [X4]),
    "space_to_channel_3d": (jmp.space_to_channel_3d, tmp.space_to_channel_3d, [X5]),
    "channel_to_space_3d": (jmp.channel_to_space_3d, tmp.channel_to_space_3d, [X5]),
    "lowpass_2d_circular": (lambda x: jmp.lowpass_2d(x, 4.0),
                            lambda x: tmp.lowpass_2d(x, 4.0), [(2, 9, 13, 3)]),
    "lowpass_2d_square": (lambda x: jmp.lowpass_2d(x, 3.0, use_circular_filter=False),
                          lambda x: tmp.lowpass_2d(x, 3.0, use_circular_filter=False), [X5]),
    "randn_like_hp_2d_even": (lambda x: jmp.randn_like_hp_2d(KEY, x),
                              lambda x: tmp.randn_like_hp_2d(x, draws=_hp_draws(x.shape)),
                              [X4]),
    "randn_like_hp_2d_odd": (lambda x: jmp.randn_like_hp_2d(KEY, x),
                             lambda x: tmp.randn_like_hp_2d(x, draws=_hp_draws(x.shape)),
                             [(2, 2, 9, 13, 3)]),
    "random_crop_2d": (lambda a, b: jmp.random_crop_2d(KEY, a, b, range_h=3, range_w=4),
                       lambda a, b: tmp.random_crop_2d(a, b, range_h=3, range_w=4,
                                                       draws=_crop_draws(4, 3, 4, 0.5)),
                       [(4, 8, 12, 3), (4, 8, 12, 2)]),
    "normalize_weight": (jlayers.normalize_weight, tlayers.normalize_weight, [(6, 4, 3, 3)]),
    "filtered_downsample_1d": (*_flt("filtered_downsample_1d"), [X3]),
    "filtered_upsample_1d": (*_flt("filtered_upsample_1d", k_size=16), [X3]),
    "filtered_downsample_2d": (*_flt("filtered_downsample_2d", factor=3), [(1, 18, 15, 2)]),
    "filtered_mp_silu_2d": (*_flt("filtered_mp_silu_2d"), [(2, 16, 16, 4)]),
    "filtered_mp_silu_2d_k8": (*_flt("filtered_mp_silu_2d", k_size=8), [(1, 16, 12, 2)]),
    "filtered_downsample_3d": (*_flt("filtered_downsample_3d"), [(1, 2, 16, 16, 4)]),
    "filtered_upsample_3d": (*_flt("filtered_upsample_3d"), [(1, 2, 8, 8, 4)]),
    "filtered_mp_silu_3d": (*_flt("filtered_mp_silu_3d"), [(1, 2, 16, 16, 4)]),
    "filtered_downsample_1d3": (*_flt("filtered_downsample_1d3"), [(1, 2, 8, 16, 4)]),
    "filtered_upsample_1d3": (*_flt("filtered_upsample_1d3"), [(1, 2, 8, 16, 4)]),
    "FilteredDownsample2D": (*_fd2d(16, 8), [(1, 32, 48, 2)]),
    "FilteredDownsample2D_5d": (*_fd2d(16, 8), [(1, 2, 32, 48, 2)]),
    "FilteredDownsample2D_odd": (*_fd2d(7, 4), [(2, 20, 24, 3)]),
}


def _inputs(name):
    rng = np.random.default_rng(sorted(FUNCTIONS).index(name))
    return [rng.standard_normal(s).astype(np.float32) for s in FUNCTIONS[name][2]]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def jax_outputs():
    return {name: [np.asarray(o) for o in _as_tuple(fn(*map(jnp.asarray, _inputs(name))))]
            for name, (fn, _, _) in FUNCTIONS.items()}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_primitive_matches_jax(jax_outputs, name):
    got = _as_tuple(FUNCTIONS[name][1](*map(torch.from_numpy, _inputs(name))))
    assert len(got) == len(jax_outputs[name])
    for g, w in zip(got, jax_outputs[name]):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_random_functions_draw_from_a_generator():
    """Without draws the port draws from its generator: the same seed gives
    the same noise and crops, another seed others; the noise is high-pass
    (no energy at DC) and crops keep their shape."""
    x = torch.zeros(2, 16, 20, 3)
    noise = [tmp.randn_like_hp_2d(x, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(noise[0], noise[1]) and not torch.equal(noise[0], noise[2])
    assert noise[0].shape == x.shape
    crops = [tmp.random_crop_2d(torch.randn(8, 16, 20, 3, generator=torch.Generator()
                                            .manual_seed(5)), range_h=4, range_w=6,
                                generator=torch.Generator().manual_seed(s))[0] for s in (0, 0)]
    assert torch.equal(*crops) and crops[0].shape == (8, 12, 14, 3)


def test_filtered_downsample_2d_module_has_no_state():
    """JAX gives FilteredDownsample2D no variables; the port's state dict is
    empty too, and its filter follows the module to another dtype."""
    m = tlayers.FilteredDownsample2D()
    assert m.state_dict() == {} and list(m.parameters()) == []
    assert jlayers.FilteredDownsample2D().init(KEY, jnp.zeros((1, 16, 16, 1))) == {}
    out = m(torch.randn(1, 2, 32, 40, 2, dtype=torch.float64))
    assert out.shape == (1, 2, 4, 5, 2) and out.dtype == torch.float64


def test_models_exports_match_jax_less_the_folding_names():
    """Every name JAX's ``models`` package exports, but the weight-folding
    ones (a TPU workaround the port leaves out), and its ``mp`` module."""
    folding = {"fold_inference_params", "folded_params", "fold_ctx", "fold_env_mode"}
    public = {n for n in dir(jmodels) if not n.startswith("_")
              and not inspect.ismodule(getattr(jmodels, n))}
    assert {"AdaptiveGroupBalance", "filtered_upsample_1d3"} <= public
    assert sorted(n for n in public - folding if not hasattr(tmodels, n)) == []
    assert tmodels.mp is tmp


# ---------------------------------------------------------------------------
# AdaptiveGroupBalance and its weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emb_channels", [16, 0])
def test_adaptive_group_balance_loads_jax_weights(emb_channels):
    """JAX's variables, their zero-initialised leaves set to seeded values,
    load through ``load_flat`` and give JAX's output, and ``to_flat`` gives
    them back under the same keys."""
    rng = np.random.default_rng(11)
    x, y = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32) for _ in range(2))
    emb = rng.standard_normal((2, 16)).astype(np.float32) if emb_channels else None
    kw = dict(emb_channels=emb_channels, groups=4, balance_logits_offset=0.3,
              min_balance=0.2, max_balance=0.85)
    jm = jlayers.AdaptiveGroupBalance(**kw)
    variables = jm.init(KEY, jnp.asarray(x), jnp.asarray(y),
                        None if emb is None else jnp.asarray(emb))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 2), variables)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(y),
                    None if emb is None else jnp.asarray(emb))
    flat = _flatten(variables)
    assert set(flat) == {"params/emb_balance/w_raw" if emb_channels else "params/balance"}
    tm = tlayers.AdaptiveGroupBalance(**kw)
    load_flat(tm, flat)
    got = tm(torch.from_numpy(x), torch.from_numpy(y),
             None if emb is None else torch.from_numpy(emb))
    _close(got.detach().numpy(), want)
    back = to_flat(tm)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_adaptive_group_balance_starts_at_an_even_balance():
    """Zero-initialised: a balance of 0.5, the plain mp_sum, as in JAX."""
    rng = np.random.default_rng(12)
    x, y = (torch.from_numpy(rng.standard_normal((2, 3, 5, 8)).astype(np.float32))
            for _ in range(2))
    for tm, emb in ((tlayers.AdaptiveGroupBalance(6, 2), torch.randn(2, 6)),
                    (tlayers.AdaptiveGroupBalance(0, 2), None)):
        _close(tm(x, y, emb).detach().numpy(), tmp.mp_sum(x, y, 0.5).numpy())


# ---------------------------------------------------------------------------
# MPConv's per-sample gains
# ---------------------------------------------------------------------------

#: name -> (MPConv keywords, input shape); the grouped 3x3 case runs K1's
#: plain version (and in training its plain backward)
GAIN_CONVS = {
    "linear": (dict(in_channels=16, out_channels=24), (3, 16)),
    "grouped_3x3": (dict(in_channels=16, out_channels=32, kernel=(3, 3), groups=2),
                    (2, 6, 10, 16)),
    "1x1_bias": (dict(in_channels=8, out_channels=16, kernel=(1, 1), use_bias=True),
                 (2, 6, 10, 8)),
    "3d": (dict(in_channels=8, out_channels=16, kernel=(2, 3, 3)), (2, 2, 6, 10, 8)),
}
GAIN_CASES = [(c, g) for c in GAIN_CONVS for g in ("b", "b_cout")]


def _gain_inputs(conv, kind):
    kw, shape = GAIN_CONVS[conv]
    rng = np.random.default_rng(sorted(GAIN_CONVS).index(conv) * 2 + (kind == "b"))
    x = rng.standard_normal(shape).astype(np.float32)
    gshape = (shape[0],) if kind == "b" else (shape[0], kw["out_channels"])
    gain = rng.uniform(0.5, 1.5, gshape).astype(np.float32)
    out_shape = shape[:-1] + (kw["out_channels"],)
    probe = rng.standard_normal(out_shape).astype(np.float32)
    return x, gain, probe


@pytest.fixture(scope="module")
def gain_refs():
    """JAX's output at inference, its output in training and the gain's
    gradient of sum(output * probe) in training, for each case, with the
    weights (scaled by 3, so training's weight norm acts)."""
    refs = {}
    for conv, kind in GAIN_CASES:
        kw, _ = GAIN_CONVS[conv]
        x, gain, probe = _gain_inputs(conv, kind)
        jm = jlayers.MPConv(**kw)
        variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
        variables = jax.tree_util.tree_map(lambda a: a * 3.0, variables)

        def loss(g, v=variables, jm=jm, x=x, probe=probe):
            return jnp.sum(jm.apply(v, jnp.asarray(x), gain=g, training=True) * probe)

        refs[(conv, kind)] = {
            "params": {k: np.asarray(v) for k, v in variables["params"].items()},
            "out": np.asarray(jm.apply(variables, jnp.asarray(x), gain=jnp.asarray(gain))),
            "train_out": np.asarray(jm.apply(variables, jnp.asarray(x), gain=jnp.asarray(gain),
                                             training=True)),
            "gain_grad": np.asarray(jax.grad(loss)(jnp.asarray(gain)))}
    return refs


def _port_conv(conv, params):
    tm = tlayers.MPConv(**GAIN_CONVS[conv][0])
    with torch.no_grad():
        for k, v in params.items():
            getattr(tm, k).copy_(torch.from_numpy(np.array(v)))
    return tm


@pytest.mark.parametrize("conv,kind", GAIN_CASES)
def test_mpconv_per_sample_gain_matches_jax(gain_refs, conv, kind):
    """A (B,) or (B, C_out) gain scales the output before the bias: the
    forward at inference and in training, and the gain's gradient."""
    ref = gain_refs[(conv, kind)]
    x, gain, probe = _gain_inputs(conv, kind)
    tm = _port_conv(conv, ref["params"])
    with torch.no_grad():
        _close(tm(torch.from_numpy(x), gain=torch.from_numpy(gain)).numpy(), ref["out"])
    g = torch.from_numpy(gain).requires_grad_()
    out = tm(torch.from_numpy(x), gain=g, training=True)
    (out * torch.from_numpy(probe)).sum().backward()
    _close(out.detach().numpy(), ref["train_out"])
    _close(g.grad.numpy(), ref["gain_grad"])


def test_mpconv_k1_weights_are_cached_at_gain_one():
    """On K1's route (its plain version here) the prepared weights are kept
    across calls with different per-sample gains, and each call's output is
    the gain-1 output times its gain."""
    tm = _port_conv("grouped_3x3", {"w_mp": np.random.default_rng(4).standard_normal(
        (32, 8, 3, 3)).astype(np.float32)})
    x = torch.from_numpy(_gain_inputs("grouped_3x3", "b")[0])
    with torch.no_grad():
        base = tm(x)
        cached = tm._kernel_weight_cache
        for gain in (torch.tensor([0.5, 2.0]), torch.rand(2, 32) + 0.5):
            got = tm(x, gain=gain)
            assert tm._kernel_weight_cache is cached
            g = gain.reshape(2, 1, 1, -1)
            assert torch.equal(got, base * g)


@pytest.fixture(scope="module")
def gain_ranks(tmp_path_factory, gain_refs):
    tmp = tmp_path_factory.mktemp("mpconv_gains")
    cases = []
    for conv, kind in GAIN_CASES:
        x, gain, probe = _gain_inputs(conv, kind)
        cases.append({"kw": GAIN_CONVS[conv][0], "x": torch.from_numpy(x),
                      "gain": torch.from_numpy(gain), "probe": torch.from_numpy(probe),
                      "state": _port_conv(conv, gain_refs[(conv, kind)]["params"]).state_dict()})
    torch.save({"cases": cases}, tmp / "gain_inputs.pt")
    ranks.spawn(ranks.mpconv_gain_runs, 2, tmp)
    return cases, torch.load(tmp / "gain_out.pt", weights_only=False)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_mpconv_per_sample_gain_sharded_matches_whole(gain_ranks, mode):
    """Over two gloo ranks, tensor-parallel (each rank its output columns) and
    FSDP (the weight gathered where used), every case's output and the
    gradients of its input and of its gain equal the unsharded layer's."""
    cases, got = gain_ranks
    for i, case in enumerate(cases):
        tm = tlayers.MPConv(**case["kw"])
        tm.load_state_dict(case["state"])
        x = case["x"].clone().requires_grad_()
        g = case["gain"].clone().requires_grad_()
        out = tm(x, gain=g, training=True)
        (out * case["probe"]).sum().backward()
        for what, want in (("out", out.detach()), ("x", x.grad), ("gain", g.grad)):
            _close(got[(mode, i)][what].numpy(), want.numpy())


# ---------------------------------------------------------------------------
# the small exports
# ---------------------------------------------------------------------------

@dataclass
class _BalanceConfig:
    emb_channels: int = 8
    groups: int = 4


def test_register_module_builds_a_variant_from_a_model_directory(tmp_path, monkeypatch):
    """A module type registered with ``register_module`` is saved and loaded
    by ``Pipeline`` like the built-in ones, its weights included; an unknown
    type keeps ``get_module_class``'s error."""
    monkeypatch.setattr(tpipeline, "MODULE_REGISTRY", dict(tpipeline.MODULE_REGISTRY))
    register_module("balance", lambda cfg, device: tlayers.AdaptiveGroupBalance(
        cfg.emb_channels, cfg.groups, device=device), _BalanceConfig)
    cfg = _BalanceConfig()
    module = tlayers.AdaptiveGroupBalance(cfg.emb_channels, cfg.groups)
    with torch.no_grad():
        module.emb_balance.w_raw.normal_(generator=torch.Generator().manual_seed(0))
    Pipeline({"balance": ModuleHandle("balance", "balance", cfg, module)}).save_pretrained(
        tmp_path)
    loaded = Pipeline.from_pretrained(tmp_path, device="cpu").modules["balance"]
    assert isinstance(loaded.module, tlayers.AdaptiveGroupBalance)
    assert loaded.config == cfg
    assert torch.equal(loaded.module.emb_balance.w_raw, module.emb_balance.w_raw)
    with pytest.raises(KeyError, match="unknown module type 'nothing'; known: .*'balance'"):
        get_module_class("nothing")


@pytest.mark.parametrize("t,hop,center,n_fft", [(1000, 256, True, 0), (1024, 256, True, 0),
                                                (1000, 128, False, 512)])
def test_stft_num_frames_matches_jax(t, hop, center, n_fft):
    assert stft_num_frames(t, hop, center, n_fft) == jax_stft_num_frames(t, hop, center, n_fft)


def test_custom_collate_matches_jax():
    rng = np.random.default_rng(9)
    items = [{"path": f"s{i}.wav", "audio": rng.standard_normal((2, 8)).astype(np.float32),
              "label": i} for i in range(3)]
    got, want = custom_collate(items), jax_custom_collate(items)
    assert got.keys() == want.keys() and got["paths"] == want["paths"]
    for k in ("audio", "label"):
        np.testing.assert_array_equal(got[k], want[k])
