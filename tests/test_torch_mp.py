"""Parity of the port's MP primitives and layers with the JAX package.

The same numpy inputs (from a seed) go through dualdiffusion_tpu.models.mp /
layers and dualdiffusion_tpu_torch.models.mp / layers on the CPU.
Tolerances: fp32 paths agree to float rounding (1e-5 relative); bf16 paths
to one or two bf16 roundings (2**-7 relative to the output's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models import layers as jlayers
from dualdiffusion_tpu.models import mp as jmp
from dualdiffusion_tpu_torch.models import layers as tlayers
from dualdiffusion_tpu_torch.models import mp as tmp

F32_TOL = 1e-5
BF16_TOL = 2 ** -7


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _t(a):
    return torch.from_numpy(np.array(a))


def test_mp_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    y = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    z = rng.standard_normal((2, 4, 6, 4)).astype(np.float32)
    pairs = [
        (jmp.normalize(jnp.asarray(x)), tmp.normalize(_t(x))),
        (jmp.normalize(jnp.asarray(x), axis=-1), tmp.normalize(_t(x), dim=-1)),
        (jmp.normalize_groups(jnp.asarray(x), 2), tmp.normalize_groups(_t(x), 2)),
        (jmp.mp_silu(jnp.asarray(x)), tmp.mp_silu(_t(x))),
        (jmp.mp_sum(jnp.asarray(x), jnp.asarray(y), 0.3), tmp.mp_sum(_t(x), _t(y), 0.3)),
        (jmp.mp_cat(jnp.asarray(x), jnp.asarray(z), t=0.4), tmp.mp_cat(_t(x), _t(z), t=0.4)),
        (jmp.resample_2d(jnp.asarray(x), "down"), tmp.resample_2d(_t(x), "down")),
        (jmp.resample_2d(jnp.asarray(x), "up"), tmp.resample_2d(_t(x), "up")),
        (jmp.resample_2d(jnp.asarray(x[:, :3]), "down"), tmp.resample_2d(_t(x[:, :3]), "down")),
    ]
    for want, got in pairs:
        _close(got.numpy(), want, F32_TOL)


def test_mp_fourier_matches_jax():
    sig = np.exp(np.random.default_rng(1).standard_normal(5)).astype(np.float32)
    jm = jlayers.MPFourier(32)
    want = jm.apply({}, jnp.log(jnp.asarray(sig)) / 4)
    got = tlayers.MPFourier(32)(torch.log(_t(sig)) / 4)
    _close(got.numpy(), want, F32_TOL)


CONV_CASES = [
    # (in, out, kernel, groups, bias, gain, dtype)
    (16, 24, (), 1, False, 1.0, "float32"),
    (16, 24, (), 2, False, 0.7, "float32"),
    (8, 16, (1, 1), 1, False, 1.0, "float32"),
    (8, 16, (3, 3), 1, True, 1.0, "float32"),
    (2, 8, (5, 5), 1, True, 1.3, "float32"),
    (16, 32, (3, 3), 2, False, 1.0, "float32"),
    (32, 16, (3, 3), 4, False, 1.0, "float32"),
    (16, 32, (3, 3), 2, False, 1.0, "bfloat16"),
]


@pytest.mark.parametrize("cin,cout,kernel,groups,bias,gain,dtype", CONV_CASES)
def test_mpconv_matches_jax(cin, cout, kernel, groups, bias, gain, dtype):
    """MPConv's weight prep (1/sqrt(fan_in), gain) and conv, including groups
    (the grouped 3x3 case runs K1's plain version here). In bf16 the port
    accumulates in fp32 like the TPU kernel, while the JAX CPU path sums its
    nine taps in bf16, so the bf16 case is held against JAX's fp32 result on
    the same bf16-rounded inputs and weights: one bf16 rounding apart."""
    rng = np.random.default_rng(2)
    shape = (3, cin) if not kernel else (2, 6, 10, cin)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jlayers.MPConv(cin, cout, kernel, groups=groups, use_bias=bias)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    x = np.asarray(jnp.asarray(x, dtype), np.float32)
    jvars = variables
    if dtype == "bfloat16":  # the weights the port's bf16 conv uses
        fan_in = float(np.prod(variables["params"]["w_mp"].shape[1:]))
        w_bf = (variables["params"]["w_mp"] / np.sqrt(fan_in)).astype(jnp.bfloat16)
        jvars = {"params": {**variables["params"], "w_mp": w_bf.astype(jnp.float32)
                            * np.sqrt(fan_in)}}
    want = jm.apply(jvars, jnp.asarray(x), gain=gain)
    tm = tlayers.MPConv(cin, cout, kernel, groups=groups, use_bias=bias)
    with torch.no_grad():
        tm.w_mp.copy_(_t(variables["params"]["w_mp"]))
        if bias:
            tm.bias.copy_(_t(variables["params"]["bias"]))
        got = tm(_t(x).to(getattr(torch, dtype)), gain=gain)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32),
           F32_TOL if dtype == "float32" else BF16_TOL)


def test_mpconv_training_normalizes_weight():
    """training=True applies the forced weight norm in-graph, as JAX does."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    jm = jlayers.MPConv(8, 8, (3, 3))
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros(x.shape))
    variables = jax.tree_util.tree_map(lambda a: a * 3.0, variables)
    want = jm.apply(variables, jnp.asarray(x), training=True)
    tm = tlayers.MPConv(8, 8, (3, 3))
    with torch.no_grad():
        tm.w_mp.copy_(_t(variables["params"]["w_mp"]))
    got = tm(_t(x), training=True)
    _close(got.detach().numpy(), want, F32_TOL)


def test_mpconv_unported_options_raise():
    """Rank-3 kernels and W reflect padding are ported
    (tests/test_torch_unet_3d.py); a kernel of rank 4 and an unknown padding
    mode still raise."""
    tlayers.MPConv(4, 4, (2, 3, 3), w_pad_mode="reflect")
    with pytest.raises(ValueError):
        tlayers.MPConv(4, 4, (1, 2, 3, 3))
    with pytest.raises(ValueError):
        tlayers.MPConv(4, 4, (3, 3), w_pad_mode="circular")
