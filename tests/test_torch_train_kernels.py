"""The backward of the grouped 3x3 conv (K1 dgrad + K4 wgrad, plain versions
on the CPU) and training-mode MPConv against the JAX package.

GroupedConv3x3Fn <-> dualdiffusion_tpu/ops/pallas/grouped_conv.py
grouped_conv2d_3x3 (Pallas forward in interpret mode, custom VJP _vjp_bwd);
dgrad_weights / grouped_conv3x3_wgrad_plain <-> _dgrad_weights / _wgrad;
MPConv(training=True) <-> dualdiffusion_tpu/models/layers.py MPConv;
a tiny grouped UNet's training gradients <-> dualdiffusion_tpu/models/unet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.layers import MPConv as JaxMPConv
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.ops.pallas.grouped_conv import (_dgrad_weights, _wgrad,
                                                       grouped_conv2d_3x3)
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu_torch.models.layers import MPConv
from dualdiffusion_tpu_torch.ops.kernels import (GroupedConv3x3Fn, dgrad_weights,
                                                 grouped_conv3x3_wgrad,
                                                 grouped_conv3x3_wgrad_plain, prepare_weights)
from dualdiffusion_tpu_torch.weights import flax_key
from test_torch_training import X_SHAPE, _jax_unet_vars, _port_unet, set_trunk_dtype

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _t(a, dtype=torch.float32):
    """numpy / jax array -> torch tensor of ``dtype`` with the same values."""
    return torch.from_numpy(np.array(np.asarray(a, np.float32))).to(dtype)


@pytest.mark.parametrize("b,h,w,groups,cig,cog,dtype", [
    (2, 4, 9, 1, 8, 16, "float32"),
    (1, 2, 70, 4, 8, 4, "bfloat16"),
    (2, 3, 20, 8, 4, 8, "float32"),
    (1, 2, 66, 8, 8, 8, "bfloat16"),
])
def test_grouped_conv_fn_grads_match_jax_vjp(b, h, w, groups, cig, cog, dtype):
    """Forward, dgrad and wgrad of GroupedConv3x3Fn (plain versions) against
    jax.grad through grouped_conv2d_3x3. fp32: the same sums in another
    order (1e-5 of max). bf16: both accumulate in fp32 and round once to
    bf16, so they differ by at most one bf16 ulp (2**-7 of max)."""
    jdt, tdt = DTYPES[dtype]
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((b, h, w, groups * cig)), jdt)
    wgt = jnp.asarray(rng.standard_normal((groups * cog, cig, 3, 3)) / np.sqrt(9 * cig),
                      jnp.float32)
    r = jnp.asarray(rng.standard_normal((b, h, w, groups * cog)), jnp.float32)

    def f(x, wgt):
        out = grouped_conv2d_3x3(x, wgt.astype(jdt), groups)
        return (out.astype(jnp.float32) * r).sum(), out

    (_, want), (gx, gw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, wgt)

    tx = _t(x, tdt).requires_grad_()
    tw = _t(wgt).requires_grad_()
    out = GroupedConv3x3Fn.apply(tx, prepare_weights(tw, groups, tdt), groups)
    (out.float() * _t(r)).sum().backward()
    assert out.dtype == tdt and tx.grad.dtype == tdt
    assert _rel_err(out.float().detach(), want) <= tol
    assert _rel_err(tx.grad.float(), gx) <= tol
    assert _rel_err(tw.grad, gw) <= tol


def test_dgrad_weights_and_wgrad_plain_match_jax():
    """dgrad_weights is _dgrad_weights in the kernel layout, exactly;
    the plain wgrad is _wgrad in the kernel layout (fp32, 1e-5 of max), and
    the wrapper takes it for CPU tensors."""
    rng = np.random.default_rng(1)
    groups, cig, cog = 4, 6, 5
    wgt = rng.standard_normal((groups * cog, cig, 3, 3)).astype(np.float32)
    got = dgrad_weights(prepare_weights(torch.from_numpy(wgt), groups, torch.float32))
    want = prepare_weights(_t(_dgrad_weights(jnp.asarray(wgt), groups)), groups, torch.float32)
    assert torch.equal(got, want)

    x = rng.standard_normal((2, 5, 7, groups * cig)).astype(np.float32)
    gy = rng.standard_normal((2, 5, 7, groups * cog)).astype(np.float32)
    want = prepare_weights(_t(_wgrad(jnp.asarray(x), jnp.asarray(gy), groups)), groups,
                           torch.float32)
    got = grouped_conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(gy), groups)
    assert _rel_err(got, want) < 1e-5
    assert torch.equal(grouped_conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(gy), groups),
                       got)


def _mpconv_pair(cin, cout, groups, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((cout, cin // groups, 3, 3)).astype(np.float32) * 1.7
    tconv = MPConv(cin, cout, (3, 3), groups=groups)
    with torch.no_grad():
        tconv.w_mp.copy_(torch.from_numpy(w))
    return JaxMPConv(cin, cout, (3, 3), groups=groups), {"params": {"w_mp": jnp.asarray(w)}}, \
        tconv


@pytest.mark.parametrize("dtype,route", [("float32", "per_tap"), ("bfloat16", "pallas")])
def test_training_mpconv_matches_jax(dtype, route, monkeypatch):
    """A grouped 3x3 MPConv in training mode (in-graph weight norm, K1 with
    its backward) against the JAX MPConv, output and the gradients of x
    and w_mp. fp32 takes JAX's default per-tap route (1e-5 of max, float
    rounding). bf16 takes JAX's Pallas route for training
    (DD_GROUPED_PALLAS_CONV{,_TRAIN}=1, the custom VJP this port
    mirrors): one bf16 rounding of fp32 sums apart, 2**-7 of max; the
    weight gradient also passes through the weight norm's Jacobian in fp32
    (2**-6)."""
    jdt, tdt = DTYPES[dtype]
    if route == "pallas":
        monkeypatch.setenv("DD_GROUPED_PALLAS_CONV", "1")
        monkeypatch.setenv("DD_GROUPED_PALLAS_CONV_TRAIN", "1")
    groups, cin, cout = 4, 16, 32
    jconv, jvars, tconv = _mpconv_pair(cin, cout, groups, 2)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 2, 72, cin)), jdt)
    r = jnp.asarray(rng.standard_normal((2, 2, 72, cout)), jnp.float32)

    def f(v, x):
        out = jconv.apply(v, x, training=True)
        return (out.astype(jnp.float32) * r).sum(), out

    (_, want), (gv, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jvars, x)
    tx = _t(x, tdt).requires_grad_()
    out = tconv(tx, training=True)
    (out.float() * _t(r)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert _rel_err(out.float().detach(), want) <= tol
    assert _rel_err(tx.grad.float(), gx) <= tol
    assert _rel_err(tconv.w_mp.grad, gv["params"]["w_mp"]) <= (tol if dtype == "float32"
                                                               else 2 ** -6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_grouped_unet_loss_and_grads_match_jax(dtype, monkeypatch):
    """Training-mode forward (in-graph weight norm) and every parameter's
    gradient of a scalar loss that reaches all heads. fp32 trunk: the loss
    to 1e-5 relative and each gradient to 1e-4 of its own max. bf16 trunk:
    the JAX CPU route sums the grouped-conv taps in bf16 and the port in
    fp32, so a small gradient that is a difference of large terms (a scalar
    gain's) moves by tens of percent; the loss agrees to 1e-3 relative and
    the gradient as one vector to 3e-2 in relative L2."""
    set_trunk_dtype(monkeypatch, dtype)
    junet, jvars = _jax_unet_vars()
    rng = np.random.default_rng(4)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    sigma = np.array([0.2, 1.3, 4.0, 30.0], np.float32)
    emb_in = rng.standard_normal((4, 8)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    r = rng.standard_normal(X_SHAPE).astype(np.float32)

    def jloss(v):
        emb = junet.apply(v, jnp.asarray(emb_in), jnp.asarray(mask), training=True,
                          method=JaxUNet.get_embeddings)
        d = junet.apply(v, jnp.asarray(x), jnp.asarray(sigma), emb, training=True)
        lv = junet.apply(v, jnp.asarray(sigma), method=JaxUNet.get_sigma_loss_logvar)
        return (d * r).mean() + lv.mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jvars)
    model = _port_unet(jvars)
    emb = model.get_embeddings(_t(emb_in), _t(mask), training=True)
    d = model(_t(x), _t(sigma), emb, training=True)
    loss = (d * _t(r)).mean() + model.get_sigma_loss_logvar(_t(sigma)).mean()
    loss.backward()
    want = _flatten(want_grads)
    pairs = [(k, p.grad.reshape(p.shape or (1,)).numpy(),
              np.asarray(want[flax_key(k, p.dim() == 0)]))
             for k, p in model.named_parameters()]
    if dtype == "float32":
        assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
        for k, g, w in pairs:
            assert _rel_err(g, w) < 1e-4, k
    else:
        assert abs(loss.item() - float(want_loss)) <= 1e-3 * abs(float(want_loss))
        g = np.concatenate([g.ravel() for _, g, _ in pairs])
        w = np.concatenate([w.ravel() for _, _, w in pairs])
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w)
