"""The port's 2-D multi-scale spectral losses against the JAX package on the
CPU: the plain versions of K5/K6 (``mss2d_block_loss_plain`` and its
autograd) against the JAX Pallas kernel in interpret mode and its custom
VJP, the multi-scale ``mss2d_loss_fused`` and the unfused ``MSSLoss2D``.

<-> dualdiffusion_tpu/ops/pallas/mss2d.py, dualdiffusion_tpu/training/losses.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.ops.pallas.mss2d import mss2d_block_loss as jax_block_loss
from dualdiffusion_tpu.ops.pallas.mss2d import mss2d_loss_fused as jax_loss_fused
from dualdiffusion_tpu.training import losses as jlosses
from dualdiffusion_tpu_torch.ops.kernels import (Mss2dBlockLossFn, mss2d_block_loss,
                                                 mss2d_block_loss_grad, mss2d_block_loss_plain,
                                                 mss2d_loss_fused)
from dualdiffusion_tpu_torch.ops.kernels.mss2d import _rank1_factor
from dualdiffusion_tpu_torch.training.losses import (MSSLoss2D, MSSLoss2DConfig, _window_2d,
                                                     product_weights, unfold_2d)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("bw,stride,h,w", [(32, 4, 32 + 14, 32 + 21), (64, 8, 64 + 17, 64 + 8)])
def test_plain_block_loss_and_gradient_match_jax_kernel(bw, stride, h, w):
    """Per-image sums against the interpret-mode Pallas kernel (the same
    math summed in another order: 1e-5 relative), and the gradients of
    sum(g * loss) for sample and target against the JAX custom VJP (1e-4 of
    max). The sizes leave a ragged edge (H - bw, W - bw not multiples of
    the stride)."""
    s, t = _pair((2, h, w), 0)
    g = np.array([0.7, -1.3], np.float32)
    win = _window_2d("flat_top", bw)
    weight = product_weights(bw) / bw

    def jloss(a, b):
        return jax_block_loss(a, b, bw, stride, win, weight, True)

    want, (want_gs, want_gt) = jax.jit(lambda a, b: (jloss(a, b), jax.grad(
        lambda x, y: jnp.sum(jloss(x, y) * g), argnums=(0, 1))(a, b)))(
        jnp.asarray(s), jnp.asarray(t))
    ts, tt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(t).requires_grad_()
    got = mss2d_block_loss_plain(ts, tt, bw, stride, win, weight)
    (got * torch.from_numpy(g)).sum().backward()
    assert np.all(np.abs(got.detach().numpy() - np.asarray(want)) <= 1e-5 * np.abs(want))
    assert _rel_err(ts.grad, want_gs) <= 1e-4
    assert _rel_err(tt.grad, want_gt) <= 1e-4


def test_block_loss_fn_on_cpu_is_the_plain_version():
    """On CPU tensors the K5/K6 wrappers and the autograd Function run the
    plain versions: the same loss, and K6's gradient equals the plain
    autograd exactly; dTarget only when the target requires grad."""
    bw, stride = 32, 4
    s, t = _pair((2, 40, 44), 1)
    win, weight = _window_2d("flat_top", bw), product_weights(bw) / bw
    ts, tt = torch.from_numpy(s), torch.from_numpy(t)
    g = torch.tensor([1.0, 0.5])
    before = mss2d_block_loss.launches, mss2d_block_loss_grad.launches
    x = ts.clone().requires_grad_()
    loss = Mss2dBlockLossFn.apply(x, tt, bw, stride, win, weight)
    assert torch.equal(loss, mss2d_block_loss_plain(ts, tt, bw, stride, win, weight))
    (loss * g).sum().backward()
    ds, dt = mss2d_block_loss_grad(ts, tt, g, bw, stride, win, weight, need_target=False)
    assert dt is None and torch.equal(x.grad, ds)
    assert (mss2d_block_loss.launches, mss2d_block_loss_grad.launches) == before


def test_window_factor_is_exact_or_refused():
    """The FFT kernels take the separable window's 1-D factor; a window that
    is not an outer product has none (and takes the direct-DFT route)."""
    for bw in (32, 64):
        w = _window_2d("flat_top", bw)
        w1 = _rank1_factor(w)
        assert np.abs(np.outer(w1, w1) - w).max() <= 1e-6 * np.abs(w).max()
    assert _rank1_factor(_window_2d("flat_top_circular", 32)) is None


@pytest.mark.parametrize("use_midside", [True, False])
def test_fused_loss_and_gradient_match_jax(use_midside):
    """``mss2d_loss_fused`` over widths 8/16 (unfold path) and 32/64 (the
    kernels' path) against the JAX fused loss: per-sample losses to 1e-5
    relative, the sample's gradient to 1e-4 of max."""
    s, t = _pair((2, 2, 40, 72), 2)
    kw = dict(block_widths=(8, 16, 32, 64), block_overlap=8, use_midside=use_midside)

    def jloss(a, b):
        return jax_loss_fused(a, b, interpret=True, **kw)

    want, want_g = jax.jit(lambda a, b: (jloss(a, b), jax.grad(
        lambda x: jnp.sum(jloss(x, b) * jnp.array([1.0, 2.0])))(a)))(
        jnp.asarray(s), jnp.asarray(t))
    x = torch.from_numpy(s).requires_grad_()
    got = mss2d_loss_fused(x, torch.from_numpy(t), **kw)
    (got * torch.tensor([1.0, 2.0])).sum().backward()
    assert np.all(np.abs(got.detach().numpy() - np.asarray(want)) <= 1e-5 * np.abs(want))
    assert _rel_err(x.grad, want_g) <= 1e-4


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(use_midside_transform="none", frequency_weighting="f^2"),
    dict(use_midside_transform="cat", frequency_weighting="dynamic", use_mse_loss=True),
    dict(block_window_fn="hann", phase_loss_scale=0.5, block_width_weight_exponent=0.5,
         frequency_weight_exponent=2.0),
])
def test_mssloss2d_matches_jax(cfg):
    """The unfused MSSLoss2D, the DAE trainer's default recon loss: the
    sample's gradient to 1e-4 of max; per-sample losses to 5e-5 relative,
    because JAX's fp32 result sits up to 2.4e-5 from a float64 evaluation in
    the squared-error and phase cases (measured), where the port's sits
    within 1e-7, which the test holds to 1e-6."""
    s, t = _pair((2, 2, 24, 40), 3)
    kw = dict(block_widths=(8, 16, 32), **cfg)
    jl = jlosses.MSSLoss2D(jlosses.MSSLoss2DConfig(**kw))
    want, want_g = jax.jit(lambda a, b: (jl(a, b), jax.grad(lambda x: jnp.sum(jl(x, b)))(a)))(
        jnp.asarray(s), jnp.asarray(t))
    loss = MSSLoss2D(MSSLoss2DConfig(**kw))
    x = torch.from_numpy(s).requires_grad_()
    got = loss(x, torch.from_numpy(t))
    got.sum().backward()
    f64 = loss(torch.from_numpy(s).double(), torch.from_numpy(t).double()).numpy()
    assert np.all(np.abs(got.detach().numpy() - f64) <= 1e-6 * np.abs(f64))
    assert np.all(np.abs(got.detach().numpy() - np.asarray(want)) <= 5e-5 * np.abs(want))
    assert _rel_err(x.grad, want_g) <= 1e-4


def test_unfold_and_windows_match_jax():
    """unfold_2d exactly; every block window and the product weights to
    fp32 rounding."""
    s, _ = _pair((1, 2, 12, 20), 4)
    assert np.array_equal(unfold_2d(torch.from_numpy(s), 8, 2).numpy(),
                          np.asarray(jlosses.unfold_2d(jnp.asarray(s), 8, 2)))
    for name in ("flat_top", "hann", "kaiser", "flat_top_circular", "none"):
        assert _rel_err(_window_2d(name, 16), jlosses._window_2d(name, 16)) <= 1e-6
    fh = np.abs(np.fft.fftfreq(16, d=1.0 / 16))
    fw = np.abs(np.fft.rfftfreq(16, d=1.0 / 16))
    assert np.array_equal(product_weights(16),
                          ((fh[:, None] + 1) * (fw[None, :] + 1)).astype(np.float32))
