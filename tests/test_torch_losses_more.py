"""The rest of the port's loss library against the JAX package on the CPU:
each loss's per-sample values and the gradient of a weighted sum of them
with respect to the trained input, on numpy-seeded inputs, compared by
relative L2 (|got - want| / |want| over the whole tensor). The filtered
resamplers and the Laplacian pyramid they rest on are held first.

<-> dualdiffusion_tpu/training/losses.py:47-93, 211-550,
dualdiffusion_tpu/models/mp.py:187-215, dualdiffusion_tpu/models/
layers.py:680-748.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models import layers as jlayers
from dualdiffusion_tpu.models import mp as jmp
from dualdiffusion_tpu.training import losses as jL
from dualdiffusion_tpu_torch.models import layers as tlayers
from dualdiffusion_tpu_torch.models import mp as tmp
from dualdiffusion_tpu_torch.training import losses as tL

#: values and input gradients, relative L2
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def check_loss(jax_fn, torch_fn, sample, target, tol=TOL, grad_tol=TOL):
    """Per-sample values, and the gradient of their weighted sum with respect
    to ``sample``, of JAX ``jax_fn(sample, target)`` and port ``torch_fn``."""
    w = np.random.default_rng(99).uniform(0.5, 1.5, sample.shape[0]).astype(np.float32)
    want_val, want_grad = jax.jit(lambda a, b: (
        jax_fn(a, b), jax.grad(lambda x: jnp.sum(jax_fn(x, b) * w))(a)))(
        jnp.asarray(sample), jnp.asarray(target))
    s = torch.tensor(sample, requires_grad=True)
    got_val = torch_fn(s, torch.tensor(target))
    (got_val * torch.from_numpy(w)).sum().backward()
    assert rel_l2(got_val, want_val) <= tol
    assert rel_l2(s.grad, want_grad) <= grad_tol
    assert np.abs(np.asarray(want_grad)).max() > 0


# ---------------------------------------------------------------------------
# helpers: the filtered resamplers and the Laplacian pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_size", [7, 8, 15])
def test_filtered_resamplers_match_jax(k_size):
    """Kaiser-sinc down- and upsampling of (B, H, W, C) with odd and even
    tap counts (their asymmetric reflect pads), fp32 conv rounding: 1e-6."""
    x = _x((2, 12, 18, 3), 1)
    for jf, tf in ((jlayers.filtered_downsample_2d, tlayers.filtered_downsample_2d),
                   (jlayers.filtered_upsample_2d, tlayers.filtered_upsample_2d)):
        want = jf(jnp.asarray(x), k_size, 1.5)
        assert rel_l2(tf(torch.from_numpy(x), k_size, 1.5), want) <= 1e-6
    assert np.array_equal(tlayers._kaiser_sinc_1d(k_size, 0.5, 1.5),
                          jlayers._kaiser_sinc_1d(k_size, 0.5, 1.5))


def test_wavelet_pyramid_matches_jax():
    """The Laplacian pyramid's levels, and its recomposition (exact)."""
    x = _x((2, 16, 24, 2), 2)
    want = jmp.wavelet_decompose_2d(jnp.asarray(x), 3)
    got = tmp.wavelet_decompose_2d(torch.from_numpy(x), 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= 1e-6
    assert rel_l2(tmp.wavelet_recompose_2d(got), jmp.wavelet_recompose_2d(want)) <= 1e-6
    assert rel_l2(tmp.wavelet_recompose_2d(got), x) <= 1e-6


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def test_mss_loss_1d_matches_jax():
    """Magnitude L1 and the wrap-aware phase loss at every width up to the
    signal's 3000 samples (64-2048), the phase weights without gradient:
    both values and the magnitude term's gradient in fp32 at 1e-5. The phase
    term's gradient divides by |S| in each bin, so each package's fp32 FFT
    rounding moves it (JAX's fp32 gradient lies 1.0e-4 from the float64
    one, the port's 4.8e-4, on this draw; per width the two trade places):
    it is held in float64 in both packages (JAX under ``enable_x64``) at
    1e-9, and the port's fp32 one against that at 2e-3."""
    s, t = _x((2, 2, 3000), 3, 0.3), _x((2, 2, 3000), 4, 0.3)
    jl, tl = jL.MSSLoss1D(jL.MSSLoss1DConfig()), tL.MSSLoss1D(tL.MSSLoss1DConfig())
    check_loss(lambda a, b: jl(a, b)[0], lambda a, b: tl(a, b)[0], s, t)
    check_loss(lambda a, b: jl(a, b)[1], lambda a, b: tl(a, b)[1], s, t, grad_tol=1.0)
    w = np.array([0.7, 1.3])
    with jax.enable_x64(True):
        want64 = jax.jit(jax.grad(lambda x, y: jnp.sum(jl(x, y)[1] * w)))(
            jnp.asarray(s, jnp.float64), jnp.asarray(t, jnp.float64))
    grads = []
    for dtype in (torch.float64, torch.float32):
        x = torch.tensor(s, dtype=dtype, requires_grad=True)
        (tl(x, torch.tensor(t, dtype=dtype))[1] * torch.tensor(w, dtype=dtype)).sum().backward()
        grads.append(x.grad)
    assert np.asarray(want64).dtype == np.float64
    assert rel_l2(grads[0], want64) <= 1e-9
    assert rel_l2(grads[1], want64) <= 2e-3


def _jax_prime_draws(key, h, w, num_iterations=16, num_size_sets=4, seed=0):
    """The draws JAX random_prime_mss_2d makes from ``key`` (losses.py:246-298)."""
    rng = np.random.default_rng(seed)
    sets = [jL._draw_prime_sizes(rng, num_iterations, h, w) for _ in range(num_size_sets)]
    k_set, k_iter = jax.random.split(key)
    idx = int(jax.random.randint(k_set, (), 0, num_size_sets))
    offsets, flags = [], []
    for (bh, bw), k in zip(sets[idx], jax.random.split(k_iter, num_iterations)):
        k_off, k_ms = jax.random.split(k)
        offsets.append((int(jax.random.randint(k_off, (), 0, max(h - bh, 0) + 1)),
                        int(jax.random.randint(jax.random.fold_in(k_off, 1), (), 0,
                                               max(w - bw, 0) + 1))))
        flags.append(bool(jax.random.bernoulli(k_ms)))
    return tL.PrimeMSSDraws(idx, offsets, flags)


@pytest.mark.parametrize("key_seed,use_midside,n,sets", [(0, True, 7, 2), (5, True, 5, 3),
                                                       (7, False, 5, 3)])
def test_random_prime_mss_2d_matches_jax(key_seed, use_midside, n, sets):
    """The size sets drawn on the host from the seed (the same in both
    packages), JAX's traced set index, offsets and mid/side flags replayed
    into the port; prime blocks make odd-length ``rfft2``s. Fewer iterations
    and sets than the trainer's 16 over 4 (tests/test_torch_dae_training_more.py
    holds those), for a shorter JAX compile."""
    s, t = _x((2, 2, 40, 56), 10 + key_seed), _x((2, 2, 40, 56), 20 + key_seed)
    rng = np.random.default_rng(0)
    assert tL.prime_size_sets(40, 56, n, 0, sets) == tuple(
        tuple(jL._draw_prime_sizes(rng, n, 40, 56)) for _ in range(sets))
    key = jax.random.PRNGKey(key_seed)
    draws = _jax_prime_draws(key, 40, 56, n, sets)
    kw = dict(num_iterations=n, use_midside=use_midside, num_size_sets=sets)
    check_loss(lambda a, b: jL.random_prime_mss_2d(key, a, b, **kw),
               lambda a, b: tL.random_prime_mss_2d(a, b, draws, **kw), s, t)


def test_draw_random_prime_mss_is_in_range():
    """The port's own draws: a set index, offsets that keep each block in the
    image, flags of both values."""
    g = torch.Generator().manual_seed(0)
    sets = tL.prime_size_sets(40, 56)
    seen = set()
    for _ in range(8):
        d = tL.draw_random_prime_mss(g, 40, 56)
        seen.add(d.set_index)
        for (bh, bw), (oh, ow) in zip(sets[d.set_index], d.offsets):
            assert 0 <= oh <= 40 - bh and 0 <= ow <= 56 - bw
        assert len(d.midside) == 16 and 0 < sum(d.midside) < 16
    assert len(seen) > 1


@pytest.mark.parametrize("kind", ["l1", "mse", "kl"])
def test_spec_reg_loss_matches_jax(kind):
    lat = _x((2, 4, 16, 12), 30)
    profile = np.abs(_x((4, 16, 7), 31)) + 0.1
    check_loss(lambda a, b: jL.spec_reg_loss(a, b, kind),
               lambda a, b: tL.spec_reg_loss(a, b, kind), lat, profile)


@pytest.mark.parametrize("use_midside", [False, True])
def test_wavelet_loss_matches_jax(use_midside):
    s, t = _x((2, 16, 24, 2), 40), _x((2, 16, 24, 2), 41)
    check_loss(lambda a, b: jL.wavelet_loss(a, b, 3, 0.5, use_midside),
               lambda a, b: tL.wavelet_loss(a, b, 3, 0.5, use_midside), s, t)


def test_dog_loss_2d_matches_jax():
    """Seven gaussian scales (3-27 taps) on 32 x 32 images, learned logvars."""
    s, t = _x((2, 32, 32, 2), 50), _x((2, 32, 32, 2), 51)
    logvars = _x((8,), 52, 0.3)
    check_loss(lambda a, b: jL.dog_loss_2d(a, b, jnp.asarray(logvars)),
               lambda a, b: tL.dog_loss_2d(a, b, torch.from_numpy(logvars)), s, t)


def test_latent_regularizers_match_jax():
    """kl_to_unit_loss per sample; vicreg_regularization (a scalar, its
    covariance over the first 512 of 768 dims)."""
    lat = _x((3, 8, 6, 4), 60, 1.3) + 0.2
    check_loss(lambda a, b: jL.kl_to_unit_loss(a, 0.5),
               lambda a, b: tL.kl_to_unit_loss(a, 0.5), lat, lat)
    big = _x((4, 16, 12, 4), 61)
    check_loss(lambda a, b: jL.vicreg_regularization(a, 1.0, 0.3, 1.2)[None].repeat(4),
               lambda a, b: tL.vicreg_regularization(a, 1.0, 0.3, 1.2)[None].repeat(4),
               big, big)


def test_prime_mss_1d_matches_jax():
    """Prime widths capped at the signal's 1000 samples (31-577), the widest
    one's reflect pad, odd-length ``rfft2`` over (frame, within-frame)."""
    s, t = _x((2, 3, 1000), 70), _x((2, 3, 1000), 71)
    bws = tuple(b for b in jL.PRIME_BLOCK_WIDTHS_1D if b <= 1000)
    sts = jL.PRIME_BLOCK_STEPS_1D[:len(bws)]
    assert tL.PRIME_BLOCK_WIDTHS_1D == jL.PRIME_BLOCK_WIDTHS_1D
    check_loss(lambda a, b: jL.prime_mss_1d(a, b, bws, sts),
               lambda a, b: tL.prime_mss_1d(a, b, bws, sts), s, t)


def _encoders(w):
    """One toy encoder in both packages: a 4 x 4 average pool, then a
    channel mix by ``w`` (2, 3)."""
    def jenc(m, w=w):
        b, h, ww, c = m.shape
        p = m.reshape(b, h // 4, 4, ww // 4, 4, c).mean(axis=(2, 4))
        return p @ w

    def tenc(m, w):
        b, h, ww, c = m.shape
        return m.reshape(b, h // 4, 4, ww // 4, 4, c).mean(dim=(2, 4)) @ w
    return jenc, tenc


def test_equivariance_loss_matches_jax():
    """Levels 3 (4x upsample, 15 taps; back with 7), crop range 8, the offsets
    of JAX's key replayed; the re-encoded latents re-standardized with their
    own statistics detached: values, and gradients with respect to the mel
    and the encoder's weights (none reaches the original latents)."""
    mel = _x((2, 32, 40, 2), 80)
    lat = _x((2, 8, 10, 3), 81)
    w = _x((2, 3), 82)
    cfg_j, cfg_t = jL.EquivarianceLossConfig(levels=3), tL.EquivarianceLossConfig(levels=3)
    key = jax.random.PRNGKey(4)
    ky, kx = jax.random.split(key)
    offsets = ([int(v) for v in jax.random.randint(ky, (2,), 1, 9)],
               [int(v) for v in jax.random.randint(kx, (2,), 1, 9)])
    jenc, tenc = _encoders(jnp.asarray(w))

    def jloss(m, wj):
        return jL.equivariance_loss(key, lambda x: jenc(x, wj), m, jnp.asarray(lat), cfg_j)

    want = jloss(jnp.asarray(mel), jnp.asarray(w))
    wts = np.array([0.7, 1.3], np.float32)
    gm, gw = jax.grad(lambda m, wj: jnp.sum(jloss(m, wj) * wts), argnums=(0, 1))(
        jnp.asarray(mel), jnp.asarray(w))
    tm = torch.tensor(mel, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tl = torch.tensor(lat, requires_grad=True)
    got = tL.equivariance_loss(lambda x: tenc(x, tw), tm, tl, offsets, cfg_t)
    (got * torch.from_numpy(wts)).sum().backward()
    assert rel_l2(got, want) <= TOL
    assert rel_l2(tm.grad, gm) <= TOL and rel_l2(tw.grad, gw) <= TOL
    assert tl.grad is None or float(tl.grad.abs().max()) == 0.0
