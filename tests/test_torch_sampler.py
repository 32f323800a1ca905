"""edm_sample of the port against the JAX sampler, with the JAX key splits
(sampling/sampler.py:166,196 and _draw_noise) replayed into the port as
explicit noise. The denoiser is the same closed-form function in both, so
the test isolates the sampler: schedule, CFG, Heun, perturbation re-adding
and renormalization. fp32 throughout: 1e-5 of max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.sampling import SampleParams as JaxSampleParams
from dualdiffusion_tpu.sampling import edm_sample as jax_edm_sample
from dualdiffusion_tpu_torch.sampling import SampleParams, edm_sample

SHAPE = (1, 8, 16, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def replay_noise(key, shape, steps):
    """The draws jax edm_sample makes from ``key``: x_T noise, then one
    re-added noise per step."""
    key, nk = jax.random.split(key)
    init = jax.random.normal(jax.random.split(nk)[0], shape, jnp.float32)
    per_step = []
    for _ in range(steps):
        key, k_noise, _ = jax.random.split(key, 3)
        per_step.append(jax.random.normal(jax.random.split(k_noise)[0], shape, jnp.float32))
    return np.array(init), [np.array(n) for n in per_step]


def _denoise(xp, x, sigma):
    """A smooth stand-in for D(x; sigma) whose two CFG halves differ."""
    scale = xp.asarray([1.0] * SHAPE[0] + [0.6] * (x.shape[0] - SHAPE[0]), dtype=xp.float32)
    s = sigma.reshape(-1, 1, 1, 1)
    return x / (1.0 + s * s) * scale.reshape(-1, 1, 1, 1) + 0.1 * xp.sin(x)


@pytest.mark.parametrize("kw,use_cfg", [
    (dict(steps=4), True),
    (dict(steps=3, use_heun=False, perturbation_shape="tanh", schedule="ln_linear"), True),
    (dict(steps=3, cfg_scale=1.0, input_perturbation=0.5), False),
])
def test_edm_sample_matches_jax(kw, use_cfg):
    key = jax.random.PRNGKey(5)
    want, _ = jax_edm_sample(lambda x, s: _denoise(jnp, x, s), SHAPE, JaxSampleParams(**kw),
                             200.0, 0.03, 1.0, key, return_debug=False, use_cfg=use_cfg)
    init, per_step = replay_noise(key, SHAPE, kw["steps"])

    def denoise(x, s):
        return _denoise(torch, x, s)

    got = edm_sample(denoise, SHAPE, SampleParams(**kw), 200.0, 0.03, 1.0,
                     init_noise=torch.from_numpy(init),
                     step_noise=[torch.from_numpy(n) for n in per_step], use_cfg=use_cfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_edm_sample_draws_from_the_generator():
    """Without explicit noise the port draws from the generator: same seed,
    same sample; another seed, another sample."""
    params = SampleParams(steps=2)

    def run(seed):
        return edm_sample(lambda x, s: _denoise(torch, x, s), SHAPE, params, 200.0, 0.03, 1.0,
                          generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == SHAPE and torch.isfinite(a).all()


def test_injected_draws_must_cover_the_steps_run():
    """``step_noise`` and ``step_shifts`` hold one draw for each step run:
    ``steps`` from noise, ``round(steps * strength)`` from an init sample."""
    init = torch.zeros(SHAPE)
    noise = [torch.zeros(SHAPE)] * 4
    params = SampleParams(steps=4, img2img_strength=0.5, seamless_loop=True)
    with pytest.raises(ValueError, match="step_noise holds 4 draws for 2 steps"):
        edm_sample(lambda x, s: x, SHAPE, params, 200.0, 0.03, 1.0, init_sample=init,
                   init_noise=init, step_noise=noise)
    with pytest.raises(ValueError, match="step_shifts holds 4 draws for 2 steps"):
        edm_sample(lambda x, s: x, SHAPE, params, 200.0, 0.03, 1.0, init_sample=init,
                   init_noise=init, step_shifts=[0] * 4)
    out = edm_sample(lambda x, s: x, SHAPE, params, 200.0, 0.03, 1.0, init_sample=init + 1.0,
                     init_noise=init, step_noise=noise[:2], step_shifts=[1, 2])
    assert out.shape == SHAPE and torch.isfinite(out).all()


def test_edm_sample_draws_on_the_device_of_its_inputs(monkeypatch):
    """The noise lies where the generator or ``init_noise`` lies; with
    neither (and no ``device``) the sampler draws on the card, and raises
    without one, instead of drawing on the CPU."""
    params = SampleParams(steps=1)

    def denoise(x, s):
        return _denoise(torch, x, s)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edm_sample(denoise, SHAPE, params, 200.0, 0.03, 1.0)
    init = torch.from_numpy(np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32))
    assert edm_sample(denoise, SHAPE, params, 200.0, 0.03, 1.0, init_noise=init).device.type \
        == "cpu"
    assert edm_sample(denoise, SHAPE, params, 200.0, 0.03, 1.0,
                      generator=torch.Generator()).device.type == "cpu"
    assert edm_sample(denoise, SHAPE, params, 200.0, 0.03, 1.0, device="cpu").device.type \
        == "cpu"
