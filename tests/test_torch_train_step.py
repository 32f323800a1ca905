"""The port's whole UNet train step against the JAX package on the CPU,
with the trunk in fp32 (the packages differ by fp32 rounding alone, so the
bounds are tight) and in bf16 as they ship (they round at different places,
so the bounds are those of bf16).

<-> dualdiffusion_tpu/training/train_state.py make_unet_train_step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.sigma_sampler import SigmaSampler as JaxSigmaSampler
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import UNetTrainConfig as JaxUNetTrainConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu.training.train_state import make_unet_train_step as jax_make_step
from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, MicroDraws,
                                              SigmaSamplerConfig, StepDraws, UNetTrainConfig,
                                              build_optimizer, init_train_state,
                                              make_unet_train_step)
from dualdiffusion_tpu_torch.weights import state_to_flat, to_flat
from test_torch_training import (X_SHAPE, _jax_unet_vars, _port_unet, _rel_err, _t,
                                 set_trunk_dtype)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


TRAIN_KW = dict(conditioning_dropout=0.25, conditioning_perturbation=0.05,
                input_perturbation=0.3, use_dynamic_sigma_data=True, num_loss_buckets=6,
                grad_accum_steps=2)
SIGMA_KW = dict(distribution="ln_pdf", sigma_pdf_warmup_steps=1)


def _jax_draws(rng_key, sampler, tc, n, micro_shape, emb_shape):
    """The draws of one JAX train step, from its key splits
    (train_state.py:105,118,125,168,179,186; sigma_sampler.py:123-127)."""
    rng, step_key, sigma_key = jax.random.split(rng_key, 3)
    kq, kp = jax.random.split(sigma_key)
    q = jax.random.permutation(kp, sampler._quantiles(kq, n))
    micro = []
    for k in jax.random.split(step_key, tc.grad_accum_steps):
        k_cond, k_noise, _ = jax.random.split(k, 3)
        micro.append(MicroDraws(
            cond_u=_t(jax.random.uniform(k_cond, (micro_shape[0],))),
            noise=_t(jax.random.normal(k_noise, micro_shape)),
            perturbation=_t(jax.random.normal(jax.random.fold_in(k, 2), micro_shape)),
            cond_noise=_t(jax.random.normal(jax.random.fold_in(k, 1), emb_shape))))
    return rng, StepDraws(_t(q), micro)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype, monkeypatch):
    """Two steps of the tiny grouped UNet with gradient accumulation 2, one
    power-function EMA, ln_pdf sigmas, conditioning dropout and
    perturbation, input perturbation and dynamic sigma_data, the port fed
    the draws of JAX's key splits.

    fp32 trunk: loss, grad norm and sigma pdf to 1e-5 relative; params and
    EMA to lr/20 absolute (AdamW's first updates are about +-lr per element
    whatever the gradient's size, so this holds every element's update).

    bf16 trunk: the packages round at different places, so the loss and
    grad norm agree to 2e-2 relative and the sigma pdf to 1e-2. A
    bf16-level gradient difference on a near-zero element flips the sign of
    its +-lr update, in each of the two steps, and the forced weight norm
    then rescales its row: params and EMA agree to 6 lr per element, and
    no more than 2% of all elements differ by more than lr/2."""
    set_trunk_dtype(monkeypatch, dtype)
    f32 = dtype == "float32"
    junet, jvars = _jax_unet_vars()
    lr, n = 1e-3, X_SHAPE[0]
    jtc = JaxUNetTrainConfig(sigma=JaxSigmaConfig(**SIGMA_KW), **TRAIN_KW)
    jopt = joptim.build_optimizer("adamw", lr)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])

    def unet_apply(p, x, sigma, emb, ref, k, x_perturbed=None):
        return junet.apply(p, x, sigma, emb, training=True, x_perturbed=x_perturbed)

    def get_emb(p, e, m):
        return junet.apply(p, e, m, method=JaxUNet.get_embeddings)

    def get_logvar(p, s):
        return junet.apply(p, s, method=JaxUNet.get_sigma_loss_logvar)

    jstep = jax.jit(jax_make_step(unet_apply, get_emb, get_logvar, jopt, jbank, jtc, n))
    jstate = jax_init_train_state(jvars, jopt, jbank, jtc.sigma, jax.random.PRNGKey(3))

    tc = UNetTrainConfig(sigma=SigmaSamplerConfig(**SIGMA_KW), **TRAIN_KW)
    model = _port_unet(jvars)
    opt = build_optimizer("adamw", model.parameters(), lr)
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    tstep = make_unet_train_step(opt, bank, tc, n)
    tstate = init_train_state(model, opt, bank, tc.sigma, torch.Generator())

    rng = np.random.default_rng(10)
    jsampler = JaxSigmaSampler(jtc.sigma)
    micro_shape = (n // 2,) + X_SHAPE[1:]
    rel = 1e-5 if f32 else 2e-2
    for _ in range(2):
        batch = {"samples": rng.standard_normal(X_SHAPE).astype(np.float32) * 1.5,
                 "embeddings": rng.standard_normal((n, 8)).astype(np.float32)}
        _, draws = _jax_draws(jstate.rng, jsampler, jtc, n, micro_shape, (n // 2, 32))
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tlogs = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        assert abs(float(tlogs["loss"]) - float(jlogs["loss"])) <= rel * abs(float(jlogs["loss"]))
        assert abs(float(tlogs["grad_norm"]) - float(jlogs["grad_norm"])) <= \
            rel * float(jlogs["grad_norm"])
        assert np.array_equal(tlogs["bucket_counts"].numpy(), np.asarray(jlogs["bucket_counts"]))
    assert tstate.global_step == 2 and tstate.total_samples_processed == 2 * n
    assert _rel_err(tstate.sigma_pdf, jstate.sigma_pdf) < (1e-5 if f32 else 1e-2)

    want_p, got_p = _flatten(jstate.params), to_flat(model)
    want_e = _flatten(jstate.ema_state["std0.05"])
    got_e = state_to_flat(tstate.ema_state["std0.05"])
    start = _flatten(jvars)
    moved, far, total = 0.0, 0, 0
    for k in want_p:
        for got, want in ((got_p[k], want_p[k]), (got_e[k], want_e[k])):
            diff = np.abs(got - want)
            assert diff.max() <= (lr / 20 if f32 else 6 * lr), k
            far += int((diff > lr / 2).sum())
            total += diff.size
        moved = max(moved, float(np.abs(want_p[k] - start[k]).max()))
    assert far <= 0.02 * total
    assert moved > 6 * lr       # the comparison is not trivially met
