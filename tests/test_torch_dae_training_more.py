"""The rest of the port's DAE trainer against the JAX package on the CPU:
one m1 step (``domain="mdct"``: the samples the MDCT of a random phase
rotation, the phase-invariance view another rotation, the fused MSS2D over
the MDCT image and the prime-width 1-D MSS over its width, NorMuon) and one
p1 step (the mel domain, the randomized-prime 2-D MSS in place of MSS2D,
the latent shift-equivariance loss, Muon), each fed the draws of JAX's key
splits, and both with the step's own draws.

<-> dualdiffusion_tpu/training/module_trainers.py:133-339,
dualdiffusion_tpu/training/optim.py:146-266.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import losses as jlosses
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.module_trainers import DAETrainConfig as JaxDAETrainConfig
from dualdiffusion_tpu.training.module_trainers import make_dae_train_step as jax_make_dae_step
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu_torch.training import (DAEMicroDraws, DAETrainConfig, EMABank, EMAConfig,
                                              SigmaSamplerConfig, build_optimizer,
                                              init_train_state, make_dae_train_step)
from dualdiffusion_tpu_torch.training.losses import MSSLoss2DConfig, PrimeMSSDraws
from dualdiffusion_tpu_torch.training.optim import jax_param_paths
from dualdiffusion_tpu_torch.weights import state_to_flat, to_flat
from test_torch_dae_training import RAW_LEN, _audio, _formats, _jax_dae_vars, _port_dae, _t


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_prime_draws(key, h, w, num_iterations=16, num_size_sets=4):
    """JAX random_prime_mss_2d's draws from ``key`` (losses.py:246-298)."""
    rng = np.random.default_rng(0)
    sets = [jlosses._draw_prime_sizes(rng, num_iterations, h, w) for _ in range(num_size_sets)]
    k_set, k_iter = jax.random.split(key)
    idx = int(jax.random.randint(k_set, (), 0, num_size_sets))
    offsets, flags = [], []
    for (bh, bw), k in zip(sets[idx], jax.random.split(k_iter, num_iterations)):
        k_off, k_ms = jax.random.split(k)
        offsets.append((int(jax.random.randint(k_off, (), 0, max(h - bh, 0) + 1)),
                        int(jax.random.randint(jax.random.fold_in(k_off, 1), (), 0,
                                               max(w - bw, 0) + 1))))
        flags.append(bool(jax.random.bernoulli(k_ms)))
    return PrimeMSSDraws(idx, offsets, flags)


def _jax_step_draws(rng_key, accum, micro_b, kw, sample_hw):
    """Every draw of one JAX DAE step from its key splits (module_trainers.py:
    48, 175, 182, 213, 245, 288, 295-302; ms_mdct_dual.py:266)."""
    _, step_key = jax.random.split(rng_key)
    draws = []
    for k in jax.random.split(step_key, accum):
        k_st, k_ph, k_drop = jax.random.split(k, 3)
        d = DAEMicroDraws(
            torch.from_numpy(np.array(jax.random.bernoulli(k_st, 0.5, (micro_b,)))),
            _t(jax.random.uniform(jax.random.fold_in(k_ph, 7), (micro_b,)) * 2 * jnp.pi))
        if kw.get("domain") == "mdct":
            d.mdct_theta = _t(jax.random.uniform(k_ph, (micro_b,)) * 2 * jnp.pi)
        if kw.get("use_random_prime_mss"):
            d.prime_mss = _jax_prime_draws(k_drop, *sample_hw)
        if kw.get("equivariance_loss_weight", 0) > 0:
            ky, kx = jax.random.split(jax.random.fold_in(k_drop, 11))
            d.equivariance = tuple([int(v) for v in jax.random.randint(kk, (micro_b,), 1, 9)]
                                   for kk in (ky, kx))
        draws.append(d)
    return draws


M1 = dict(domain="mdct", use_fused_mss2d=True, mss1d_prime_loss_weight=1.0,
          mss2d=(8, 16, 32))
P1 = dict(use_random_prime_mss=True, equivariance_loss_weight=0.5)


@pytest.mark.parametrize("case,optimizer", [("m1", "normuon"), ("p1", "muon")])
def test_dae_step_matches_jax(case, optimizer):
    """Two steps of the tiny DAE, fp32 trunk, accumulation 2 of one sample
    each (the JAX phase rotation is per sample only at B = 1), the phase
    invariance, point, KL and (p1) equivariance terms past half their
    warm-ups, the optimizer routing the DAE's ``w_mp`` weights (by JAX path,
    without the "params/" prefix: the DAE's optimizer gets the "params"
    collection alone) to Muon / NorMuon and the rest to AdamW, one
    power-function EMA. Loss and grad norm to 1e-4 relative; params and the
    EMA to lr/20 absolute (AdamW's first update is about +-lr per element
    whatever the gradient's size, and Muon's is lr times the orthogonalized
    momentum, O(1) per element); the stats buffers to 1e-5 relative."""
    jfmt, tfmt = _formats()
    jdae, jvars = _jax_dae_vars()
    lr, n, accum = 1e-3, 2, 2
    kw = dict(M1 if case == "m1" else P1)
    widths = kw.pop("mss2d", (8, 16))
    kw.update(grad_accum_steps=accum, kl_warmup_steps=4, latents_regularization_warmup_steps=4,
              point_loss_warmup_steps=4)
    jtc = JaxDAETrainConfig(mss2d=jlosses.MSSLoss2DConfig(block_widths=widths), **kw)
    jopt = joptim.build_optimizer(optimizer, lr)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])
    jstep = jax.jit(jax_make_dae_step(jdae, jfmt, jopt, jbank, jtc, n))
    jstate = jax_init_train_state(jvars, jopt, jbank, JaxSigmaConfig(), jax.random.PRNGKey(3))

    model = _port_dae(jvars)
    opt = build_optimizer(optimizer, jax_param_paths(model, collection=False), lr)
    n_muon = len(opt.muon.params)
    assert n_muon == sum(1 for k, _ in model.named_parameters() if k.endswith(".w_mp")) > 0
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    tcfg = DAETrainConfig(mss2d=MSSLoss2DConfig(block_widths=widths), **kw)
    tstep = make_dae_train_step(tfmt, opt, bank, tcfg, n)
    tstate = init_train_state(model, opt, bank, SigmaSamplerConfig(), torch.Generator())
    start = _flatten(jvars)
    for i in range(2):
        audio = _audio((n, 2, RAW_LEN), 30 + i) * np.array([[[1.0], [0.6]]], np.float32)
        views = (tfmt.raw_to_mdct(torch.from_numpy(audio[:1])) if case == "m1"
                 else tfmt.raw_to_mel_spec(torch.from_numpy(audio[:1])))
        hw = (views.shape[1], (views.shape[2] - 8) // 2 * 2)
        draws = _jax_step_draws(jstate.rng, accum, n // accum, kw, hw)
        jstate, jlogs = jstep(jstate, {"audio": jnp.asarray(audio)})
        tlogs = tstep(tstate, {"audio": torch.from_numpy(audio)}, draws)
        for k in ("loss", "grad_norm", "loss_recon") + (
                ("loss_equivariance",) if case == "p1" else ()):
            assert abs(float(tlogs[k]) - float(jlogs[k])) <= 1e-4 * abs(float(jlogs[k])), (i, k)
    want_p, got_p = _flatten(jstate.params), to_flat(model)
    want_e = _flatten(jstate.ema_state["std0.05"])
    got_e = state_to_flat(tstate.ema_state["std0.05"])
    moved = 0.0
    for k in want_p:
        for got, want in ((got_p[k], want_p[k]), (got_e[k], want_e[k])):
            if k.startswith("stats/"):
                assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), k
            else:
                assert np.abs(got - want).max() <= lr / 20, k
        moved = max(moved, float(np.abs(want_p[k] - start[k]).max()))
    assert moved > 6 * lr       # the comparison is not trivially met


def test_dae_step_draws_its_own():
    """Without injected draws the step draws everything it needs from the
    state's generator (the randomized-prime sets from the samples' shape)
    and takes finite steps in both domains."""
    _, tfmt = _formats()
    _, jvars = _jax_dae_vars()
    for kw in (dict(M1, mss2d=None), dict(P1)):
        kw.pop("mss2d", None)
        model = _port_dae(jvars)
        opt = build_optimizer("adamw", model.parameters(), 1e-3)
        tstep = make_dae_train_step(tfmt, opt, None, DAETrainConfig(
            grad_accum_steps=2, mss2d=MSSLoss2DConfig(block_widths=(8, 16)), **kw), 4)
        tstate = init_train_state(model, opt, None, SigmaSamplerConfig(),
                                  torch.Generator().manual_seed(0))
        logs = tstep(tstate, {"audio": torch.from_numpy(_audio((4, 2, RAW_LEN), 40))})
        assert np.isfinite(float(logs["loss"])) and tstate.global_step == 1
