"""The port's DAE train step on two gloo ranks under data parallelism, each
fed its share of the global audio and JAX's draws of the global
microbatches, against JAX's step on the 8-device mesh (``shard_batch``) and
the port's own step on one process. The step's batch statistics span the
global microbatch: the "dynamic" MSS2D weights, the prime-width 1-D MSS's
rms, the dispersion roll over the batch, the KL's latent moments and the
latent stats buffers.

<-> dualdiffusion_tpu/training/module_trainers.py make_dae_train_step under
dualdiffusion_tpu/parallel/mesh.py shard_batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from dualdiffusion_tpu.parallel import make_mesh as jax_make_mesh
from dualdiffusion_tpu.parallel import replicate_state as jax_replicate_state
from dualdiffusion_tpu.parallel import shard_batch as jax_shard_batch
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import losses as jlosses
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.module_trainers import DAETrainConfig as JaxDAETrainConfig
from dualdiffusion_tpu.training.module_trainers import make_dae_train_step as jax_make_dae_step
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu_torch.weights import state_to_flat, to_flat
from test_torch_dae_training import (DAE_KW, FMT_KW, RAW_LEN, _audio, _formats,
                                     _jax_dae_draws, _jax_dae_vars, _port_dae)

LR, N, ACCUM = 1e-3, 8, 2
# no phase-invariance view: the JAX phase rotation is per sample at B = 1 only
TRAIN_KW = dict(grad_accum_steps=ACCUM, kl_warmup_steps=4, latents_regularization_warmup_steps=4,
                point_loss_warmup_steps=4, latents_dispersion_loss_weight=0.5,
                phase_invariance_loss_weight=0.0, mss1d_prime_loss_weight=0.1)
MSS_KW = dict(block_widths=(8, 16), frequency_weighting="dynamic")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_dae")
    jfmt, _ = _formats()
    jdae, jvars = _jax_dae_vars()
    jtc = JaxDAETrainConfig(mss2d=jlosses.MSSLoss2DConfig(**MSS_KW), **TRAIN_KW)
    jopt = joptim.build_optimizer("adamw", LR)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])
    jstep = jax.jit(jax_make_dae_step(jdae, jfmt, jopt, jbank, jtc, N))
    mesh = jax_make_mesh()
    jstate = jax_replicate_state(mesh, jax_init_train_state(jvars, jopt, jbank, JaxSigmaConfig(),
                                                            jax.random.PRNGKey(3)))
    audio, draws, jlogs = [], [], []
    for i in range(2):
        a = _audio((N, 2, RAW_LEN), 20 + i) * np.array([[[1.0], [0.6]]], np.float32)
        draws.append(_jax_dae_draws(jstate.rng, ACCUM, N // ACCUM))
        with mesh:
            jstate, jl = jstep(jstate, jax_shard_batch(mesh, {"audio": jnp.asarray(a)}))
        audio.append(torch.from_numpy(a))
        jlogs.append(jl)

    inp = {"state": _port_dae(jvars).state_dict(), "dae_kw": DAE_KW, "fmt_kw": FMT_KW,
           "train_kw": TRAIN_KW, "mss_kw": MSS_KW, "lr": LR, "n": N, "audio": audio,
           "draws": draws}
    model, step, state = ranks.dae_setup(inp)
    logs = [step(state, {"audio": a}, d) for a, d in zip(audio, draws)]
    torch.save(inp, tmp / "dae_inputs.pt")
    ranks.spawn(ranks.dae_steps, 2, tmp)
    return dict(jvars=jvars, jstate=jstate, jlogs=jlogs, model=model, state=state, logs=logs,
                dp=torch.load(tmp / "dae_dp.pt", weights_only=False))


def test_data_parallel_dae_step_matches_one_process(runs):
    """Two ranks against one process: every logged mean (loss, recon, KL,
    dispersion, the latents' mean and variance) and the grad norm to 1e-5
    relative, the per-sample losses, parameters and EMA (the stats buffers
    and their EMA included) to 1e-5."""
    dp = runs["dp"]
    for got, want in zip(dp["logs"], runs["logs"]):
        for k, v in want.items():
            if k == "sample_losses":
                b = v.shape[0] // (2 * ACCUM)
                order = got[k].reshape(2, ACCUM, b).transpose(0, 1).reshape(-1)
                torch.testing.assert_close(order, v, rtol=1e-5, atol=1e-6)
            elif v.dim() == 0:
                assert abs(got[k] - float(v)) <= 1e-5 * abs(float(v)) + 1e-7, k
    want_p, want_e = to_flat(runs["model"]), state_to_flat(runs["state"].ema_state["std0.05"])
    for k in want_p:
        for got, want in ((dp["params"][k], want_p[k]), (dp["ema"][k], want_e[k])):
            assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), k


def test_data_parallel_dae_step_matches_jax_mesh(runs):
    """Two ranks against JAX's step on the 8-device mesh: loss, grad norm,
    KL and dispersion to 1e-4 relative (as test_torch_dae_training holds the
    one-process step); the stats buffers and their EMA to 1e-5 relative;
    params and EMA within 1e-5 of the one-process port's own distance from
    JAX, element by element, and to lr/20 on all but 0.1% of the elements.
    (AdamW's first update is about +-lr per element, m / sqrt(v) of a near-
    zero gradient element moves with fp32 rounding: at this batch the
    one-process port's largest distance from JAX is 6.3e-5, on one element.)"""
    dp, jstate = runs["dp"], runs["jstate"]
    for got, want in zip(dp["logs"], runs["jlogs"]):
        for k in ("loss", "grad_norm", "loss_kl", "loss_dispersion"):
            assert abs(got[k] - float(want[k])) <= 1e-4 * abs(float(want[k])), k
    want_p, want_e = _flatten(jstate.params), _flatten(jstate.ema_state["std0.05"])
    one_p = to_flat(runs["model"])
    one_e = state_to_flat(runs["state"].ema_state["std0.05"])
    start = _flatten(runs["jvars"])
    moved, far, total = 0.0, 0, 0
    for k in want_p:
        for got, one, want in ((dp["params"][k], one_p[k], want_p[k]),
                               (dp["ema"][k], one_e[k], want_e[k])):
            want = np.asarray(want)
            if k.startswith("stats/"):
                assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), k
                continue
            assert np.all(np.abs(got - want) <= np.abs(one - want) + 1e-5), k
            far += int((np.abs(got - want) > LR / 20).sum())
            total += want.size
        moved = max(moved, float(np.abs(np.asarray(want_p[k]) - start[k]).max()))
    assert far <= 1e-3 * total
    assert moved > 6 * LR       # the comparison is not trivially met
