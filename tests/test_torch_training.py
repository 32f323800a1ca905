"""The port's UNet training slice against the JAX package on the CPU: the
logvar head, the sigma sampler, the learning-rate schedules, the dynamic
clip, AdamW, the forced weight norm and the EMA bank, plus the port's
training entry point run as a command. The tiny grouped UNet defined here
is shared with test_torch_train_step.py (its gradients and the whole train
step).

<-> dualdiffusion_tpu/training/{sigma_sampler,optim,ema}.py and
dualdiffusion_tpu/models/unet.py.
"""

import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dualdiffusion_tpu.models.unet as jax_unet_module
import dualdiffusion_tpu_torch.models.unet as port_unet_module
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.sigma_sampler import SigmaSampler as JaxSigmaSampler
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSampler,
                                              SigmaSamplerConfig, build_optimizer,
                                              lr_schedule, normalize_mp_weights)
from dualdiffusion_tpu_torch.training.optim import DynamicGradClip
from dualdiffusion_tpu_torch.weights import load_flat, to_flat

ROOT = Path(__file__).resolve().parents[1]
UNET_KW = dict(in_channels=4, out_channels=4, in_channels_emb=8, model_channels=8,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=8,
               logvar_channels=16, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
X_SHAPE = (4, 8, 16, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


@functools.lru_cache(maxsize=None)
def _jax_unet_vars():
    """The tiny grouped UNet, initialised by JAX, with every zero-initialised
    gain and the logvar head given values so each branch carries signal."""
    unet = JaxUNet(JaxUNetConfig(**UNET_KW))
    v = jax.jit(lambda k: unet.init(k, jnp.zeros((1,) + X_SHAPE[1:]), jnp.ones((1,)),
                                    jnp.zeros((1, 8)), method=JaxUNet.init_all))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fix(path, leaf):
        name = getattr(path[-1], "key", "")
        if leaf.ndim == 0 and "gain" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
        if name == "w_raw":
            return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf
    return unet, jax.tree_util.tree_map_with_path(fix, v)


def _port_unet(jvars) -> UNet:
    model = UNet(UNetConfig(**UNET_KW))
    load_flat(model, _flatten(jvars))
    return model


class _JnpTrunkF32(types.ModuleType):
    """jax.numpy with ``bfloat16`` read as ``float32``: the JAX UNet takes
    its trunk dtype from ``jnp.bfloat16`` (dualdiffusion_tpu/models/unet.py:562)."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


def set_trunk_dtype(monkeypatch, dtype: str) -> None:
    """Run both UNets' trunks in ``dtype``: "bfloat16" as they ship, or
    "float32", where the two packages differ by fp32 rounding alone."""
    if dtype == "float32":
        monkeypatch.setattr(jax_unet_module, "jnp", _JnpTrunkF32("jnp"))
        monkeypatch.setattr(port_unet_module, "ACT_DTYPE", torch.float32)


# ---------------------------------------------------------------------------
# the model's training-side heads
# ---------------------------------------------------------------------------

def test_get_sigma_loss_logvar_matches_jax():
    """fp32 Fourier features and one linear: float rounding (1e-5 of max)."""
    junet, jvars = _jax_unet_vars()
    sigma = np.array([0.03, 0.4, 1.0, 7.5, 200.0], np.float32)
    want = junet.apply(jvars, jnp.asarray(sigma), method=JaxUNet.get_sigma_loss_logvar)
    got = _port_unet(jvars).get_sigma_loss_logvar(torch.from_numpy(sigma))
    assert got.shape == (5, 1, 1, 1) and got.dtype == torch.float32
    assert _rel_err(got.detach(), want) < 1e-5


# ---------------------------------------------------------------------------
# sigma sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["ln_normal", "ln_sech", "ln_sech^2", "ln_linear", "linear",
                                  "scale_invariant", "ln_pdf"])
def test_sigma_distribution_matches_jax(dist):
    """Sigmas at the same quantiles: fp32 transcendental functions in two
    libraries (1e-5 relative per element)."""
    kw = dict(distribution=dist, dist_scale=1.3 if dist != "linear" else 2.0,
              dist_offset=0.2)
    rng = np.random.default_rng(5)
    q = rng.uniform(0.001, 0.999, 64).astype(np.float32)
    pdf = rng.uniform(0.1, 1.0, 127).astype(np.float32)
    js = JaxSigmaSampler(JaxSigmaConfig(**kw))
    qj = jnp.asarray(q)
    want = js._ln_pdf(qj, jnp.asarray(pdf)) if dist == "ln_pdf" else \
        getattr(js, "_" + dist.replace("^2", "2"))(qj)
    got = SigmaSampler(SigmaSamplerConfig(**kw)).sample(torch.from_numpy(q), torch.from_numpy(pdf))
    want = np.asarray(want)
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * np.abs(want))


def test_sigma_quantile_draws_are_stratified_permutations():
    """Stratified draws are (i + 0.5)/n plus one shared jitter in a random
    order; static draws have no jitter; plain draws are uniforms."""
    n = 16
    base = (np.arange(n) + 0.5) / n
    gen = torch.Generator().manual_seed(0)
    q = SigmaSampler(SigmaSamplerConfig()).draw_quantiles(gen, n).numpy()
    jitter = np.sort(q) - base
    assert np.ptp(jitter) < 1e-6 and abs(jitter[0]) <= 0.5 / n
    assert not np.all(np.diff(q) > 0)
    q = SigmaSampler(SigmaSamplerConfig(use_static_sigma_sampling=True)).draw_quantiles(gen, n)
    assert np.allclose(np.sort(q.numpy()), base)
    q = SigmaSampler(SigmaSamplerConfig(use_stratified_sigma_sampling=False)).draw_quantiles(gen, n)
    assert q.shape == (n,) and 0 <= q.min() and q.max() < 1


def test_ln_pdf_update_and_sanitize_match_jax():
    """The pdf from a logvar curve (warmup-scaled, offset, floored,
    sanitized, normalized) to fp32 rounding (1e-6 relative); sanitize
    alone exactly."""
    kw = dict(distribution="ln_pdf", sigma_pdf_warmup_steps=10, sigma_pdf_offset=0.01)
    rng = np.random.default_rng(6)
    coef = rng.standard_normal(4).astype(np.float32)

    def logvar(s, xp):
        ls = xp.log(s) / 4.0
        return coef[0] + coef[1] * ls + coef[2] * ls ** 2 + coef[3] * xp.sin(3 * ls)

    js = JaxSigmaSampler(JaxSigmaConfig(**kw))
    ts = SigmaSampler(SigmaSamplerConfig(**kw))
    pdf0 = rng.uniform(0.5, 1.0, 127).astype(np.float32)
    for step in (0.0, 3.0, 25.0):
        want = js.update_pdf_from_logvar(lambda s: logvar(s, jnp), jnp.asarray(pdf0),
                                         jnp.float32(step))
        got = ts.update_pdf_from_logvar(lambda s: logvar(s, torch), torch.from_numpy(pdf0), step)
        assert _rel_err(got, want) < 1e-6
    noisy = rng.uniform(0.0, 1.0, 127).astype(np.float32)
    assert np.array_equal(SigmaSampler.sanitize_pdf(torch.from_numpy(noisy)).numpy(),
                          np.asarray(JaxSigmaSampler._sanitize_pdf(jnp.asarray(noisy))))


# ---------------------------------------------------------------------------
# optimizer chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["edm2", "edm2_smooth", "constant"])
def test_lr_schedule_matches_jax(name):
    """Python doubles against JAX's fp32: 1e-6 of the peak rate (fp32
    cancellation in edm2_smooth's cos(pi + eps) + 1 near step 0 rules out a
    bound relative to the tiny early rates themselves)."""
    kw = dict(warmup_steps=100, reference_steps=1000, decay_exponent=0.7,
              min_learning_rate=1e-4)
    jfn = joptim.lr_schedule(name, 3e-3, **kw)
    tfn = lr_schedule(name, 3e-3, **kw)
    for step in (0, 1, 50, 99, 100, 101, 999, 1000, 1001, 5000, 100000):
        want = float(jfn(jnp.float32(step)))
        assert abs(tfn(step) - want) <= 1e-6 * 3e-3, step


def test_dynamic_clip_state_matches_jax():
    """Five updates (static bound until seeded, then mean + z*std; a huge
    norm that clips; a NaN element that is zeroed; a non-finite norm that
    zeroes the update and keeps the statistics): grads and state to fp32
    rounding (1e-5 relative)."""
    rng = np.random.default_rng(7)
    clip = joptim.dynamic_grad_clip(z=2.0, static_max_norm=5.0)
    shapes = [(3, 4), (7,), ()]
    jstate = clip.init(None)
    tclip = DynamicGradClip(z=2.0, static_max_norm=5.0)
    for i, scale in enumerate((1.0, 3.0, 50.0, 1.0, 1.0)):
        grads = [np.array(rng.standard_normal(s) * scale, np.float32) for s in shapes]
        if i == 3:
            grads[0][1, 2] = np.nan
        if i == 4:
            grads[1][0] = np.inf
        want, jstate = clip.update([jnp.asarray(g) for g in grads], jstate)
        got = [torch.from_numpy(g.copy()) for g in grads]
        tclip.clip_(got)
        for g, w in zip(got, want):
            assert np.allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
        for name in ("grad_norm_logmean", "grad_norm_logvar", "last_max_norm"):
            assert np.allclose(getattr(tclip, name).item(), float(getattr(jstate, name)),
                               rtol=1e-5), (i, name)


def test_adamw_updates_match_optax():
    """Two AdamW updates with weight decay at a scheduled rate (optax
    counts from 0), behind the clip: fp32 rounding (1e-6 absolute on O(1)
    parameters)."""
    rng = np.random.default_rng(8)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in [(5, 3), (4,)]]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 0.1 for p in p0]
             for _ in range(2)]
    sched = joptim.lr_schedule("edm2", 1e-2, warmup_steps=4)
    jopt = joptim.build_optimizer("adamw", sched, betas=(0.9, 0.99), weight_decay=0.1)
    jp = [jnp.asarray(p) for p in p0]
    jst = jopt.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = build_optimizer("adamw", params, lr_schedule("edm2", 1e-2, warmup_steps=4),
                           betas=(0.9, 0.99), weight_decay=0.1)
    for i, g in enumerate(grads):
        upd, jst = jopt.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        topt.step(i)
    for p, w in zip(params, jp):
        assert np.abs(p.detach().numpy() - np.asarray(w)).max() < 1e-6


def test_normalize_mp_weights_matches_jax():
    """Every w_mp re-normalized to unit RMS per output channel, the rest
    untouched (fp32, 1e-6 of max)."""
    _, jvars = _jax_unet_vars()
    scaled = jax.tree_util.tree_map(lambda a: a * 2.5 + 0.1, jvars)
    want = _flatten(joptim.normalize_mp_weights(scaled))
    model = _port_unet(scaled)
    normalize_mp_weights(model)
    got = to_flat(model)
    for k in want:
        assert _rel_err(got[k], want[k]) < 1e-6, k


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------

def test_ema_betas_and_update_match_jax():
    """Power-function, warmed-up classic, bf16-stored and feedback profiles
    over three updates: betas to 4e-6 relative (doubles against JAX's
    fp32, whose base 1 - t_delta/t_next is rounded once and then raised to
    exp + 1 ~ 18: about 18 * 2**-24 ~ 1e-6 of error, kept well inside), the
    profiles and the fed-back weights to fp32 rounding (bf16 storage: one
    bf16 rounding, 2**-8 relative)."""
    cfgs = [dict(name="pf", std=0.05), dict(name="warm", beta=0.9, num_warmup_steps=4),
            dict(name="half", std=0.1, store_dtype="bfloat16"),
            dict(name="fb", beta=0.8, feedback_beta=0.5)]
    jbank = jema.EMABank([jema.EMAConfig(**c) for c in cfgs])
    tbank = EMABank([EMAConfig(**c) for c in cfgs])
    rng = np.random.default_rng(9)
    module = torch.nn.Linear(3, 2)
    jparams = {"weight": jnp.asarray(module.weight.detach().numpy()),
               "bias": jnp.asarray(module.bias.detach().numpy())}
    jstate, tstate = jbank.init(jparams), tbank.init(module)
    bs = 8
    for step in range(3):
        new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jparams.items()}
        jparams = {k: jnp.asarray(v) for k, v in new.items()}
        with torch.no_grad():
            for k, p in module.named_parameters():
                p.copy_(torch.from_numpy(new[k]))
        for name, cfg in tbank.configs.items():
            jb = float(jbank._beta(jbank.configs[name], jnp.int32(step * bs), bs,
                                   jnp.float32(step)))
            assert abs(tbank.beta(cfg, step * bs, bs, step) - jb) <= 4e-6 * max(jb, 1e-6)
        # the JAX step passes its counters as traced int32 / fp32 scalars
        jstate, jparams = jbank.update(jstate, jparams, jnp.int32(step * bs), bs,
                                       jnp.float32(step))
        tbank.update(tstate, module, step * bs, bs, step)
        for name in tbank.configs:
            tol = 2 ** -8 if name == "half" else 1e-6
            for k in jparams:
                w = np.asarray(jstate[name][k], np.float32)
                g = tstate[name][k].float().numpy()
                assert np.all(np.abs(g - w) <= tol * np.abs(w) + 1e-7), (step, name, k)
        for k, p in module.named_parameters():
            assert np.allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    assert tbank.get_betas(16, 8)["pf"] == pytest.approx(
        jbank.get_betas(16, 8)["pf"], rel=1e-6)


# ---------------------------------------------------------------------------
# the training entry point, run as a command
# ---------------------------------------------------------------------------

def test_train_entry_runs_and_resumes_on_cpu(tmp_path):
    """``python -m dualdiffusion_tpu_torch.train --device cpu``: 2 steps,
    then ``--resume`` to step 3. The checkpoint holds the module, the EMA
    and the train state; the resumed run continues the step counter, the
    AdamW moments (step 3, not 1) and the EMA (exactly the lerp of the
    step-2 profile toward the step-3 weights), with finite losses."""
    from dualdiffusion_tpu_torch.dataset import write_latent_dataset
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.training.ema import power_function_beta
    from dualdiffusion_tpu_torch.utils import load_safetensors

    cfg = UNetConfig(**UNET_KW)
    unet = UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    Pipeline({"unet": ModuleHandle("unet", "unet", cfg, unet)}).save_pretrained(tmp_path / "m")
    write_latent_dataset(tmp_path / "d", 8, (4, 8, 16), 8, seed=1)
    (tmp_path / "tc.json").write_text(json.dumps({
        "device_batch_size": 2, "gradient_accumulation_steps": 2, "checkpoints_total_limit": 2,
        "lr_schedule": {"lr_warmup_steps": 0}, "dataloader": {"latents_crop_width": 16},
        "emas": {"std0.05": {"std": 0.05}}}))
    cmd = [sys.executable, "-m", "dualdiffusion_tpu_torch.train", "--device", "cpu",
           "--model_path", str(tmp_path / "m"), "--train_config_path", str(tmp_path / "tc.json"),
           "--dataset_path", str(tmp_path / "d")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = ""
    for extra in (["--max_steps", "2"], ["--resume", "--max_steps", "3"]):
        proc = subprocess.run(cmd + extra, cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        logs += proc.stderr
    assert "resumed from" in logs and "at step 2" in logs
    losses = [float(line.split(" loss ")[1].split()[0]) for line in logs.splitlines()
              if " loss " in line]
    assert len(losses) == 3 and np.all(np.isfinite(losses))

    ck2, ck3 = tmp_path / "m" / "unet_checkpoint-2", tmp_path / "m" / "unet_checkpoint-3"
    for f in ("unet/unet.json", "unet/unet.safetensors", "unet/ema_std0.05.safetensors",
              "train_state.pt", "trainer_state.json"):
        assert (ck3 / f).is_file(), f
    assert json.loads((ck3 / "trainer_state.json").read_text())["global_step"] == 3
    ts = torch.load(ck3 / "train_state.pt")
    assert ts["global_step"] == 3 and ts["total_samples_processed"] == 12
    assert all(int(s["step"]) == 3 for s in ts["optimizer"]["adamw"]["state"].values())
    beta = power_function_beta(0.05, 8 + 4, 4)
    e2 = load_safetensors(ck2 / "unet" / "ema_std0.05.safetensors")
    e3 = load_safetensors(ck3 / "unet" / "ema_std0.05.safetensors")
    p3 = load_safetensors(ck3 / "unet" / "unet.safetensors")
    for k in e3:
        assert np.allclose(e3[k], e2[k] * np.float32(beta) + p3[k] * np.float32(1 - beta),
                           rtol=1e-6, atol=1e-7), k


def test_trainer_validate_scores_train_and_ema_weights():
    """Trainer.validate with the port's eval step: one finite loss for the
    train weights and one per validation EMA, the same numbers on a second
    call (fixed seed), the EMA's weights giving their own loss, and the
    train weights put back exactly afterwards."""
    from dualdiffusion_tpu_torch.training import (Trainer, TrainerConfig, UNetTrainConfig,
                                                  init_train_state, make_unet_eval_step)
    _, jvars = _jax_unet_vars()
    model = _port_unet(jvars)
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    state = init_train_state(model, build_optimizer("adamw", model.parameters(), 1e-3), bank,
                             SigmaSamplerConfig(), torch.Generator())
    with torch.no_grad():
        for v in state.ema_state["std0.05"].values():
            v.mul_(0.5)
    rng = np.random.default_rng(11)
    batches = [{"samples": torch.from_numpy(rng.standard_normal(X_SHAPE).astype(np.float32)),
                "embeddings": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
                "paths": ["a", "b", "c", "d"]} for _ in range(2)]
    trainer = Trainer(TrainerConfig(), lambda st, b: {}, state, [], ema_bank=bank,
                      validation_dataloader=batches,
                      eval_step=make_unet_eval_step(UNetTrainConfig()))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    first, second = trainer.validate(), trainer.validate()
    assert set(first) == {"train", "ema_std0.05"} and first == second
    assert all(np.isfinite(v) for v in first.values())
    assert first["train"] != first["ema_std0.05"]
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
