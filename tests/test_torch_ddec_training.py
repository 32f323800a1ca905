"""The port's DDEC trainer against the JAX package on the CPU: the prepare
stage (stereo flip, rotated MDCT, back to raw, mel, the frozen DAE's
reconstruction, the edge crop, ``mel_spec_to_linear``), two whole DDEC train
steps, the validation step with the prepare stage, the per-sample phase
rotation at a batch where the JAX rotation raises, and the port's training
entry run as a command with the "ddec" module trainer.

Tiny models, fp32 trunks, JAX-initialised weights carried over, JAX's key
splits replayed as explicit draws (train_state.py:168, :92, :105;
module_trainers.py:79, :48; ms_mdct_dual.py:266).

<-> dualdiffusion_tpu/training/module_trainers.py make_ddec_train_step and
dualdiffusion_tpu/training/train_state.py make_unet_train_step /
make_unet_eval_step with ``prepare_fn``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dualdiffusion_tpu.training.module_trainers as jax_module_trainers
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import MSMDCTDualFormat as JaxFormat
from dualdiffusion_tpu.models.formats import MSMDCTDualFormatConfig as JaxFormatConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.module_trainers import DDECTrainConfig as JaxDDECTrainConfig
from dualdiffusion_tpu.training.sigma_sampler import SigmaSampler as JaxSigmaSampler
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu.training.train_state import make_unet_eval_step as jax_make_eval_step
from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.training import (DDECPrepareDraws, DDECTrainConfig, EMABank,
                                              EMAConfig, EvalDraws, MicroDraws, StepDraws,
                                              build_optimizer, ddec_sample_shape,
                                              init_train_state, make_ddec_eval_step,
                                              make_ddec_train_step)
from dualdiffusion_tpu_torch.training.module_trainers import make_ddec_prepare
from dualdiffusion_tpu_torch.weights import load_flat, state_to_flat, to_flat
from test_torch_ddec import DDEC_KW, _jax_ddec_vars
from test_torch_training import set_trunk_dtype

ROOT = Path(__file__).resolve().parents[1]
# a 32-filter mel on a 256-point STFT and a 64-sample MDCT, both hop 32
FMT_KW = dict(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
              default_raw_length=63 * 32)
RAW_LEN = 63 * 32      # 64 mel and MDCT frames; 56 after the edge crop of 4
# the d3 series' DAE at a tiny width: a full-resolution encoder of two
# layers, two decoder levels (downsample ratio 2), label-conditioned
DAE_KW = dict(model_channels=8, channel_mult_enc=(1,), channel_mult_dec=(1, 2),
              num_enc_layers_per_block=2, num_dec_layers_per_block=1, latent_channels=4,
              in_channels_emb=16, supersampled=True, compute_dtype="float32")
EMB_DIM = 16
EMAS = (("std0.05", 0.05), ("std0.1", 0.1))


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


def _audio(shape, seed):
    """Sinusoids plus noise, the right channel quieter, so a flip shows."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 32000
    sig = sum(np.sin(2 * np.pi * f * t + p) for f, p in
              zip(rng.uniform(100, 3000, 4), rng.uniform(0, 6, 4)))
    x = 0.1 * sig + 0.05 * rng.standard_normal(shape)
    return (x * np.array([1.0, 0.6])[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _formats():
    return JaxFormat(JaxFormatConfig(**FMT_KW)), MSMDCTDualFormat(MSMDCTDualFormatConfig(**FMT_KW))


def jax_dae_init_all(module, x, emb_in):
    """Runs every part of the JAX DAE, so its init creates the label
    conditioning too (JAX's plain init creates it only when it runs it)."""
    return module(x, module.get_embeddings(emb_in))


def draw_dae_vars(jdae, x_shape, emb_dim, seed):
    """The DAE's variables, shaped by JAX's init and drawn with numpy:
    unit-normal weights and block gains, small biases, out_gain near 1, a
    logvar near 0 and stats away from their initial values."""
    shapes = jax.eval_shape(lambda k: jdae.init(k, jnp.zeros(x_shape), jnp.zeros((1, emb_dim)),
                                                method=jax_dae_init_all), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if path[0].key == "stats" or name == "out_gain":
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "recon_loss_logvar":
            a = rng.uniform(-0.3, 0.3, leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) * (0.3 if name == "bias" else 1.0)
        return jnp.asarray(a, leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_dae():
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    return jdae, draw_dae_vars(jdae, (1, 32, 56, 2), EMB_DIM, 1)


def _port_dae(jvars) -> DAE:
    model = DAE(DAEConfig(**DAE_KW))
    load_flat(model, _flatten(jvars))
    return model


def _port_ddec(jvars) -> UNet:
    model = UNet(UNetConfig(**DDEC_KW))
    load_flat(model, _flatten(jvars))
    return model


def _jax_prepare(jtc, jdae, jdae_vars):
    """The JAX DDEC trainer's prepare stage: make_ddec_train_step hands it
    to make_unet_train_step, which the test intercepts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_module_trainers, "make_unet_train_step",
                   lambda *a, prepare_fn=None, **k: prepare_fn)
        return jax_module_trainers.make_ddec_train_step(
            None, None, jdae, jdae_vars, _formats()[0], None, None, jtc, 1)


def _prepare_draws(k_prep, b=1):
    """The prepare stage's draws from its key (module_trainers.py:79, :48;
    ms_mdct_dual.py:266)."""
    k_st, k_ph = jax.random.split(k_prep)
    return DDECPrepareDraws(torch.from_numpy(np.array(jax.random.bernoulli(k_st, 0.5, (b,)))),
                            _t(jax.random.uniform(k_ph, (b,)) * 2 * jnp.pi))


# ---------------------------------------------------------------------------
# (a) the prepare stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ground_truth", [False, True])
def test_ddec_prepare_matches_jax(ground_truth):
    """samples (the cropped MDCT of the rotated audio) and ref_samples (the
    linear PSD of the frozen DAE's reconstruction of its mel, or of the mel
    itself with ``condition_on_ground_truth``) at microbatch 1, the flip and
    angle of JAX's key: 1e-5 of max; the embeddings pass through."""
    jdae, jvars = _jax_dae()
    kw = dict(crop_edges=4, condition_on_ground_truth=ground_truth)
    jprep = jax.jit(_jax_prepare(JaxDDECTrainConfig(**kw), jdae, jvars))
    prep = make_ddec_prepare(_formats()[1], _port_dae(jvars), DDECTrainConfig(**kw))
    emb = np.random.default_rng(2).standard_normal((1, EMB_DIM)).astype(np.float32)
    for seed in (3, 4):
        audio = _audio((1, 2, RAW_LEN), seed)
        key = jax.random.PRNGKey(seed)
        want = jprep({"audio": jnp.asarray(audio), "audio_embeddings": jnp.asarray(emb)}, key)
        with torch.no_grad():
            got = prep({"audio": torch.from_numpy(audio), "audio_embeddings": _t(emb)},
                       _prepare_draws(key))
        assert got["samples"].shape == (1, 32, 56, 2) and got["ref_samples"].shape == (1, 128, 56, 2)
        assert _rel_err(got["samples"], want["samples"]) <= 1e-5
        assert _rel_err(got["ref_samples"], want["ref_samples"]) <= 1e-5
        assert np.array_equal(got["embeddings"].numpy(), emb)


# ---------------------------------------------------------------------------
# (b) two whole train steps
# ---------------------------------------------------------------------------

def _jax_ddec_draws(rng_key, sampler, accum, n, sample_shape):
    """The draws of one JAX DDEC step (train_state.py:168, :92, :105, :109,
    :118; sigma_sampler.py:123-127)."""
    _, step_key, sigma_key = jax.random.split(rng_key, 3)
    kq, kp = jax.random.split(sigma_key)
    q = jax.random.permutation(kp, sampler._quantiles(kq, n))
    micro = []
    for k in jax.random.split(step_key, accum):
        key, k_prep = jax.random.split(k)
        k_cond, k_noise, _ = jax.random.split(key, 3)
        micro.append(MicroDraws(cond_u=_t(jax.random.uniform(k_cond, (sample_shape[0],))),
                                noise=_t(jax.random.normal(k_noise, sample_shape)),
                                perturbation=None, cond_noise=None,
                                prepare=_prepare_draws(k_prep, sample_shape[0])))
    return StepDraws(_t(q), micro)


def test_ddec_train_step_matches_jax(monkeypatch):
    """Two steps of the tiny DDEC, fp32 trunk, gradient accumulation 2 of one
    sample each (the JAX phase rotation is per sample only at B = 1), both
    power-function EMAs, ``audio_embeddings`` in the batch (the DDEC ignores
    them, but JAX still draws the conditioning uniforms), the port fed the
    draws of JAX's key splits: loss and grad norm to 1e-4 relative, params
    and EMAs to lr/20 absolute (AdamW's first updates are about +-lr per
    element whatever the gradient's size); the teacher DAE bit for bit
    unchanged."""
    set_trunk_dtype(monkeypatch, "float32")
    jdae, jdae_vars = _jax_dae()
    jvars = _jax_ddec_vars()
    junet = JaxUNet(JaxUNetConfig(**DDEC_KW))
    lr, n, accum = 1e-3, 2, 2
    jtc = JaxDDECTrainConfig()
    jtc.unet.grad_accum_steps = accum
    jopt = joptim.build_optimizer("adamw", lr)
    jbank = jema.EMABank([jema.EMAConfig(name=k, std=s) for k, s in EMAS])

    def ddec_apply(p, x, sigma, emb, ref, k, x_perturbed=None):
        return junet.apply(p, x, sigma, emb, ref, training=True, x_perturbed=x_perturbed)

    def get_logvar(p, s):
        return junet.apply(p, s, method=JaxUNet.get_sigma_loss_logvar)

    jstep = jax.jit(jax_module_trainers.make_ddec_train_step(
        ddec_apply, get_logvar, jdae, jdae_vars, _formats()[0], jopt, jbank, jtc, n))
    jstate = jax_init_train_state(jvars, jopt, jbank, jtc.unet.sigma, jax.random.PRNGKey(5))

    tc = DDECTrainConfig()
    tc.unet.grad_accum_steps = accum
    model, dae = _port_ddec(jvars), _port_dae(jdae_vars).requires_grad_(False)
    dae_before = {k: v.clone() for k, v in dae.state_dict().items()}
    opt = build_optimizer("adamw", model.parameters(), lr)
    bank = EMABank([EMAConfig(name=k, std=s) for k, s in EMAS])
    tstep = make_ddec_train_step(_formats()[1], dae, opt, bank, tc, n)
    tstate = init_train_state(model, opt, bank, tc.unet.sigma, torch.Generator())
    assert ddec_sample_shape(_formats()[1], dae, tc, (1, 2, RAW_LEN)) == (1, 32, 56, 2)

    jsampler = JaxSigmaSampler(jtc.unet.sigma)
    rng = np.random.default_rng(8)
    for i in range(2):
        batch = {"audio": np.concatenate([_audio((1, 2, RAW_LEN), 20 + 2 * i + j)
                                          for j in range(n)]),
                 "audio_embeddings": rng.standard_normal((n, EMB_DIM)).astype(np.float32)}
        draws = _jax_ddec_draws(jstate.rng, jsampler, accum, n, (1, 32, 56, 2))
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tlogs = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        for k in ("loss", "grad_norm"):
            assert abs(float(tlogs[k]) - float(jlogs[k])) <= 1e-4 * abs(float(jlogs[k])), (i, k)
        assert _rel_err(tlogs["sample_losses"], jlogs["sample_losses"]) <= 1e-4
    assert tstate.global_step == 2 and tstate.total_samples_processed == 2 * n
    assert all(torch.equal(v, dae_before[k]) for k, v in dae.state_dict().items())

    want_p, got_p, start = _flatten(jstate.params), to_flat(model), _flatten(jvars)
    moved = 0.0
    for name, _ in EMAS:
        want_e = _flatten(jstate.ema_state[name])
        got_e = state_to_flat(tstate.ema_state[name])
        assert sorted(got_e) == sorted(want_e) == sorted(want_p)
        for k in want_p:
            assert np.abs(got_e[k] - want_e[k]).max() <= lr / 20, (name, k)
    for k in want_p:
        assert np.abs(got_p[k] - want_p[k]).max() <= lr / 20, k
        moved = max(moved, float(np.abs(want_p[k] - start[k]).max()))
    assert moved > 6 * lr       # the comparison is not trivially met


# ---------------------------------------------------------------------------
# (c) the validation step with the prepare stage
# ---------------------------------------------------------------------------

def test_ddec_eval_step_matches_jax(monkeypatch):
    """JAX make_unet_eval_step with the DDEC's prepare_fn against the port's
    make_ddec_eval_step: static stratified sigmas, no logvar, JAX's prepare,
    noise and permutation draws replayed (train_state.py:249-265), 1e-5
    relative; and with its own draws the port's loss is finite and repeats
    with the generator's seed."""
    set_trunk_dtype(monkeypatch, "float32")
    jdae, jdae_vars = _jax_dae()
    jvars = _jax_ddec_vars()
    junet = JaxUNet(JaxUNetConfig(**DDEC_KW))
    jtc = JaxDDECTrainConfig()
    prepare = _jax_prepare(jtc, jdae, jdae_vars)
    jtc.unet.crop_edges = 0      # as make_ddec_train_step sets it

    def ddec_apply(p, x, sigma, emb, ref, k, x_perturbed=None):
        return junet.apply(p, x, sigma, emb, ref, training=False)

    jeval = jax_make_eval_step(ddec_apply, lambda p, e, m: None, jtc.unet, prepare_fn=prepare)
    teval = make_ddec_eval_step(_formats()[1], _port_dae(jdae_vars), DDECTrainConfig())
    model = _port_ddec(jvars)
    sampler = JaxSigmaSampler(dataclasses.replace(jtc.unet.sigma, use_static_sigma_sampling=True))
    audio = _audio((1, 2, RAW_LEN), 40)
    key = jax.random.PRNGKey(9)
    want = float(jeval(jvars, {"audio": jnp.asarray(audio)}, key))
    k2, k_prep = jax.random.split(key)
    k_noise, _ = jax.random.split(k2)
    kq, kp = jax.random.split(jax.random.fold_in(k2, 1))
    draws = EvalDraws(noise=_t(jax.random.normal(k_noise, (1, 32, 56, 2))),
                      quantiles=_t(jax.random.permutation(kp, sampler._quantiles(kq, 1))),
                      prepare=_prepare_draws(k_prep))
    got = float(teval(model, {"audio": torch.from_numpy(audio)}, torch.Generator(), draws))
    assert abs(got - want) <= 1e-5 * abs(want)
    own = [float(teval(model, {"audio": torch.from_numpy(audio)},
                       torch.Generator().manual_seed(1))) for _ in range(2)]
    assert np.isfinite(own[0]) and own[0] == own[1]


# ---------------------------------------------------------------------------
# (d) the JAX phase rotation at B = 4
# ---------------------------------------------------------------------------

def test_ddec_prepare_rotates_each_sample_where_jax_raises():
    """JAX raw_to_mdct(random_phase_augmentation=True) lines its (B,) angles
    up with the channel axis, so at B = 4 it raises; the port's DDEC prepare
    runs at B = 4 and equals its four single-sample prepares stacked (to fp32
    rounding: a batched conv sums in another order, 1e-5 of max)."""
    jfmt, tfmt = _formats()
    audio = np.concatenate([_audio((1, 2, RAW_LEN), 50 + i) for i in range(4)])
    with pytest.raises((TypeError, ValueError)):
        jfmt.raw_to_mdct(jnp.asarray(audio), random_phase_augmentation=True,
                         key=jax.random.PRNGKey(0))
    prep = make_ddec_prepare(tfmt, _port_dae(_jax_dae()[1]), DDECTrainConfig())
    rng = np.random.default_rng(6)
    draws = DDECPrepareDraws(torch.tensor([True, False, True, False]),
                             torch.from_numpy(rng.uniform(0, 2 * np.pi, 4).astype(np.float32)))
    with torch.no_grad():
        got = prep({"audio": torch.from_numpy(audio)}, draws)
        for i in range(4):
            one = prep({"audio": torch.from_numpy(audio[i:i + 1])},
                       DDECPrepareDraws(draws.stereo_flip[i:i + 1], draws.phase_theta[i:i + 1]))
            for k in ("samples", "ref_samples"):
                assert _rel_err(got[k][i:i + 1], one[k]) <= 1e-5, (i, k)
    # distinct angles give distinct targets: the rotation is per sample
    assert _rel_err(got["samples"][1], got["samples"][3]) > 1e-2


# ---------------------------------------------------------------------------
# (e) the training entry point, run as a command
# ---------------------------------------------------------------------------

def write_ddec_model(path: Path, seed: int = 0):
    """A tiny model directory: the format, the label-conditioned supersampled
    DAE and the DDEC, seeded, with every gain non-zero."""
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    gen = torch.Generator().manual_seed(seed)
    dcfg, ucfg = DAEConfig(**DAE_KW), UNetConfig(**DDEC_KW)
    fcfg = MSMDCTDualFormatConfig(**FMT_KW)
    dae, ddec = DAE(dcfg).init_weights(gen), UNet(ucfg).init_weights(gen)
    with torch.no_grad():
        ddec.core.out_gain.fill_(1.0)      # a zero out_gain stops every other gradient
    Pipeline({"format": ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                     MSMDCTDualFormat(fcfg)),
              "dae": ModuleHandle("dae", "dae", dcfg, dae),
              "ddec": ModuleHandle("ddec", "ddec", ucfg, ddec)}).save_pretrained(path)


def test_ddec_train_entry_runs_and_resumes_on_cpu(tmp_path):
    """``python -m dualdiffusion_tpu_torch.train --device cpu`` with the "ddec"
    module trainer on synthetic WAVs with embedding files (the b1a config
    loads ``audio_embeddings``): 2 steps, then ``--resume`` to step 3. The
    checkpoints hold the DDEC and both EMAs, not the teacher DAE; the EMA
    archive is written at its step; the resumed run continues the EMA (the
    lerp of the step-2 profile toward the step-3 weights); the model
    directory's DAE is unchanged and the checkpoint loads with
    ``from_pretrained``."""
    from dualdiffusion_tpu_torch import train
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    from dualdiffusion_tpu_torch.pipelines import Pipeline
    from dualdiffusion_tpu_torch.training.ema import power_function_beta
    from dualdiffusion_tpu_torch.utils import load_safetensors

    write_ddec_model(tmp_path / "m")
    dae_root = load_safetensors(tmp_path / "m" / "dae" / "dae.safetensors")
    write_audio_dataset(tmp_path / "d", 8, 2, RAW_LEN + 500, seed=1, emb_dim=EMB_DIM)
    (tmp_path / "tc.json").write_text(json.dumps({
        "module_name": "ddec", "module_trainer": "ddec",
        "device_batch_size": 2, "gradient_accumulation_steps": 2, "checkpoints_total_limit": 2,
        "lr_schedule": {"lr_warmup_steps": 0},
        "dataloader": {"load_datatypes": ["audio", "audio_embeddings"],
                       "raw_crop_width": RAW_LEN},
        "emas": {"std0.05": {"std": 0.05, "num_archive_steps": 2},
                 "std0.1": {"std": 0.1}}}))
    args = ["--device", "cpu", "--model_path", str(tmp_path / "m"),
            "--train_config_path", str(tmp_path / "tc.json"), "--dataset_path", str(tmp_path / "d")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.train", *args,
                           "--max_steps", "2"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dataset: 8 samples" in proc.stderr
    losses = [float(line.split(" loss ")[1].split()[0]) for line in proc.stderr.splitlines()
              if " loss " in line]
    resumed = train.main(args + ["--resume", "--max_steps", "3"])
    assert [h["step"] for h in resumed.history] == [3] and resumed.state.global_step == 3
    losses += [h["loss"] for h in resumed.history]
    assert len(losses) == 3 and np.all(np.isfinite(losses))

    m = tmp_path / "m"
    ck2, ck3 = m / "ddec_checkpoint-2", m / "ddec_checkpoint-3"
    assert sorted(p.name for p in ck3.iterdir() if p.is_dir()) == ["ddec", "src_snapshot"]
    assert (m / "ddec_ema_archive" / "2_ema_std0.05.safetensors").is_file()
    ts = torch.load(ck3 / "train_state.pt")
    assert ts["global_step"] == 3 and ts["total_samples_processed"] == 12
    beta = power_function_beta(0.05, 8 + 4, 4)
    e2 = load_safetensors(ck2 / "ddec" / "ema_std0.05.safetensors")
    e3 = load_safetensors(ck3 / "ddec" / "ema_std0.05.safetensors")
    p3 = load_safetensors(ck3 / "ddec" / "ddec.safetensors")
    assert set(e3) == set(p3)
    for k in e3:
        assert np.allclose(e3[k], e2[k] * np.float32(beta) + p3[k] * np.float32(1 - beta),
                           rtol=1e-6, atol=1e-7), k
    dae_after = load_safetensors(m / "dae" / "dae.safetensors")
    assert all(np.array_equal(dae_after[k], v) for k, v in dae_root.items())
    pipe = Pipeline.from_pretrained(m, device="cpu", load_checkpoints={"ddec": "latest"})
    got = to_flat(pipe.modules["ddec"].module)
    assert all(np.array_equal(got[k], p3[k]) for k in p3)
