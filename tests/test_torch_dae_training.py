"""The port's DAE training slice against the JAX package on the CPU: the
MDCT, the MS-MDCT dual format, DAE encode and its training forward, one
whole DAE train step (fused MSS2D, phase invariance, KL, AdamW, EMA of the
params and the latent stats), plus the port's training entry run as a
command with the "dae" module trainer on a synthetic WAV dataset.

<-> dualdiffusion_tpu/ops/mdct.py, dualdiffusion_tpu/models/formats/
ms_mdct_dual.py, dualdiffusion_tpu/models/dae.py and dualdiffusion_tpu/
training/module_trainers.py make_dae_train_step.
"""

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

from dualdiffusion_tpu.dataset.dataloader import DatasetConfig as JaxDatasetConfig
from dualdiffusion_tpu.dataset.dataloader import DualDiffusionDataset as JaxDataset
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats.ms_mdct_dual import MSMDCTDualFormat as JaxDualFormat
from dualdiffusion_tpu.models.formats.ms_mdct_dual import (
    MSMDCTDualFormatConfig as JaxDualFormatConfig)
from dualdiffusion_tpu.ops.mdct import imdct as jax_imdct
from dualdiffusion_tpu.ops.mdct import mdct as jax_mdct
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import losses as jlosses
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.module_trainers import DAETrainConfig as JaxDAETrainConfig
from dualdiffusion_tpu.training.module_trainers import make_dae_train_step as jax_make_dae_step
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu_torch.dataset import DatasetConfig, DualDiffusionDataset
from dualdiffusion_tpu_torch.models import DAE, DAEConfig
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.ops import imdct, mdct
from dualdiffusion_tpu_torch.training import (DAEMicroDraws, DAETrainConfig, EMABank, EMAConfig,
                                              SigmaSamplerConfig, build_optimizer,
                                              init_train_state, make_dae_train_step)
from dualdiffusion_tpu_torch.training.losses import MSSLoss2DConfig
from dualdiffusion_tpu_torch.weights import load_flat, state_to_flat, to_flat

ROOT = Path(__file__).resolve().parents[1]
DAE_KW = dict(model_channels=8, channel_mult_enc=(1, 2), channel_mult_dec=(1, 2),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=4,
              compute_dtype="float32")
FMT_KW = dict(ms_num_filters=64)
RAW_LEN = 12288        # -> a 64 x 49 mel; cropped by 4 and cut to the ratio 2: 64 x 40


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
    """Sinusoids plus noise, so the spectra have structure."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 32000
    sig = sum(np.sin(2 * np.pi * f * t + p) for f, p in
              zip(rng.uniform(100, 3000, 4), rng.uniform(0, 6, 4)))
    return (0.1 * sig + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _formats():
    return (JaxDualFormat(JaxDualFormatConfig(**FMT_KW)),
            MSMDCTDualFormat(MSMDCTDualFormatConfig(**FMT_KW)))


@functools.lru_cache(maxsize=None)
def _jax_dae_vars():
    """The tiny DAE's variables, shaped by JAX's init and drawn with numpy
    (tracing the init is much faster than compiling it): unit-normal
    weights, small biases, gains near 1, a logvar near 0 and stats away
    from their initial values, so a copy error would show."""
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    shapes = jax.eval_shape(jdae.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 40, 2)))
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if path[0].key == "stats" or name == "out_gain":
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "recon_loss_logvar":
            a = rng.uniform(-0.3, 0.3, leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) * (0.3 if name == "bias" else 1.0)
        return jnp.asarray(a, leaf.dtype)
    return jdae, jax.tree_util.tree_map_with_path(draw, shapes)


def _port_dae(jvars) -> DAE:
    model = DAE(DAEConfig(**DAE_KW))
    load_flat(model, _flatten(jvars))
    return model


# ---------------------------------------------------------------------------
# MDCT and the dual format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window_fn", ["sin_mdct", "kbd_mdct", "vorbis"])
def test_mdct_and_imdct_match_jax(window_fn):
    """MDCT (real and complex) and IMDCT against JAX's HIGHEST-precision
    products on the same float64-built bases: fp32 rounding, 1e-5 of max.
    The inverse of the forward gives back the signal."""
    x = _audio((2, 2, 3000), 2)
    wre, wim = jax_mdct(jnp.asarray(x), 512, window_fn=window_fn, return_complex=True)
    gre, gim = mdct(torch.from_numpy(x), 512, window_fn=window_fn, return_complex=True)
    assert _rel_err(gre, wre) <= 1e-5 and _rel_err(gim, wim) <= 1e-5
    assert torch.equal(mdct(torch.from_numpy(x), 512, window_fn=window_fn), gre)
    want = jax_imdct(wre, 512, window_fn=window_fn)
    got = imdct(gre, 512, window_fn=window_fn)
    assert _rel_err(got, want) <= 1e-5
    if window_fn != "kbd_mdct":      # Princen-Bradley windows reconstruct
        assert _rel_err(got[..., :3000], x) <= 1e-4


def test_dual_format_matches_jax():
    """raw_to_mel_spec, raw_to_mdct (with and without a phase rotation),
    mdct_to_raw and mel_spec_to_linear, and the shape math. The 4096-point
    STFTs sum in another order in torch than in JAX, and the mel takes a
    fourth root, which magnifies relative error where the blend is small:
    1e-4 of max for the mel and the linear PSD; the MDCT path is fp32
    products, 1e-5 of max. One sample per rotation: the JAX rotation lines
    its angles up with the channel axis (theta[:, None, None] against (B, C,
    N, frames)), so it rotates per sample only at B = 1."""
    jfmt, tfmt = _formats()
    x = _audio((2, 2, RAW_LEN), 3)
    key = jax.random.PRNGKey(4)
    theta = jax.random.uniform(key, (1,)) * 2 * jnp.pi

    @jax.jit
    def jax_views(a):
        rot = jfmt.raw_to_mdct(a[:1], random_phase_augmentation=True, key=key)
        mel = jfmt.raw_to_mel_spec(a)
        return (mel, jfmt.raw_to_mdct(a), rot, jfmt.mdct_to_raw(rot),
                jfmt.mel_spec_to_linear(mel))

    mel, plain, rot, raw, lin = jax_views(jnp.asarray(x))
    tx = torch.from_numpy(x)
    assert _rel_err(tfmt.raw_to_mel_spec(tx), mel) <= 1e-4
    assert _rel_err(tfmt.raw_to_mdct(tx), plain) <= 1e-5
    got = tfmt.raw_to_mdct(tx[:1], _t(theta))
    assert _rel_err(got, rot) <= 1e-5
    assert _rel_err(tfmt.mdct_to_raw(got), raw) <= 1e-5
    assert _rel_err(tfmt.mel_spec_to_linear(_t(mel)), lin) <= 1e-4
    for n in (RAW_LEN, 176128, None):
        assert tfmt.get_mel_spec_shape(2, n) == jfmt.get_mel_spec_shape(2, n)
        assert tfmt.get_mdct_shape(2, n) == jfmt.get_mdct_shape(2, n)
        assert tfmt.get_raw_crop_width(n) == jfmt.get_raw_crop_width(n)


def test_dual_format_rotation_is_per_sample():
    """The port rotates each sample's MDCT phases by its own angle at any
    batch (the train step's micro-batches are B > 1): a batch of 4 equals
    the 4 single-sample rotations stacked, and each single-sample rotation
    is held against JAX above."""
    _, tfmt = _formats()
    x = torch.from_numpy(_audio((4, 2, RAW_LEN), 5))
    theta = torch.from_numpy(np.random.default_rng(6).uniform(0, 2 * np.pi, 4).astype(np.float32))
    got = tfmt.raw_to_mdct(x, theta)
    want = torch.cat([tfmt.raw_to_mdct(x[i:i + 1], theta[i:i + 1]) for i in range(4)])
    assert _rel_err(got, want) <= 1e-6
    assert _rel_err(got[1:], tfmt.raw_to_mdct(x[1:], theta[:1].expand(3))) > 1e-2


# ---------------------------------------------------------------------------
# DAE encode and training forward
# ---------------------------------------------------------------------------

def test_dae_encode_and_training_forward_match_jax():
    """fp32 trunk, JAX-initialised weights carried over: encode, the
    training forward's (latents, recon, pre_norm) and the moved stats
    buffers to fp32 rounding (1e-5 of max; stats 1e-5 relative); an
    inference encode leaves the stats alone; normalize_latents agrees."""
    jdae, jvars = _jax_dae_vars()
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 64, 40, 2)).astype(np.float32)
    model = _port_dae(jvars)
    want_lat, ((lat, recon, pre), new_vars) = jax.jit(lambda v, x: (
        jdae.apply(v, x, method=JaxDAE.encode),
        jdae.apply(v, x, training=True, mutable=["stats"])))(jvars, jnp.asarray(mel))
    assert _rel_err(model.encode(torch.from_numpy(mel)).detach(), want_lat) <= 1e-5
    assert _rel_err(to_flat(model)["stats/latents_var"], _flatten(jvars)["stats/latents_var"]) == 0
    got = model(torch.from_numpy(mel), training=True)
    for g, w in zip(got, (lat, recon, pre)):
        assert _rel_err(g.detach(), w) <= 1e-5
    got_flat, want_flat = to_flat(model), _flatten({"stats": new_vars["stats"]})
    for k, w in want_flat.items():
        assert np.all(np.abs(got_flat[k] - w) <= 1e-5 * np.abs(w)), k
    z = rng.standard_normal((2, 32, 20, 4)).astype(np.float32)
    want = jdae.apply({"params": jvars["params"], "stats": new_vars["stats"]}, jnp.asarray(z),
                      method=JaxDAE.normalize_latents)
    assert _rel_err(model.normalize_latents(torch.from_numpy(z)), want) <= 1e-5


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------

def _jax_dae_draws(rng_key, accum, micro_b):
    """The draws of one JAX DAE step, from its key splits
    (module_trainers.py:48, 175, 245-246, 295-302; ms_mdct_dual.py:266)."""
    _, step_key = jax.random.split(rng_key)
    draws = []
    for k in jax.random.split(step_key, accum):
        k_st, k_ph, _ = jax.random.split(k, 3)
        flip = jax.random.bernoulli(k_st, 0.5, (micro_b,))
        theta = jax.random.uniform(jax.random.fold_in(k_ph, 7), (micro_b,)) * 2 * jnp.pi
        draws.append(DAEMicroDraws(torch.from_numpy(np.array(flip)), _t(theta)))
    return draws


def test_dae_train_step_matches_jax():
    """Two steps of the tiny DAE, fp32 trunk, gradient accumulation 2 of one
    sample each (the JAX phase rotation is per sample only at B = 1), the
    fused MSS2D (widths 8/16 unfold, 32 through the kernel's path),
    stereo flips, phase invariance, point loss, KL and their warm-ups, one
    power-function EMA, the port fed the draws of JAX's key splits: loss and
    grad norm to 1e-4 relative, params and EMA to lr/20 absolute (AdamW's
    first updates are about +-lr per element whatever the gradient's size),
    the stats buffers and their EMA to 1e-5 relative."""
    jfmt, tfmt = _formats()
    jdae, jvars = _jax_dae_vars()
    lr, n, accum = 1e-3, 2, 2
    kw = dict(use_fused_mss2d=True, grad_accum_steps=accum, kl_warmup_steps=4,
              latents_regularization_warmup_steps=4, point_loss_warmup_steps=4,
              latents_dispersion_loss_weight=0.5)
    jtc = JaxDAETrainConfig(mss2d=jlosses.MSSLoss2DConfig(block_widths=(8, 16, 32)), **kw)
    jopt = joptim.build_optimizer("adamw", lr)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])
    jstep = jax.jit(jax_make_dae_step(jdae, jfmt, jopt, jbank, jtc, n))
    jstate = jax_init_train_state(jvars, jopt, jbank, JaxSigmaConfig(), jax.random.PRNGKey(3))

    model = _port_dae(jvars)
    opt = build_optimizer("adamw", model.parameters(), lr)
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    tstep = make_dae_train_step(tfmt, opt, bank,
                                DAETrainConfig(mss2d=MSSLoss2DConfig(block_widths=(8, 16, 32)),
                                               **kw), n)
    tstate = init_train_state(model, opt, bank, SigmaSamplerConfig(), torch.Generator())
    start = _flatten(jvars)
    for i in range(2):
        audio = _audio((n, 2, RAW_LEN), 10 + i) * np.array([[[1.0], [0.6]]], np.float32)
        draws = _jax_dae_draws(jstate.rng, accum, n // accum)
        jstate, jlogs = jstep(jstate, {"audio": jnp.asarray(audio)})
        tlogs = tstep(tstate, {"audio": torch.from_numpy(audio)}, draws)
        for k in ("loss", "grad_norm"):
            assert abs(float(tlogs[k]) - float(jlogs[k])) <= 1e-4 * abs(float(jlogs[k])), (i, k)
        assert _rel_err(tlogs["sample_losses"], jlogs["sample_losses"]) <= 1e-4
    assert tstate.global_step == 2 and tstate.total_samples_processed == 2 * n

    want_p, got_p = _flatten(jstate.params), to_flat(model)
    want_e = _flatten(jstate.ema_state["std0.05"])
    got_e = state_to_flat(tstate.ema_state["std0.05"])
    assert sorted(got_e) == sorted(want_e) == sorted(want_p)
    moved = 0.0
    for k in want_p:
        for got, want in ((got_p[k], want_p[k]), (got_e[k], want_e[k])):
            if k.startswith("stats/"):
                assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), k
            else:
                assert np.abs(got - want).max() <= lr / 20, k
        moved = max(moved, float(np.abs(want_p[k] - start[k]).max()))
    assert moved > 6 * lr       # the comparison is not trivially met


def test_unported_dae_options_raise():
    """Every option of the JAX DAE trainer builds a step (the MDCT domain,
    the randomized-prime and prime-width 1-D MSS, the equivariance loss);
    the fused MSS2D refuses the "cat" mid/side (JAX asserts) and an unknown
    domain refuses to build; the TPU-only W-packing of the DAE refuses to
    build the model."""
    fmt = _formats()[1]
    opt = build_optimizer("adamw", [torch.nn.Parameter(torch.zeros(2))], 1e-3)
    for kw in (dict(domain="mdct"), dict(use_random_prime_mss=True),
               dict(mss1d_prime_loss_weight=1.0), dict(equivariance_loss_weight=1.0)):
        assert callable(make_dae_train_step(fmt, opt, None, DAETrainConfig(**kw), 2))
    for kw in (dict(domain="raw"),
               dict(use_fused_mss2d=True, mss2d=MSSLoss2DConfig(use_midside_transform="cat"))):
        with pytest.raises(ValueError):
            make_dae_train_step(fmt, opt, None, DAETrainConfig(**kw), 2)
    with pytest.raises(NotImplementedError):
        DAE(DAEConfig(**DAE_KW, w_pack_channels=64))


def test_audio_dataloader_matches_jax(tmp_path):
    """The "audio" datatype on a synthetic WAV dataset: the same records kept
    and filtered (one too short for the crop, one at another sample rate),
    the same shuffled batches and the same random crops, bit for bit."""
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    write_audio_dataset(tmp_path, 6, 2, 5000, seed=2)
    lines = (tmp_path / "train.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    recs[1]["sample_length"] = 3000
    recs[2]["sample_rate"] = 44100
    (tmp_path / "train.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    kw = dict(data_dir=str(tmp_path), load_datatypes=("audio",), raw_crop_width=4096)
    jds = JaxDataset(JaxDatasetConfig(**kw), rng=np.random.default_rng(0))
    tds = DualDiffusionDataset(DatasetConfig(**kw), rng=np.random.default_rng(0))
    assert len(tds) == len(jds) == 4
    got = list(tds.iter_batches("train", 2, seed=1, prefetch=0))
    want = list(jds.iter_batches("train", 2, seed=1, prefetch=0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"] and g["audio"].shape == (2, 2, 4096)
        assert np.array_equal(g["audio"], w["audio"])


# ---------------------------------------------------------------------------
# the training entry point, run as a command
# ---------------------------------------------------------------------------

def test_dae_train_entry_runs_and_resumes_on_cpu(tmp_path):
    """``python -m dualdiffusion_tpu_torch.train --device cpu`` with the "dae"
    module trainer (fused MSS2D) on a synthetic WAV dataset: 2 steps, then
    the same entry with ``--resume`` to step 3. The checkpoint holds the DAE with its moved
    stats buffers, the EMA of params and stats, and the train state; the
    resumed run continues the step counter and the EMA (exactly the lerp of
    the step-2 profile toward the step-3 weights and stats)."""
    from dualdiffusion_tpu_torch import train
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.training.ema import power_function_beta
    from dualdiffusion_tpu_torch.utils import load_safetensors

    dcfg, fcfg = DAEConfig(**DAE_KW), MSMDCTDualFormatConfig(**FMT_KW)
    dae = DAE(dcfg).init_weights(torch.Generator().manual_seed(0))
    Pipeline({"dae": ModuleHandle("dae", "dae", dcfg, dae),
              "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                     MSMDCTDualFormat(fcfg))}).save_pretrained(tmp_path / "m")
    write_audio_dataset(tmp_path / "d", 8, 2, RAW_LEN + 500, seed=1)
    (tmp_path / "tc.json").write_text(json.dumps({
        "module_name": "dae", "module_trainer": "dae",
        "module_trainer_config": {"use_fused_mss2d": True,
                                  "mss2d": {"block_widths": [8, 16, 32]}},
        "device_batch_size": 2, "gradient_accumulation_steps": 2, "checkpoints_total_limit": 2,
        "lr_schedule": {"lr_warmup_steps": 0},
        "dataloader": {"use_pre_encoded_latents": False, "load_datatypes": ["audio"],
                       "raw_crop_width": RAW_LEN},
        "emas": {"std0.05": {"std": 0.05}}}))
    args = ["--device", "cpu", "--model_path", str(tmp_path / "m"),
            "--train_config_path", str(tmp_path / "tc.json"), "--dataset_path", str(tmp_path / "d")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.train", *args,
                           "--max_steps", "2"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [float(line.split(" loss ")[1].split()[0]) for line in proc.stderr.splitlines()
              if " loss " in line]
    # the resumed leg in this process (the same entry, without a second start-up)
    resumed = train.main(args + ["--resume", "--max_steps", "3"])
    assert [h["step"] for h in resumed.history] == [3] and resumed.state.global_step == 3
    losses += [h["loss"] for h in resumed.history]
    assert len(losses) == 3 and np.all(np.isfinite(losses))

    ck2, ck3 = tmp_path / "m" / "dae_checkpoint-2", tmp_path / "m" / "dae_checkpoint-3"
    ts = torch.load(ck3 / "train_state.pt")
    assert ts["global_step"] == 3 and ts["total_samples_processed"] == 12
    beta = power_function_beta(0.05, 8 + 4, 4)
    e2 = load_safetensors(ck2 / "dae" / "ema_std0.05.safetensors")
    e3 = load_safetensors(ck3 / "dae" / "ema_std0.05.safetensors")
    p2 = load_safetensors(ck2 / "dae" / "dae.safetensors")
    p3 = load_safetensors(ck3 / "dae" / "dae.safetensors")
    assert set(e3) == set(p3) and "stats/latents_var" in p3
    assert not np.array_equal(p2["stats/latents_var"], p3["stats/latents_var"])
    for k in e3:
        assert np.allclose(e3[k], e2[k] * np.float32(beta) + p3[k] * np.float32(1 - beta),
                           rtol=1e-6, atol=1e-7), k
