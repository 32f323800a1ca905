"""The port's joint DAE + DDEC trainer and the supersampled, label-conditioned
DAE against the JAX package on the CPU: two joint train steps, the joint
trainer's training entry run as a command (both modules exported, resumed
and loaded), the d3-series DAE's encode, decode and training forward with a
label embedding and injected latent noise, a DAE train step with audio
embeddings, a JAX-written DAE without label-conditioning weights, and every
model directory of ``configs/models`` built by the port's
``create_new_model`` and loaded by ``from_pretrained``.

Tiny models, fp32 trunks, JAX-initialised weights carried over, JAX's key
splits replayed as explicit draws (module_trainers.py:428, :378, ``fold_in(key,
3)`` at :411; :175, :245-246, :295-302).

<-> dualdiffusion_tpu/training/module_trainers.py
make_joint_dae_ddec_train_step and make_dae_train_step,
dualdiffusion_tpu/models/dae.py and create_new_model.py.
"""

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

import create_new_model as jax_cnm
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.unet import UNet as JaxUNet
from dualdiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from dualdiffusion_tpu.pipelines.pipeline import _flatten
from dualdiffusion_tpu.pipelines.pipeline import get_module_class as jax_module_class
from dualdiffusion_tpu.training import ema as jema
from dualdiffusion_tpu.training import losses as jlosses
from dualdiffusion_tpu.training import optim as joptim
from dualdiffusion_tpu.training.module_trainers import DAETrainConfig as JaxDAETrainConfig
from dualdiffusion_tpu.training.module_trainers import JointDAEDDECConfig as JaxJointConfig
from dualdiffusion_tpu.training.module_trainers import make_dae_train_step as jax_make_dae_step
from dualdiffusion_tpu.training.module_trainers import (
    make_joint_dae_ddec_train_step as jax_make_joint_step)
from dualdiffusion_tpu.training.sigma_sampler import SigmaSampler as JaxSigmaSampler
from dualdiffusion_tpu.training.sigma_sampler import SigmaSamplerConfig as JaxSigmaConfig
from dualdiffusion_tpu.training.train_state import init_train_state as jax_init_train_state
from dualdiffusion_tpu.utils import config_from_dict as jax_config_from_dict
from dualdiffusion_tpu_torch import create_new_model as cnm
from dualdiffusion_tpu_torch.models import DAE, DAEConfig
from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline, get_module_class
from dualdiffusion_tpu_torch.training import (DAEMicroDraws, DAETrainConfig, EMABank, EMAConfig,
                                              JointDAEDDECConfig, JointMicroDraws,
                                              JointStepDraws, SigmaSamplerConfig,
                                              build_optimizer, init_train_state,
                                              make_dae_train_step,
                                              make_joint_dae_ddec_train_step)
from dualdiffusion_tpu_torch.training.losses import MSSLoss2DConfig
from dualdiffusion_tpu_torch.utils import config_from_dict, load_json, load_safetensors
from dualdiffusion_tpu_torch.weights import flax_key, load_flat, state_to_flat, to_flat
from test_torch_create_new_model import _flatten_shapes
from test_torch_ddec import DDEC_KW, _jax_ddec_vars
from test_torch_ddec_training import (DAE_KW, EMB_DIM, RAW_LEN, _audio, _formats, _jax_dae,
                                      _port_dae, _port_ddec, _rel_err, _t, write_ddec_model)
from test_torch_training import set_trunk_dtype

ROOT = Path(__file__).resolve().parents[1]
MSS_WIDTHS = (8, 16, 32)   # a 32 x 64 mel holds no 64-wide reflect-padded block


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _stats_close(got, want, rel):
    return np.all(np.abs(np.asarray(got) - np.asarray(want)) <= rel * np.abs(np.asarray(want)))


# ---------------------------------------------------------------------------
# (f) two joint steps
# ---------------------------------------------------------------------------

def _jax_joint_draws(rng_key, sampler, accum, n, noise_shape):
    """The draws of one JAX joint step (module_trainers.py:428, :441, :378;
    fold_in(key, 3) at :411; :48; ms_mdct_dual.py:266)."""
    _, step_key, sigma_key = jax.random.split(rng_key, 3)
    kq, kp = jax.random.split(sigma_key)
    q = jax.random.permutation(kp, sampler._quantiles(kq, n))
    micro = []
    for k in jax.random.split(step_key, accum):
        k_st, k_ph, _ = jax.random.split(k, 3)
        b = noise_shape[0]
        micro.append(JointMicroDraws(
            torch.from_numpy(np.array(jax.random.bernoulli(k_st, 0.5, (b,)))),
            _t(jax.random.uniform(k_ph, (b,)) * 2 * jnp.pi),
            _t(jax.random.normal(jax.random.fold_in(k, 3), noise_shape))))
    return JointStepDraws(_t(q), micro)


def test_joint_train_step_matches_jax(monkeypatch):
    """Two joint steps of the tiny DAE and DDEC, fp32 trunks, gradient
    accumulation 2 of one sample each, one optimizer and clip over both, the
    unfolded MSS2D and the KL (warm-up 4 steps), the DDEC conditioned on the
    live reconstruction, two power-function EMAs over both modules and the
    DAE's stats, JAX's draws replayed: loss, its two parts and the grad norm
    to 1e-4 relative; both modules' params and EMAs to lr/20 absolute; the
    DAE's stats buffers and their EMAs to 1e-5 relative."""
    set_trunk_dtype(monkeypatch, "float32")
    jfmt, tfmt = _formats()
    jdae, jdae_vars = _jax_dae()
    jddec_vars = _jax_ddec_vars()
    junet = JaxUNet(JaxUNetConfig(**DDEC_KW))
    lr, n, accum = 1e-3, 2, 2
    emas = (("std0.05", 0.05), ("std0.1", 0.1))
    jcfg = JaxJointConfig(dae=JaxDAETrainConfig(
        kl_warmup_steps=4, mss2d=jlosses.MSSLoss2DConfig(block_widths=MSS_WIDTHS)),
        ddec_loss_weight=0.5, grad_accum_steps=accum)
    jopt = joptim.build_optimizer("adamw", lr)
    jbank = jema.EMABank([jema.EMAConfig(name=k, std=s) for k, s in emas])

    def ddec_apply(p, x, sigma, emb, ref, k, x_perturbed=None):
        return junet.apply(p, x, sigma, emb, ref, training=True)

    def get_logvar(p, s):
        return junet.apply(p, s, method=JaxUNet.get_sigma_loss_logvar)

    jstep = jax.jit(jax_make_joint_step(jdae, ddec_apply, get_logvar, jfmt, jopt, jbank, jcfg, n))
    jparams = {"dae": jdae_vars, "ddec": jddec_vars}
    jstate = jax_init_train_state(jparams, jopt, jbank, jcfg.ddec.unet.sigma,
                                  jax.random.PRNGKey(7),
                                  trainable={"dae": jdae_vars["params"], "ddec": jddec_vars})

    tcfg = JointDAEDDECConfig(dae=DAETrainConfig(
        kl_warmup_steps=4, mss2d=MSSLoss2DConfig(block_widths=MSS_WIDTHS)),
        ddec_loss_weight=0.5, grad_accum_steps=accum)
    module = torch.nn.ModuleDict({"dae": _port_dae(jdae_vars), "ddec": _port_ddec(jddec_vars)})
    opt = build_optimizer("adamw", module.parameters(), lr)
    bank = EMABank([EMAConfig(name=k, std=s) for k, s in emas])
    tstep = make_joint_dae_ddec_train_step(tfmt, opt, bank, tcfg, n)
    tstate = init_train_state(module, opt, bank, tcfg.ddec.unet.sigma, torch.Generator())

    jsampler = JaxSigmaSampler(jcfg.ddec.unet.sigma)
    for i in range(2):
        audio = np.concatenate([_audio((1, 2, RAW_LEN), 60 + 2 * i + j) for j in range(n)])
        draws = _jax_joint_draws(jstate.rng, jsampler, accum, n, (1, 32, 56, 2))
        jstate, jlogs = jstep(jstate, {"audio": jnp.asarray(audio)})
        tlogs = tstep(tstate, {"audio": torch.from_numpy(audio)}, draws)
        for k in ("loss", "grad_norm", "loss_dae", "loss_ddec"):
            assert abs(float(tlogs[k]) - float(jlogs[k])) <= 1e-4 * abs(float(jlogs[k])), (i, k)
    assert tstate.global_step == 2 and tstate.total_samples_processed == 2 * n

    moved = 0.0
    for name in ("dae", "ddec"):
        want_p = _flatten(jstate.params[name])
        start = _flatten(jparams[name])
        got_p = to_flat(module[name])
        profiles = [(_flatten(jstate.ema_state[e][name]),
                     state_to_flat({k[len(name) + 1:]: v for k, v in tstate.ema_state[e].items()
                                    if k.startswith(name + ".")})) for e, _ in emas]
        assert sorted(got_p) == sorted(want_p)
        for k in want_p:
            for got, want in [(got_p[k], want_p[k])] + [(g[k], w[k]) for w, g in profiles]:
                if k.startswith("stats/"):
                    assert _stats_close(got, want, 1e-5), (name, k)
                else:
                    assert np.abs(got - want).max() <= lr / 20, (name, k)
            if not k.startswith("stats/"):
                moved = max(moved, float(np.abs(want_p[k] - start[k]).max()))
        if name == "dae":
            assert not np.allclose(want_p["stats/latents_var"], start["stats/latents_var"])
    assert moved > 6 * lr       # the comparison is not trivially met


# ---------------------------------------------------------------------------
# (g) the joint trainer through the training entry
# ---------------------------------------------------------------------------

def test_joint_train_entry_exports_resumes_and_loads_both_modules(tmp_path):
    """``python -m dualdiffusion_tpu_torch.train --device cpu`` with
    ``"module_trainer": "dae_ddec"``: 2 steps, then ``--resume`` to step 3.
    The checkpoint holds both modules, each with its EMA; each module's EMA
    archive is written; the resume restores both (the resumed EMA is the
    lerp of the step-2 profile toward the step-3 weights and stats); the DAE's
    stats moved; ``from_pretrained`` loads the trained DAE and DDEC from the
    checkpoint."""
    from dualdiffusion_tpu_torch import train
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    from dualdiffusion_tpu_torch.training.ema import power_function_beta

    m = tmp_path / "m"
    write_ddec_model(m, seed=3)
    write_audio_dataset(tmp_path / "d", 8, 2, RAW_LEN + 500, seed=2)
    (tmp_path / "tc.json").write_text(json.dumps({
        "module_name": "ddec", "module_trainer": "dae_ddec",
        "module_trainer_config": {"dae": {"kl_warmup_steps": 2,
                                          "mss2d": {"block_widths": list(MSS_WIDTHS)}},
                                  "ddec": {"crop_edges": 4}},
        "device_batch_size": 2, "gradient_accumulation_steps": 2, "checkpoints_total_limit": 2,
        "lr_schedule": {"lr_warmup_steps": 0},
        "dataloader": {"load_datatypes": ["audio"], "raw_crop_width": RAW_LEN},
        "emas": {"std0.05": {"std": 0.05, "num_archive_steps": 2}}}))
    args = ["--device", "cpu", "--model_path", str(m), "--train_config_path",
            str(tmp_path / "tc.json"), "--dataset_path", str(tmp_path / "d")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.train", *args,
                           "--max_steps", "2"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    resumed = train.main(args + ["--resume", "--max_steps", "3"])
    assert resumed.state.global_step == 3 and np.isfinite(resumed.history[-1]["loss"])

    ck2, ck3 = m / "ddec_checkpoint-2", m / "ddec_checkpoint-3"
    assert sorted(p.name for p in ck3.iterdir() if p.is_dir()) == ["dae", "ddec", "src_snapshot"]
    beta = power_function_beta(0.05, 8 + 4, 4)
    for name in ("dae", "ddec"):
        assert (m / f"{name}_ema_archive" / "2_ema_std0.05.safetensors").is_file()
        e2 = load_safetensors(ck2 / name / "ema_std0.05.safetensors")
        e3 = load_safetensors(ck3 / name / "ema_std0.05.safetensors")
        p3 = load_safetensors(ck3 / name / f"{name}.safetensors")
        assert set(e3) == set(p3)
        for k in e3:
            assert np.allclose(e3[k], e2[k] * np.float32(beta) + p3[k] * np.float32(1 - beta),
                               rtol=1e-6, atol=1e-7), (name, k)
    root_dae = load_safetensors(m / "dae" / "dae.safetensors")
    p3 = load_safetensors(ck3 / "dae" / "dae.safetensors")
    assert not np.array_equal(p3["stats/latents_var"], root_dae["stats/latents_var"])
    assert not np.array_equal(p3["params/conv_in/w_mp"], root_dae["params/conv_in/w_mp"])

    pipe = Pipeline.from_pretrained(m, device="cpu",
                                    load_checkpoints={"dae": ck3.name, "ddec": "latest"})
    for name in ("dae", "ddec"):
        got = to_flat(pipe.modules[name].module)
        want = to_flat(resumed.state.module[name])
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), name
    with pytest.raises(ValueError):
        Pipeline.from_pretrained(m, device="cpu", load_checkpoints={"dae": "format_checkpoint-3"})


# ---------------------------------------------------------------------------
# (h) the supersampled, label-conditioned DAE
# ---------------------------------------------------------------------------

def test_supersampled_label_conditioned_dae_matches_jax():
    """fp32: the label embedding, encode (the full-resolution encoder, the
    pool after the projection), decode, and the training forward with the
    embedding and injected latent noise (JAX's draw replayed), with the
    moved stats buffers: 1e-5 relative. An encode without the embedding
    differs from one with it."""
    jdae, jvars = _jax_dae()
    model = _port_dae(jvars)
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 32, 56, 2)).astype(np.float32)
    emb_in = rng.standard_normal((2, EMB_DIM)).astype(np.float32)
    sigma, key = jnp.float32(0.3), jax.random.PRNGKey(11)

    @jax.jit
    def jax_views(v, x, e):
        emb = jdae.apply(v, e, method=JaxDAE.get_embeddings)
        lat = jdae.apply(v, x, emb, method=JaxDAE.encode)
        rec = jdae.apply(v, lat, emb, method=JaxDAE.decode)
        fwd, new = jdae.apply(v, x, emb, sigma, key, training=True, mutable=["stats"])
        return emb, lat, rec, fwd, new["stats"]

    j_emb, j_lat, j_rec, j_fwd, j_stats = jax_views(jvars, jnp.asarray(mel), jnp.asarray(emb_in))
    noise = _t(jax.random.normal(key, j_lat.shape))
    with torch.no_grad():
        emb = model.get_embeddings(torch.from_numpy(emb_in))
        assert _rel_err(emb, j_emb) <= 1e-5
        lat = model.encode(torch.from_numpy(mel), emb)
        assert lat.shape == (2, 16, 28, 4) and _rel_err(lat, j_lat) <= 1e-5
        assert _rel_err(model.decode(lat, emb), j_rec) <= 1e-5
        assert _rel_err(model.encode(torch.from_numpy(mel)), j_lat) > 1e-3
        fwd = model(torch.from_numpy(mel), emb, torch.tensor(0.3), noise, training=True)
    for g, w in zip(fwd, j_fwd):
        assert _rel_err(g, w) <= 1e-5
    assert _rel_err(fwd[0] - fwd[2], 0.3 * noise) <= 1e-5
    got = to_flat(model)
    for k, w in _flatten({"stats": j_stats}).items():
        assert _stats_close(got[k], w, 1e-5), k


def test_jax_written_dae_without_label_weights_loads_and_computes_jax():
    """JAX's init creates the label conditioning only when it runs it, so a
    DAE that JAX's ``create_new_model`` wrote (a plain init) has none of its
    weights, and JAX's ``get_embeddings`` then raises. The port loads it (fresh, seeded label weights with zero block
    gains), encodes and decodes as JAX does, and a label embedding then
    changes nothing; a dict missing only part of them is refused."""
    jdae = JaxDAE(JaxDAEConfig(**DAE_KW))
    jvars = jax.jit(jdae.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 56, 2)))
    flat = _flatten(jvars)
    assert not any("emb" in k for k in flat)
    with pytest.raises(Exception, match="emb_label"):     # JAX cannot embed a label with it
        jdae.apply(jvars, jnp.ones((1, EMB_DIM)), method=JaxDAE.get_embeddings)
    model = DAE(DAEConfig(**DAE_KW))
    load_flat(model, flat)
    assert model.label_embedding_keys() and all(
        float(b.emb_gain.detach()) == 0.0 for b in list(model.enc) + list(model.dec))
    mel = np.random.default_rng(5).standard_normal((1, 32, 56, 2)).astype(np.float32)
    j_lat = jax.jit(lambda v, x: jdae.apply(v, x, method=JaxDAE.encode))(jvars, jnp.asarray(mel))
    j_rec = jax.jit(lambda v, z: jdae.apply(v, z, method=JaxDAE.decode))(jvars, j_lat)
    with torch.no_grad():
        lat = model.encode(torch.from_numpy(mel))
        assert _rel_err(lat, j_lat) <= 1e-5
        assert _rel_err(model.decode(lat), j_rec) <= 1e-5
        emb = model.get_embeddings(torch.ones((1, EMB_DIM)))
        assert torch.equal(model.decode(lat, emb), model.decode(lat))
    partial = dict(flat, **{flax_key(k, v.dim() == 0): v.numpy().reshape(v.shape or (1,))
                            for k, v in model.state_dict().items() if k.startswith("emb_label.")})
    with pytest.raises(KeyError):
        load_flat(DAE(DAEConfig(**DAE_KW)), partial)


def _jax_dae_draws(rng_key, accum, micro_b):
    """The draws of one JAX DAE step (module_trainers.py:48, 175, 245-246,
    295-302; ms_mdct_dual.py:266)."""
    _, step_key = jax.random.split(rng_key)
    draws = []
    for k in jax.random.split(step_key, accum):
        k_st, k_ph, _ = jax.random.split(k, 3)
        flip = jax.random.bernoulli(k_st, 0.5, (micro_b,))
        theta = jax.random.uniform(jax.random.fold_in(k_ph, 7), (micro_b,)) * 2 * jnp.pi
        draws.append(DAEMicroDraws(torch.from_numpy(np.array(flip)), _t(theta)))
    return draws


def test_dae_train_step_with_embeddings_matches_jax():
    """Two steps of the tiny supersampled, label-conditioned DAE with
    ``audio_embeddings`` in the batch (the label embedding feeds the training
    forward and the phase-invariance encode), gradient accumulation 2 of one
    sample, the unfolded MSS2D, one EMA, JAX's draws replayed: loss and grad
    norm to 1e-4 relative, the stats to 1e-5 relative, params (the label
    embedding's among them) and EMA to lr/20 but for at most 1 element in
    1,000. Those elements have a gradient near 1e-5 of the median (the
    forced weight norm projects the radial part out of each row's gradient,
    a difference of large terms), whose sign fp32 rounding decides; AdamW's
    first updates are +-lr whatever the gradient's size, so a flipped sign
    moves such an element by about 2 lr: 3 lr bounds every element."""
    jfmt, tfmt = _formats()
    jdae, jvars = _jax_dae()
    lr, n, accum = 1e-3, 2, 2
    kw = dict(grad_accum_steps=accum, kl_warmup_steps=4, latents_regularization_warmup_steps=4,
              point_loss_warmup_steps=4)
    jtc = JaxDAETrainConfig(mss2d=jlosses.MSSLoss2DConfig(block_widths=MSS_WIDTHS), **kw)
    jopt = joptim.build_optimizer("adamw", lr)
    jbank = jema.EMABank([jema.EMAConfig(name="std0.05", std=0.05)])
    jstep = jax.jit(jax_make_dae_step(jdae, jfmt, jopt, jbank, jtc, n))
    jstate = jax_init_train_state(jvars, jopt, jbank, JaxSigmaConfig(), jax.random.PRNGKey(13))

    model = _port_dae(jvars)
    opt = build_optimizer("adamw", model.parameters(), lr)
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    tstep = make_dae_train_step(tfmt, opt, bank,
                                DAETrainConfig(mss2d=MSSLoss2DConfig(block_widths=MSS_WIDTHS),
                                               **kw), n)
    tstate = init_train_state(model, opt, bank, SigmaSamplerConfig(), torch.Generator())
    rng = np.random.default_rng(14)
    for i in range(2):
        batch = {"audio": np.concatenate([_audio((1, 2, RAW_LEN), 70 + 2 * i + j)
                                          for j in range(n)]),
                 "audio_embeddings": rng.standard_normal((n, EMB_DIM)).astype(np.float32)}
        draws = _jax_dae_draws(jstate.rng, accum, n // accum)
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tlogs = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        for k in ("loss", "grad_norm"):
            assert abs(float(tlogs[k]) - float(jlogs[k])) <= 1e-4 * abs(float(jlogs[k])), (i, k)

    want_p, got_p, start = _flatten(jstate.params), to_flat(model), _flatten(jvars)
    want_e = _flatten(jstate.ema_state["std0.05"])
    got_e = state_to_flat(tstate.ema_state["std0.05"])
    assert sorted(got_e) == sorted(want_e) == sorted(want_p)
    far, total = 0, 0
    for k in want_p:
        for got, want in ((got_p[k], want_p[k]), (got_e[k], want_e[k])):
            if k.startswith("stats/"):
                assert _stats_close(got, want, 1e-5), k
            else:
                diff = np.abs(got - want)
                assert diff.max() <= 3 * lr, k
                far += int((diff > lr / 20).sum())
                total += diff.size
    assert far <= total // 1000
    assert np.abs(want_p["params/emb_label/w_mp"] - start["params/emb_label/w_mp"]).max() > 6 * lr


# ---------------------------------------------------------------------------
# (i) every model directory of configs/models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["edm2_dae_d3a", "edm2_dae_e1b", "edm2_ddec_mclt_b1a",
                                  "edm2_ddec_mclt_b2a"])
def test_config_model_directories_build_and_load(name, tmp_path):
    """``python -m dualdiffusion_tpu_torch.create_new_model --device cpu``
    writes the directory and ``from_pretrained`` loads every module with the
    written weights. Each module has the keys and shapes of ``jax.eval_shape``
    over the JAX ``init_module``, and a DAE with label conditioning also the
    label weights JAX's plain init leaves out; a JAX-written DAE of these
    shapes loads. (``edm2_default``'s modules: test_torch_create_new_model.py.)"""
    out = cnm.main(["--name", name, "--config_path", str(ROOT / "configs" / "models"),
                    "--output_path", str(tmp_path), "--device", "cpu", "--seed", "1"])
    pipe = Pipeline.from_pretrained(out, device="cpu")
    cfg_dir = ROOT / "configs" / "models" / name
    for mod_name, mtype in load_json(cfg_dir / "model_index.json")["modules"].items():
        if mtype.startswith("format:"):
            continue
        module = pipe.modules[mod_name].module
        saved = load_safetensors(out / mod_name / f"{mod_name}.safetensors")
        got = to_flat(module)
        assert sorted(got) == sorted(saved) and all(np.array_equal(got[k], saved[k]) for k in got)
        raw = load_json(cfg_dir / f"{mod_name}.json")
        jcfg = jax_config_from_dict(jax_module_class(mtype)[1], raw)
        want = _flatten_shapes(jax.eval_shape(lambda k: jax_cnm.init_module(mtype, jcfg, k)[1],
                                              jax.random.PRNGKey(0)))
        shapes = {k: v.shape for k, v in got.items()}
        label = ({flax_key(k, v.dim() == 0) for k, v in module.state_dict().items()
                  if k in module.label_embedding_keys()} if mtype == "dae" else set())
        assert set(shapes) - set(want) == label and set(want) <= set(shapes)
        assert all(shapes[k] == want[k] for k in want)
        if mtype == "dae":
            assert module.cfg.supersampled and module.cfg.in_channels_emb == 1024 and label
            jax_written = {k: np.zeros(s, np.float32) for k, s in want.items()}
            fresh = get_module_class(mtype)[0](config_from_dict(get_module_class(mtype)[1], raw),
                                               "cpu")
            load_flat(fresh, jax_written)
            assert float(fresh.conv_in.bias.abs().sum()) == 0.0
