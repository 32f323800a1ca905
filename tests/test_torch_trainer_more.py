"""The trainer's remaining duties on the CPU, through the port's training
entry on a tiny DAE and a synthetic WAV dataset: a host-memory
(``cpu_offload``) EMA profile beside a device one of the same std, NorMuon
state through the checkpoint, a ``torch.profiler`` trace over a step
window, tensorboardX scalars (and JAX's fallback to the log without it),
the source snapshot in each checkpoint and the diff written on resume.

<-> dualdiffusion_tpu/training/trainer.py:222-256, 259-281, 287-421, 558-600.
"""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from dualdiffusion_tpu_torch import train
from dualdiffusion_tpu_torch.dataset import write_audio_dataset
from dualdiffusion_tpu_torch.models import DAE, DAEConfig
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
from dualdiffusion_tpu_torch.training.trainer import SOURCE_ROOT, Trainer, TrainerConfig
from dualdiffusion_tpu_torch.utils import load_safetensors
from test_torch_dae_training import DAE_KW, FMT_KW, RAW_LEN


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(tmp_path):
    dcfg, fcfg = DAEConfig(**DAE_KW), MSMDCTDualFormatConfig(**FMT_KW)
    dae = DAE(dcfg).init_weights(torch.Generator().manual_seed(0))
    Pipeline({"dae": ModuleHandle("dae", "dae", dcfg, dae),
              "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                     MSMDCTDualFormat(fcfg))}).save_pretrained(tmp_path / "m")
    write_audio_dataset(tmp_path / "d", 8, 2, RAW_LEN + 500, seed=1)
    (tmp_path / "tc.json").write_text(json.dumps({
        "module_name": "dae", "module_trainer": "dae",
        "module_trainer_config": {"domain": "mdct", "use_fused_mss2d": True,
                                  "mss2d": {"block_widths": [8, 16]}},
        "optimizer": {"optimizer": "normuon"},
        "device_batch_size": 2, "gradient_accumulation_steps": 2, "checkpoints_total_limit": 2,
        "lr_schedule": {"lr_warmup_steps": 0}, "profile_steps": [1, 2],
        "dataloader": {"use_pre_encoded_latents": False, "load_datatypes": ["audio"],
                       "raw_crop_width": RAW_LEN},
        "emas": {"dev": {"std": 0.05}, "host": {"std": 0.05, "cpu_offload": True}}}))
    return ["--device", "cpu", "--model_path", str(tmp_path / "m"), "--train_config_path",
            str(tmp_path / "tc.json"), "--dataset_path", str(tmp_path / "d")]


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_trainer_host_ema_profiler_tensorboard_and_snapshot(tmp_path):
    """Two steps, then ``--resume`` to step 3. The host profile equals the
    device profile of the same std at every checkpoint (1e-6 relative: the
    same lerp on the CPU), is saved beside it and restored exactly, with
    NorMuon's state; step 1's trace is written; every step's scalars reach
    tensorboard; each checkpoint holds the package's source, and a resume
    from a snapshot that differs writes the diff."""
    args = _setup(tmp_path)
    first = train.main(args + ["--max_steps", "2"])
    model = tmp_path / "m"
    assert first.trace_path == model / "profiles" / "dae_steps_1-2.trace.json"
    trace = json.loads(first.trace_path.read_text())
    assert any("aten::" in ev.get("name", "") for ev in trace["traceEvents"])
    ck2 = model / "dae_checkpoint-2"
    host2 = first.host_ema["host"]
    saved = {k: v.clone() for k, v in host2.items()}
    dev2 = first.state.ema_state["dev"]
    for k in dev2:
        assert torch.allclose(host2[k], dev2[k].float(), rtol=1e-6, atol=1e-8), k
    e_host = load_safetensors(ck2 / "dae" / "ema_host.safetensors")
    e_dev = load_safetensors(ck2 / "dae" / "ema_dev.safetensors")
    assert e_host.keys() == e_dev.keys()
    muon_saved = torch.load(ck2 / "train_state.pt")["optimizer"]["muon"]
    assert muon_saved["count"] == 2 and len(muon_saved["momentum"]) > 0

    snap = ck2 / "src_snapshot" / "training" / "trainer.py"
    assert snap.read_text() == (SOURCE_ROOT / "training" / "trainer.py").read_text()
    assert (ck2 / "src_snapshot" / "csrc" / "mss2d.cu").is_file()
    assert not list(model.glob("src_diff_*.txt"))
    snap.write_text(snap.read_text().replace("def _snapshot_source", "def _old_snapshot_source"))

    resumed = train.build_trainer(train.parse_args(args + ["--resume", "--max_steps", "3"]))
    diffs = list(model.glob("src_diff_*.txt"))
    assert len(diffs) == 1 and "-    def _old_snapshot_source" in diffs[0].read_text()
    got = resumed.host_ema["host"]
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    m = resumed.state.optimizer.muon
    assert m.count == 2 and all(torch.equal(a, b) for a, b in
                                zip(m.momentum_bufs, muon_saved["momentum"]))
    resumed.train(max_steps=3)
    ck3 = model / "dae_checkpoint-3"
    e_host = load_safetensors(ck3 / "dae" / "ema_host.safetensors")
    e_dev = load_safetensors(ck3 / "dae" / "ema_dev.safetensors")
    for k in e_dev:
        assert np.allclose(e_host[k], e_dev[k], rtol=1e-6, atol=1e-8), k
    scalars = _scalars(model / "logs" / "dae")
    assert [s for s, _ in scalars["loss/dae"]] == [1, 2, 3]
    assert "ema_betas/host" in scalars and "learn_rate/dae" in scalars


def test_trainer_without_tensorboard_logs_only(tmp_path, monkeypatch, caplog):
    """Without tensorboardX (as on a machine that lacks it) the trainer says
    so, as JAX's does, and goes on with no writer."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    caplog.set_level(logging.WARNING)
    model = torch.nn.Linear(2, 2)
    from dualdiffusion_tpu_torch.training import (SigmaSamplerConfig, build_optimizer,
                                                  init_train_state)
    opt = build_optimizer("adamw", model.parameters(), 1e-3)
    state = init_train_state(model, opt, None, SigmaSamplerConfig(), torch.Generator())
    trainer = Trainer(TrainerConfig(model_path=str(tmp_path)), lambda s, b: {}, state, [])
    assert trainer.writer is None
    assert "tensorboard unavailable; metrics to log only" in caplog.text


def test_validation_includes_the_host_profiles():
    """Validation runs over the train weights and every profile marked for
    it, the host-memory ones (synced first) included."""
    from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSamplerConfig,
                                                  build_optimizer, init_train_state)
    model = torch.nn.Linear(2, 1, bias=False)
    bank = EMABank([EMAConfig(name="dev", beta=0.5),
                    EMAConfig(name="host", beta=0.5, cpu_offload=True)])
    opt = build_optimizer("adamw", model.parameters(), 1e-3)
    state = init_train_state(model, opt, bank, SigmaSamplerConfig(), torch.Generator())
    trainer = Trainer(TrainerConfig(), lambda s, b: {}, state, [], ema_bank=bank,
                      validation_dataloader=[{}],
                      eval_step=lambda m, b, g: m.weight.sum())
    trainer.host_ema = bank.host_init({"weight": torch.tensor([[1.0, 2.0]])})
    got = trainer.validate()
    assert got["ema_host"] == 3.0 and got["ema_dev"] == got["train"] == float(model.weight.sum())


def test_train_cli_refuses_unknown_names_as_jax(tmp_path):
    """The training entry refuses an unknown optimizer, module trainer or
    module type with the JAX package's error text, now that "muon",
    "normuon", "vae" and "disc" are known."""
    from dualdiffusion_tpu.pipelines.pipeline import get_module_class as jax_module_class
    from dualdiffusion_tpu.training import builders  # noqa: F401 (registers JAX's trainers)
    from dualdiffusion_tpu.training import optim as joptim
    from dualdiffusion_tpu.training.trainer import get_module_trainer as jax_module_trainer
    args = _setup(tmp_path)
    tc = json.loads((tmp_path / "tc.json").read_text())
    for change, jax_call in ((dict(optimizer={"optimizer": "lion"}),
                              lambda: joptim.build_optimizer("lion")),
                             (dict(module_trainer="gan"), lambda: jax_module_trainer("gan"))):
        (tmp_path / "tc.json").write_text(json.dumps({**tc, **change}))
        with pytest.raises((ValueError, KeyError)) as want:
            jax_call()
        with pytest.raises(want.type) as got:
            train.main(args + ["--max_steps", "1"])
        assert str(got.value) == str(want.value)
    index = json.loads((tmp_path / "m" / "model_index.json").read_text())
    index["modules"]["dae"] = "gan"
    (tmp_path / "m" / "model_index.json").write_text(json.dumps(index))
    (tmp_path / "tc.json").write_text(json.dumps(tc))
    with pytest.raises(KeyError) as want:
        jax_module_class("gan")
    with pytest.raises(KeyError) as got:
        train.main(args + ["--max_steps", "1"])
    assert str(got.value) == str(want.value)
