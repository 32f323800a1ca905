"""The port's entry points on two gloo ranks: ``python -m
dualdiffusion_tpu_torch.train --device cpu`` launched as two processes (the
JAX package's ``DD_*`` variables, a file rendezvous) training the tiny UNet
under FSDP and resuming, where rank 1 writes nothing under the model
directory (an audit hook records every file it opens for writing, every
directory it makes and every file it removes); and ``sample --tp 2 --device
cpu`` spawning its two ranks and writing one file.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dualdiffusion_tpu_torch import sample
from dualdiffusion_tpu_torch.dataset import write_latent_dataset
from dualdiffusion_tpu_torch.models import UNet, UNetConfig
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
from dualdiffusion_tpu_torch.utils import get_audio_loudness, load_audio
from test_torch_sample_cli import _model_dir
from test_torch_training import UNET_KW

ROOT = Path(__file__).resolve().parents[1]

# runs the train entry under an audit hook that lists what it writes below WATCH_ROOT
WATCHED = r"""
import atexit, os, runpy, sys
root, report, writes = os.environ["WATCH_ROOT"], os.environ["WRITE_REPORT"], []
WRITE_FLAGS = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

def under(p):
    try:
        return os.path.abspath(os.fsdecode(p)).startswith(root)
    except TypeError:
        return False

def hook(event, args):
    if event == "open" and under(args[0]):
        mode, flags = args[1], args[2]
        if (mode is not None and any(c in mode for c in "wax+")) or (
                mode is None and flags & WRITE_FLAGS):
            writes.append(f"open {args[0]} {mode} {flags}")
    elif event in ("os.mkdir", "os.remove", "os.rename", "os.replace", "os.rmdir",
                   "shutil.rmtree", "shutil.copyfile", "os.truncate") and under(args[0]):
        writes.append(f"{event} {args[0]}")

sys.addaudithook(hook)
atexit.register(lambda: open(report, "w").write("\n".join(writes)))
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("dualdiffusion_tpu_torch.train", run_name="__main__")
"""


def _launch(tmp_path, args, tag):
    """Both ranks of one run; rank 1 under the audit hook. -> (stderr of
    each rank, rank 1's writes)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               DD_COORDINATOR_ADDRESS=f"file://{tmp_path / f'rdzv_{tag}'}",
               DD_NUM_PROCESSES="2", WATCH_ROOT=str(tmp_path / "m"),
               WRITE_REPORT=str(tmp_path / f"writes_{tag}.txt"))
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        ([sys.executable, "-m", "dualdiffusion_tpu_torch.train"] if r == 0
         else [sys.executable, "-c", WATCHED]) + args,
        cwd=tmp_path, env=dict(env, DD_PROCESS_ID=str(r)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        errs = [p.communicate(timeout=180)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, e) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}:\n{e[-3000:]}"
    return errs, (tmp_path / f"writes_{tag}.txt").read_text()


def test_train_cli_on_two_ranks_writes_from_rank_zero_alone(tmp_path):
    """Two ranks, FSDP, device batch 2 x accumulation 2 each: a global batch
    of 8 a step, 2 steps, then ``--resume`` to step 3 on both ranks. Rank 0
    writes the checkpoints (whole tensors: the one-process shapes), the
    tensorboard events and the per-sample losses of both ranks' samples;
    rank 1 writes nothing below the model directory."""
    cfg = UNetConfig(**UNET_KW)
    unet = UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    Pipeline({"unet": ModuleHandle("unet", "unet", cfg, unet)}).save_pretrained(tmp_path / "m")
    write_latent_dataset(tmp_path / "d", 8, (4, 8, 16), 8, seed=1)
    (tmp_path / "tc.json").write_text(json.dumps({
        "device_batch_size": 2, "gradient_accumulation_steps": 2, "checkpoints_total_limit": 2,
        "lr_schedule": {"lr_warmup_steps": 0}, "dataloader": {"latents_crop_width": 16},
        "emas": {"std0.05": {"std": 0.05}}, "parallel": {"fsdp": True}}))
    args = ["--device", "cpu", "--model_path", str(tmp_path / "m"), "--train_config_path",
            str(tmp_path / "tc.json"), "--dataset_path", str(tmp_path / "d")]
    errs, writes = _launch(tmp_path, args + ["--max_steps", "2"], "a")
    assert writes == ""
    assert all("rank %d/2" % r in e for r, e in enumerate(errs))
    errs, writes = _launch(tmp_path, args + ["--resume", "--max_steps", "3"], "b")
    assert writes == ""
    assert all("resumed from" in e and "at step 2" in e for e in errs)

    m = tmp_path / "m"
    ts = torch.load(m / "unet_checkpoint-3" / "train_state.pt")
    assert ts["global_step"] == 3 and ts["total_samples_processed"] == 3 * 8
    state = UNet(cfg).state_dict()
    for v, p in zip(ts["optimizer"]["adamw"]["state"].values(), unet.parameters()):
        assert v["exp_avg"].shape == p.shape and int(v["step"]) == 3
    reloaded = Pipeline.from_pretrained(m, device="cpu", load_checkpoints=True)
    assert {k: v.shape for k, v in reloaded.modules["unet"].module.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    losses = json.loads((m / "per_sample_losses.json").read_text())
    assert len(losses) == 8 and np.all(np.isfinite(list(losses.values())))
    assert any((m / "logs" / "unet").iterdir())


@pytest.mark.parametrize("trainer", ["ddec", "dae_ddec"])
def test_ddec_trainers_on_two_ranks(tmp_path, trainer):
    """The DDEC trainer (the frozen DAE's prepare stage on each rank) and
    the joint DAE + DDEC trainer (the DAE's batch statistics over both
    ranks) under data parallelism: 2 steps of a global batch of 4 on two
    ranks, finite losses, rank 1 writing nothing, and a checkpoint of
    whole tensors that ``from_pretrained`` loads."""
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    from test_torch_ddec_training import EMB_DIM, RAW_LEN, write_ddec_model
    write_ddec_model(tmp_path / "m")
    write_audio_dataset(tmp_path / "d", 8, 2, RAW_LEN + 500, seed=1, emb_dim=EMB_DIM)
    cfg = {"module_name": "ddec", "module_trainer": trainer, "device_batch_size": 1,
           "gradient_accumulation_steps": 2, "lr_schedule": {"lr_warmup_steps": 0},
           "dataloader": {"load_datatypes": ["audio", "audio_embeddings"],
                          "raw_crop_width": RAW_LEN},
           "emas": {"std0.05": {"std": 0.05}}}
    if trainer == "dae_ddec":
        cfg["module_trainer_config"] = {"dae": {"kl_warmup_steps": 4,
                                                "mss2d": {"block_widths": [8, 16]}}}
    (tmp_path / "tc.json").write_text(json.dumps(cfg))
    errs, writes = _launch(tmp_path, ["--device", "cpu", "--model_path", str(tmp_path / "m"),
                                      "--train_config_path", str(tmp_path / "tc.json"),
                                      "--dataset_path", str(tmp_path / "d"),
                                      "--max_steps", "2"], "a")
    assert writes == ""
    losses = [float(line.split(" loss ")[1].split()[0]) for line in errs[0].splitlines()
              if " loss " in line]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    ts = torch.load(tmp_path / "m" / "ddec_checkpoint-2" / "train_state.pt")
    assert ts["total_samples_processed"] == 2 * 4
    pipe = Pipeline.from_pretrained(tmp_path / "m", device="cpu",
                                    load_checkpoints={"ddec": "latest"})
    assert all(torch.isfinite(v).all() for v in pipe.modules["ddec"].module.state_dict().values())


def test_sample_tp_two_cpu_ranks_writes_one_clip(tmp_path):
    """``--tp 2 --device cpu`` spawns two gloo ranks, shards every module
    column-parallel and writes one WAV (rank 0's) at -20 LUFS, of the shape
    the same command writes without ``--tp``. (In the bf16 trunk the
    column-parallel convs round apart from the whole ones, and Griffin-Lim
    turns that into other audio; test_torch_parallel holds the sharded
    pipeline's clip to the replicated one in fp32 trunks.)"""
    d, _ = _model_dir(tmp_path)
    common = ["--model_path", str(d), "--prompt", "label_a:1.0", "--steps", "2",
              "--num_fgla_iters", "2", "--seed", "3", "--device", "cpu"]
    out_tp = tmp_path / "tp" / "clip.wav"
    sample.main(common + ["--tp", "2", "--output", str(out_tp)])
    assert sorted(p.name for p in out_tp.parent.iterdir()) == ["clip.wav"]
    out = tmp_path / "one" / "clip.wav"
    sample.main(common + ["--output", str(out)])
    got, want = load_audio(out_tp), load_audio(out)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert abs(get_audio_loudness(got, 32000) + 20.0) <= 0.5
