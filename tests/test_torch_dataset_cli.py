"""``python -m dualdiffusion_tpu_torch.dataset_process`` on the CPU: every
subcommand, the multiprocess runs (spawned stage workers, errors counted,
``test_mode``), and the chain from audio to a UNet training step on the
latents the encode stage made, read by the port's dataloader. No JAX: the
stages are held against the JAX package's in tests/test_torch_dataset_factory.py.

<-> the root dataset_process.py and dualdiffusion_tpu/dataset/processor.py.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dualdiffusion_tpu_torch import dataset_process
from dualdiffusion_tpu_torch.dataset import DatasetConfig, DatasetProcessor, DualDiffusionDataset
from dualdiffusion_tpu_torch.dataset import processes as P
from dualdiffusion_tpu_torch.dataset.processor import DatasetProcessorConfig
from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
from dualdiffusion_tpu_torch.utils import load_safetensors, save_audio, save_safetensors

REPO = Path(__file__).resolve().parents[1]
SR = 32000
FMT_KW = dict(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
              default_raw_length=63 * 32)
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
              in_num_freqs=32, compute_dtype="float32")
UNET_KW = dict(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=16,
               channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=16,
               logvar_channels=32, mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _song(seed: int, seconds: float = 0.5) -> np.ndarray:
    """Seeded stereo chords with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    sig = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
              for _ in range(4)) + 0.05 * rng.standard_normal(t.size)
    audio = np.stack([sig * rng.uniform(0.5, 1.0) for _ in range(2)])
    return (0.3 * audio / np.abs(audio).max()).astype(np.float32)


def test_encode_without_a_card_raises(tmp_path, monkeypatch):
    """``encode`` defaults to the card and never falls back to the CPU (no
    card is seen, on any machine)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dataset_process.main(["encode", "--dataset_path", str(tmp_path),
                              "--model_path", str(tmp_path)])


def test_processor_reports_errors_and_test_mode_writes_nothing(tmp_path):
    """A cuda stage whose model does not load logs an error, drains its
    input so the stage before it never blocks, and the run ends with the
    error counted; a bad file is an error of its own; ``test_mode``
    normalizes without writing audio or sidecars."""
    for i in range(3):
        save_audio(_song(40 + i, 0.2), SR, tmp_path / f"s{i}.wav")
    before = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    (tmp_path / "bad.wav").write_bytes(b"not a wav file")
    cfg = DatasetProcessorConfig(dataset_path=str(tmp_path), max_num_proc=1, test_mode=True)
    enc = P.EncodeConfig(model_path=str(tmp_path / "no_model"), device="cpu")
    out = DatasetProcessor(cfg).process(
        "Encode", [P.EncodeLoadStage(enc), P.EncodeStage(enc), P.EncodeSaveStage(enc)],
        input=[str(tmp_path)], input_extensions=P.AUDIO_EXTS)
    assert out["errors"] >= 2 and out["processed"] == 0
    out = DatasetProcessor(cfg).process("Normalize", [P.NormalizeStage()],
                                        input=[str(tmp_path)], input_extensions=P.AUDIO_EXTS)
    assert out["errors"] == 1 and out["processed"] == 4
    assert {p.name: p.read_bytes() for p in tmp_path.iterdir() if p.name != "bad.wav"} == before


def _port_model_dir(path: Path) -> Path:
    """A tiny format + DAE + UNet model directory written by the port."""
    gen = torch.Generator().manual_seed(12)
    fcfg, dcfg, ucfg = (MSMDCTDualFormatConfig(**FMT_KW), DAEConfig(**DAE_KW),
                        UNetConfig(**UNET_KW))
    Pipeline({"format": ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                     MSMDCTDualFormat(fcfg)),
              "dae": ModuleHandle("dae", "dae", dcfg, DAE(dcfg).init_weights(gen)),
              "unet": ModuleHandle("unet", "unet", ucfg, UNet(ucfg).init_weights(gen))}
             ).save_pretrained(path)
    return path


def test_cli_round_trip_trains_a_unet_on_the_cpu(tmp_path):
    """normalize (2 worker processes), encode (``python -m``, a spawned
    worker on the CPU; CLAP skipped with a warning), integrity_check,
    build_splits and aggregate_embeddings after seeded embeddings are added;
    the port's dataloader reads the dataset and a tiny UNet takes a
    training step on it. Two songs of one name in two folders keep two
    latents files."""
    model = _port_model_dir(tmp_path / "model")
    data = tmp_path / "data"
    names = ["gameA/01 - Title.wav", "gameB/01 - Title.wav", "gameA/02.wav", "gameB/03.wav"]
    for i, name in enumerate(names):
        save_audio(_song(20 + i) * 0.1, SR, data / name)

    def run(*argv):
        assert dataset_process.main([argv[0], "--dataset_path", str(data), *argv[1:]]) == 0

    run("normalize", "--max_num_proc", "2")
    env = {k: v for k, v in os.environ.items() if not k.startswith("CLAP_")}
    env.update(HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.dataset_process",
                           "encode", "--dataset_path", str(data), "--model_path", str(model),
                           "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLAP unavailable" in proc.stderr and "ready" in proc.stderr
    assert proc.stderr.count("encoded ") == 4
    run("integrity_check")

    rng = np.random.default_rng(30)
    for name in names:
        meta = P.read_sidecar(str(data / name))
        assert meta["post_norm_lufs"] == -20.0
        assert meta["latents_file_name"] == str(Path("latents") / Path(name).with_suffix(
            ".safetensors"))
        lat_path = data / meta["latents_file_name"]
        lat = load_safetensors(lat_path)["latents"]
        assert lat.dtype == np.float16 and lat.shape == (8, 8, 8, 123)
        assert np.isfinite(lat).all()
        assert meta["latents_length"] == 123 and meta["latents_num_variations"] == 8
        emb = rng.standard_normal((2, 1024)).astype(np.float32)
        save_safetensors({"latents": lat, "clap_audio_embeddings": emb}, lat_path)
        P.write_sidecar(str(data / name), {"latents_has_audio_embeddings": True})
    assert len(list((data / "latents").rglob("*.safetensors"))) == 4

    run("build_splits", "--validation_fraction", "0")
    run("aggregate_embeddings", "--copy_to_model_path", str(model))
    records = [json.loads(l) for l in (data / "train.jsonl").read_text().splitlines()]
    assert len(records) == 4 and all(r["latents_has_audio_embeddings"] for r in records)

    ds = DualDiffusionDataset(DatasetConfig(data_dir=str(data), latents_crop_width=64))
    batch = next(ds.iter_batches("train", 4, seed=0, prefetch=0))
    assert batch["latents"].shape == (4, 8, 8, 64)
    assert batch["audio_embeddings"].shape == (4, 1024)

    from dualdiffusion_tpu_torch import train
    config = tmp_path / "unet_train.json"
    config.write_text(json.dumps({
        "module_name": "unet", "device_batch_size": 2, "gradient_accumulation_steps": 2,
        "lr_schedule": {"lr_warmup_steps": 0}, "emas": {"std0.05": {"std": 0.05}},
        "dataloader": {"latents_crop_width": 64}}))
    trainer = train.main(["--model_path", str(model), "--train_config_path", str(config),
                          "--dataset_path", str(data), "--device", "cpu", "--max_steps", "1"])
    assert trainer.state.global_step == 1 and np.isfinite(trainer.history[0]["loss"])

    pipe = Pipeline.from_pretrained(model, device="cpu")
    emb = pipe.get_prompt_embedding({"gameA": 1.0})
    uncond = pipe.get_prompt_embedding({"nothing": 1.0})
    assert emb.shape == (1, 1024) and not torch.allclose(emb, uncond)


def test_import_emb_db_dedupe_and_label_subcommands(tmp_path, monkeypatch):
    """``import`` copies source WAVs into the dataset; ``build_emb_db``
    writes each song's mean embedding, which ``dedupe`` holds every song
    against; ``label`` needs CLAP weights and raises without them."""
    src, data = tmp_path / "src", tmp_path / "data"
    save_audio(_song(1, 0.1), SR, src / "a.wav")
    save_audio(_song(2, 0.1), SR, src / "sub" / "b.wav")
    (src / "notes.txt").write_text("not audio")

    def run(*argv):
        return dataset_process.main([argv[0], "--dataset_path", str(data), *argv[1:]])

    assert run("import", "--input", str(src)) == 0
    assert sorted(p.name for p in data.iterdir()) == ["a.wav", "b.wav"]
    assert (data / "b.wav").read_bytes() == (src / "sub" / "b.wav").read_bytes()
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    for name, e in (("a", emb), ("b", emb + 1e-3)):
        save_safetensors({"clap_audio_embeddings": e}, data / "latents" / f"{name}.safetensors")
        P.write_sidecar(str(data / f"{name}.wav"),
                        {"latents_file_name": f"latents/{name}.safetensors"})
    assert run("build_emb_db") == 0
    db = load_safetensors(data / "dataset_infos" / "audio_emb_db.safetensors")
    assert sorted(db) == [str(data / "a.wav"), str(data / "b.wav")]
    np.testing.assert_allclose(db[str(data / "a.wav")], emb.mean(0).astype(np.float16))
    assert run("dedupe") == 0
    dups = P.read_sidecar(str(data / "a.wav"))["duplicates"]
    assert [d["file"] for d in dups] == [str(data / "b.wav")] and dups[0]["similarity"] > 0.99
    (data / "dataset_infos" / "labels.json").write_text(json.dumps({"labels": ["bright"]}))
    monkeypatch.delenv("CLAP_MODEL_PATH", raising=False)
    monkeypatch.delenv("CLAP_ALLOW_DOWNLOAD", raising=False)
    with pytest.raises(RuntimeError, match="CLAP"):
        run("label", "--device", "cpu")
