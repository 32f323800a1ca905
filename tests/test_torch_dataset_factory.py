"""The port's dataset factory against the JAX package's: the normalize,
encode, build_splits, label, dedupe, build_emb_db and aggregate_embeddings
stages on the same files and the same tiny model directory (written by the
JAX package, read by both), the ``_latents_path`` collision of the JAX copy
and the relative latents paths it reads against the working directory
(the CLI and the multiprocess runs: tests/test_torch_dataset_cli.py).

<-> dualdiffusion_tpu/dataset/processes.py.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualdiffusion_tpu.dataset import processes as JP
from dualdiffusion_tpu.dataset.processor import DatasetProcessorConfig as JaxProcConfig
from dualdiffusion_tpu.models.dae import DAE as JaxDAE
from dualdiffusion_tpu.models.dae import DAEConfig as JaxDAEConfig
from dualdiffusion_tpu.models.formats import MSMDCTDualFormat as JaxMSMDCTDualFormat
from dualdiffusion_tpu.models.formats import MSMDCTDualFormatConfig as JaxFormatConfig
from dualdiffusion_tpu.pipelines.pipeline import ModuleHandle as JaxModuleHandle
from dualdiffusion_tpu.pipelines.pipeline import Pipeline as JaxPipeline
from dualdiffusion_tpu_torch.dataset import processes as P
from dualdiffusion_tpu_torch.dataset.processor import DatasetProcessorConfig
from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
from dualdiffusion_tpu_torch.utils import load_audio, load_safetensors, save_audio, save_safetensors

SR = 32000
# a 32-filter mel on a 256-point STFT, hop 32; a three-level fp32 DAE (ratio 4)
FMT_KW = dict(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
              default_raw_length=63 * 32)
DAE_KW = dict(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
              num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
              in_num_freqs=32, compute_dtype="float32")
# the stage's chunk plan at the tiny size: 492 mel frames in three chunks
ENC_KW = dict(pitch_shift_augmentations=(2,), max_chunk=256, overlap=32,
              encode_embeddings=False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _song(seed: int, seconds: float = 0.5, channels: int = 2) -> np.ndarray:
    """Seeded chords with a little noise, the channels at different gains."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    sig = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
              for _ in range(4)) + 0.05 * rng.standard_normal(t.size)
    audio = np.stack([sig * rng.uniform(0.5, 1.0) for _ in range(channels)])
    return (0.3 * audio / np.abs(audio).max()).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    """A tiny ms_mdct_dual + DAE model directory written by the JAX package."""
    fcfg, dcfg = JaxFormatConfig(**FMT_KW), JaxDAEConfig(**DAE_KW)
    dae = JaxDAE(dcfg)
    dvars = jax.jit(dae.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 64, 2)))
    path = tmp_path_factory.mktemp("jax_model")
    JaxPipeline({"dae": JaxModuleHandle("dae", "dae", dcfg, dae, dvars),
                 "format": JaxModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                           JaxMSMDCTDualFormat(fcfg))}).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def encoded(jax_model_dir, tmp_path_factory):
    """One stereo song through both packages' EncodeStage in-process, with
    one pitch offset and the stereo mirror: (JAX latents, port latents)."""
    root = tmp_path_factory.mktemp("encode")
    item = {"path": str(root / "song.wav"), "audio": _song(1), "sample_rate": SR}
    jstage = JP.EncodeStage(JP.EncodeConfig(model_path=str(jax_model_dir), **ENC_KW))
    jstage.start_process(JaxProcConfig(dataset_path=str(root)), 0)
    want = jstage.process(dict(item))["tensors"]["latents"]
    stage = P.EncodeStage(P.EncodeConfig(model_path=str(jax_model_dir), device="cpu", **ENC_KW))
    stage.start_process(DatasetProcessorConfig(dataset_path=str(root)), 0)
    out = stage.process(dict(item))
    return want, out


def test_encode_stage_latents_match_jax(encoded):
    """8 variations (4 time offsets x the stereo mirror) per format, the
    base format then the +2 semitone one: (16, 8, 8, 123) float16 from a
    (16, 2, 15808) stack. Both run the fp32 DAE on the same weights over the
    same three chunks; they differ by fp32 rounding and then by one float16
    rounding of the stored value (at most 2 float16 ulps, 1e-3 relative,
    plus 1e-4 of max)."""
    want, out = encoded
    got = out["tensors"]["latents"]
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (16, 8, 8, 123)
    assert np.isfinite(got).all()
    g, w = got.astype(np.float32), want.astype(np.float32)
    assert (np.abs(g - w) <= 2e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).all()
    # the pitch-shifted half is another mel, and the mirror swaps the channels' mels
    assert np.abs(w[8:] - w[:8]).max() > 0.1 * np.abs(w).max()
    assert out["stats"]["chunks"] == 3


def test_augmentations_match_jax(jax_model_dir):
    """Time offsets of 0, 2, 4 and 6 hops' eighth-steps into a shared
    window, then the stereo mirror, for stereo and mono audio."""
    jstage = JP.EncodeStage(JP.EncodeConfig())
    stage = P.EncodeStage(P.EncodeConfig())
    fmt = MSMDCTDualFormat(MSMDCTDualFormatConfig(**FMT_KW))
    jstage.fmt, stage.fmt = JaxMSMDCTDualFormat(JaxFormatConfig(**FMT_KW)), fmt
    for channels in (2, 1):
        audio = _song(2, 0.1, channels)
        want = jstage._augmentations(audio, SR)
        np.testing.assert_array_equal(stage._augmentations(audio, SR), want)
        assert want.shape[0] == (8 if channels == 2 else 4)


def test_pitch_shifted_format_matches_jax():
    """The +3 semitone format's mel filterbank against JAX's."""
    from dualdiffusion_tpu_torch.dataset.processes import pitch_shifted_format
    rate = 2.0 ** (3 / 12)
    jfmt = JaxMSMDCTDualFormat(JaxFormatConfig(**FMT_KW, ms_freq_min=20.0,
                                               ms_freq_max_override=16000 * rate))
    got = pitch_shifted_format(MSMDCTDualFormat(MSMDCTDualFormatConfig(
        **FMT_KW, ms_freq_min=20.0 / rate)), 3)
    assert got.config.ms_freq_min == pytest.approx(20.0)
    np.testing.assert_allclose(got.ms_filters, np.asarray(jfmt.ms_filters), rtol=1e-6,
                               atol=1e-7)


def test_normalize_stage_matches_jax(tmp_path):
    """The same written samples (to one 16-bit step) and sidecar."""
    for pkg in ("jax", "port"):
        save_audio(_song(3, 1.0) * 0.2, SR, tmp_path / pkg / "a.wav")
    jstage, stage = JP.NormalizeStage(-18.0), P.NormalizeStage(-18.0)
    jstage.start_process(JaxProcConfig(dataset_path=str(tmp_path / "jax")), 0)
    stage.start_process(DatasetProcessorConfig(dataset_path=str(tmp_path / "port")), 0)
    jstage.process(str(tmp_path / "jax" / "a.wav"))
    stage.process(str(tmp_path / "port" / "a.wav"))
    want = load_audio(tmp_path / "jax" / "a.wav")
    got = load_audio(tmp_path / "port" / "a.wav")
    assert np.abs(got - want).max() <= 1.0 / 32768
    jmeta = JP.read_sidecar(str(tmp_path / "jax" / "a.wav"))
    meta = P.read_sidecar(str(tmp_path / "port" / "a.wav"))
    assert meta.keys() == jmeta.keys() and meta["post_norm_lufs"] == -18.0
    for k in meta:
        assert meta[k] == pytest.approx(jmeta[k], abs=1e-9)


def _curated_tree(root: Path):
    """Four songs with sidecars: ratings 0, 2, 3 and none, tags, lengths."""
    files = []
    for i, (folder, rating) in enumerate((("gameA", 0), ("gameA", 2), ("gameB", 3),
                                          ("gameB", None))):
        p = root / folder / f"{i:02d}.wav"
        save_audio(_song(10 + i, 0.05 * (i + 1)), SR, p)
        meta = {"post_norm_lufs": -20.0, "game": folder, "song": f"s{i}",
                "latents_file_name": f"latents/{folder}/{i:02d}.safetensors",
                "latents_length": 30 + i, "latents_num_variations": 8}
        if rating is not None:
            meta["rating"] = rating
        P.write_sidecar(str(p), meta)
        files.append(str(p))
    return files


def test_build_splits_matches_jax(tmp_path):
    """The same records and the same jsonl files, ratings routed to the
    negative and positive splits, one validation record by the seed."""
    files = _curated_tree(tmp_path)
    jstage, stage = JP.BuildSplitsStage(), P.BuildSplitsStage()
    jstage.start_process(JaxProcConfig(dataset_path=str(tmp_path)), 0)
    stage.start_process(DatasetProcessorConfig(dataset_path=str(tmp_path)), 0)
    want = [jstage.process(f) for f in files]
    got = [stage.process(f) for f in files]
    assert got == want
    for pkg, stage_cls, recs in (("jax", JP.BuildSplitsStage, want),
                                 ("port", P.BuildSplitsStage, got)):
        (tmp_path / pkg).mkdir()
        stage_cls.write_jsonl(recs, str(tmp_path / pkg), validation_fraction=0.25)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "train_negative.jsonl" in names or "validation_negative.jsonl" in names
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


@pytest.fixture
def embedded_tree(tmp_path):
    """Five songs in two folders, each latents file with seeded audio (and
    for some text) CLAP embeddings; song 4 a near-duplicate of song 0.
    Sidecars name the latents files by absolute path, which both packages
    read wherever they run."""
    rng = np.random.default_rng(11)
    files, embs = [], []
    for i, folder in enumerate(("gameA", "gameA", "gameB", "gameB", "gameB")):
        p = tmp_path / folder / f"{i}.wav"
        save_audio(np.zeros((2, 64), np.float32), SR, p)
        noise = rng.standard_normal((3, 16)).astype(np.float32)
        emb = embs[0] + 0.01 * noise if i == 4 else noise
        embs.append(emb)
        tensors = {"clap_audio_embeddings": emb}
        if i % 2 == 0:
            tensors["clap_text_embeddings"] = rng.standard_normal((1, 16)).astype(np.float32)
        lat = tmp_path / "latents" / folder / f"{i}.safetensors"
        save_safetensors(tensors, lat)
        P.write_sidecar(str(p), {"latents_file_name": str(lat)})
        files.append(str(p))
    return tmp_path, files


def _run_both(jstage, stage, root, files):
    jstage.start_process(JaxProcConfig(dataset_path=str(root)), 0)
    stage.start_process(DatasetProcessorConfig(dataset_path=str(root)), 0)
    return [jstage.process(f) for f in files], [stage.process(f) for f in files]


def test_embedding_stages_match_jax(embedded_tree, tmp_path):
    """BuildEmbDB, AggregateEmbeddings, Dedupe and Label on injected
    embeddings: the same entries, tables and sidecar fields (float32 means
    in the same order: 1e-6)."""
    root, files = embedded_tree
    want, got = _run_both(JP.BuildEmbDBStage(), P.BuildEmbDBStage(), root, files)
    for w, g in zip(want, got):
        assert g["file"] == w["file"]
        np.testing.assert_allclose(g["embedding"], w["embedding"], rtol=1e-6, atol=1e-7)
    db = root / "dataset_infos" / "audio_emb_db.safetensors"
    JP.BuildEmbDBStage.write_db(want, str(db))
    P.BuildEmbDBStage.write_db(got, str(tmp_path / "port_db.safetensors"))
    jdb, pdb = load_safetensors(db), load_safetensors(tmp_path / "port_db.safetensors")
    assert jdb.keys() == pdb.keys()
    for k in jdb:
        np.testing.assert_array_equal(pdb[k], jdb[k])

    want, got = _run_both(JP.AggregateEmbeddingsStage(), P.AggregateEmbeddingsStage(), root,
                          files)
    JP.AggregateEmbeddingsStage.write_db(want, str(tmp_path / "jax_table.safetensors"))
    P.AggregateEmbeddingsStage.write_db(got, str(tmp_path / "table.safetensors"))
    jtab = load_safetensors(tmp_path / "jax_table.safetensors")
    tab = load_safetensors(tmp_path / "table.safetensors")
    assert set(tab) == set(jtab) == {"_unconditional_audio", "_unconditional_text",
                                     "gameA_audio", "gameA_text", "gameB_audio", "gameB_text"}
    for k in tab:
        np.testing.assert_allclose(tab[k], jtab[k], rtol=1e-6, atol=1e-7)

    for key, jstage, stage in (
            ("duplicates", JP.DedupeStage(str(db)), P.DedupeStage(str(db))),
            ("label_scores", JP.LabelStage({"bright": np.ones(16), "dark": -np.arange(16.0)}),
             P.LabelStage({"bright": np.ones(16), "dark": -np.arange(16.0)}))):
        jstage.start_process(JaxProcConfig(dataset_path=str(root)), 0)
        stage.start_process(DatasetProcessorConfig(dataset_path=str(root)), 0)
        for f in files:
            assert jstage.process(f) == f
            want_meta = P.read_sidecar(f)[key]
            assert stage.process(f) == f
            assert _close(P.read_sidecar(f)[key], want_meta)
    dups = P.read_sidecar(files[4])["duplicates"]
    assert [d["file"] for d in dups] == [files[0]]


def _close(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return abs(a - b) <= 1e-6
    return a == b


def test_relative_latents_paths_are_read_against_the_dataset(embedded_tree, tmp_path,
                                                               monkeypatch):
    """The encode stage stores latents paths relative to the dataset. JAX's
    aggregate, dedupe, label and emb-db stages read them against the working
    directory and find nothing outside the dataset; the port's read them
    against the dataset path, as the dataloader does."""
    root, files = embedded_tree
    for f in files:
        rel = os.path.relpath(P.read_sidecar(f)["latents_file_name"], root)
        P.write_sidecar(f, {"latents_file_name": rel})
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    monkeypatch.chdir(elsewhere)
    want, got = _run_both(JP.AggregateEmbeddingsStage(), P.AggregateEmbeddingsStage(), root,
                          files)
    assert want == [None] * len(files)
    assert [g["label"] for g in got] == ["gameA", "gameA", "gameB", "gameB", "gameB"]


def test_latents_path_collision_in_jax_is_repaired(tmp_path):
    """Two songs of one file name in two folders: one latents file in JAX,
    two in the port, each under the song's own folder."""
    a = str(tmp_path / "gameA" / "01 - Title.wav")
    b = str(tmp_path / "gameB" / "01 - Title.wav")
    jenc = JP.EncodeConfig()
    assert JP._latents_path(jenc, str(tmp_path), a) == JP._latents_path(jenc, str(tmp_path), b)
    enc = P.EncodeConfig()
    pa, pb = P._latents_path(enc, str(tmp_path), a), P._latents_path(enc, str(tmp_path), b)
    assert pa != pb
    assert pa == tmp_path / "latents" / "gameA" / "01 - Title.safetensors"
    # an audio file outside the dataset keeps its name, as in JAX
    outside = str(tmp_path.parent / "x.wav")
    assert P._latents_path(enc, str(tmp_path), outside) == JP._latents_path(
        jenc, str(tmp_path), outside)
