# Copied from dualdiffusion_tpu/dataset/processes.py; the encode stage runs the port's DAE.
"""The dataset factory's stages (reference: src/dataset/processes/ —
import, normalize, encode, label, dedupe, build_splits, build_emb_db,
integrity_check).

* Audio: WAV natively, FLAC through an external binary when there is one;
  the import stage copies or transcodes.
* Per-file metadata lives in a ``<file>.json`` sidecar (the reference
  writes mutagen tags into the audio files; sidecars are codec-independent
  and atomic).
* The encode stage is the "cuda" stage: its worker loads the pipeline once
  on ``EncodeConfig.device`` (the card unless the caller asks for the CPU),
  builds the time-offset / pitch-shift / stereo-mirror variations, computes
  each variation's mel and encodes them with DAE ``tiled_encode``, adds CLAP
  audio embeddings where the CLAP weights are present, and hands float16
  (V, C, H, W) latents to the save stage, which merges them into any
  existing file (reference: processes/encode.py:65-398).
* A latents file lives at ``<dataset>/<latents_dir>/<audio path relative to
  the dataset>.safetensors``, so two songs of one name in two folders keep
  two files (the JAX package keeps the file name alone, and the second
  song is skipped or overwrites the first). Relative ``latents_file_name``
  entries of the sidecars are read against the dataset path, as the
  dataloader reads them (the JAX stages read them against the working
  directory).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import (get_audio_loudness, load_audio, load_safetensors, normalize_lufs,
                     save_audio, save_json, save_safetensors)
from .processor import DatasetProcessStage

logger = logging.getLogger(__name__)

AUDIO_EXTS = (".wav", ".flac")


def sidecar_path(audio_path: str) -> Path:
    return Path(str(audio_path) + ".json")


def read_sidecar(audio_path: str) -> Dict[str, Any]:
    p = sidecar_path(audio_path)
    if p.is_file():
        return json.loads(p.read_text())
    return {}


def write_sidecar(audio_path: str, data: Dict[str, Any], test_mode: bool = False) -> None:
    if test_mode:
        return
    existing = read_sidecar(audio_path)
    existing.update(data)
    save_json(existing, sidecar_path(audio_path))


def latents_file(dataset_path: str, meta: Dict[str, Any]) -> Optional[Path]:
    """The sidecar's latents file, relative names read against the dataset
    path; None when there is none."""
    name = meta.get("latents_file_name")
    if not name:
        return None
    p = Path(name)
    p = p if p.is_absolute() else Path(dataset_path) / p
    return p if p.is_file() else None


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

class ImportStage(DatasetProcessStage):
    """Copy/transcode source audio into the dataset tree (reference:
    processes/import.py)."""
    stage_type = "io"

    def __init__(self, output_dir: str, transcode_to: str = "wav") -> None:
        self.output_dir = output_dir
        self.transcode_to = transcode_to

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: str):
        src = Path(item)
        if src.suffix.lower() not in AUDIO_EXTS:
            return None
        dst = Path(self.output_dir) / (src.stem + "." + self.transcode_to)
        if dst.exists() and not self.config.force_overwrite:
            return str(dst)
        if self.config.test_mode:
            return str(dst)
        dst.parent.mkdir(parents=True, exist_ok=True)
        if src.suffix.lower() == "." + self.transcode_to:
            shutil.copy2(src, dst)
        else:
            audio, sr = load_audio(src, return_sample_rate=True)
            save_audio(audio, sr, dst)
        return str(dst)


# ---------------------------------------------------------------------------
# normalize
# ---------------------------------------------------------------------------

class NormalizeStage(DatasetProcessStage):
    """LUFS loudness normalization and clipping detection (reference:
    processes/normalize.py:53-271)."""
    stage_type = "cpu"

    def __init__(self, target_lufs: float = -20.0, clip_threshold: float = 0.999) -> None:
        self.target_lufs = target_lufs
        self.clip_threshold = clip_threshold

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: str):
        meta = read_sidecar(item)
        if meta.get("post_norm_lufs") is not None and not self.config.force_overwrite:
            return item
        audio, sr = load_audio(item, return_sample_rate=True)
        pre = get_audio_loudness(audio, sr)
        out = normalize_lufs(audio, sr, self.target_lufs)
        clipped = float(np.mean(np.abs(out) >= self.clip_threshold))
        if clipped > 0.001:
            logger.warning("%s: %.2f%% clipped samples after normalization", item,
                           clipped * 100)
        if not self.config.test_mode:
            save_audio(out, sr, item)
        write_sidecar(item, {"pre_norm_lufs": pre, "post_norm_lufs": self.target_lufs,
                             "clipped_fraction": clipped}, self.config.test_mode)
        return item


# ---------------------------------------------------------------------------
# encode (the cuda stage)
# ---------------------------------------------------------------------------

@dataclass
class EncodeConfig:
    """The fields of the JAX EncodeConfig, and ``device``."""
    model_path: str = ""
    num_time_offset_augmentations: int = 4
    #: pitch offsets (semitones): each builds a frequency-shifted format
    #: (reference: processes/encode.py:223-227, 267-270)
    pitch_shift_augmentations: Tuple[int, ...] = ()
    stereo_mirror_augmentation: bool = True
    max_chunk: int = 6144
    overlap: int = 256
    encode_embeddings: bool = True
    latents_dir: str = "latents"
    device: str = "cuda"


class EncodeLoadStage(DatasetProcessStage):
    """io: skip songs already encoded, load the others' audio (reference:
    processes/encode.py:65-210)."""
    stage_type = "io"

    def __init__(self, encode_config: EncodeConfig) -> None:
        self.enc = encode_config

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: str):
        out_path = _latents_path(self.enc, self.config.dataset_path, item)
        if out_path.exists() and not self.config.force_overwrite:
            return None  # skip-if-done
        t0 = time.perf_counter()
        audio, sr = load_audio(item, return_sample_rate=True)
        return {"path": item, "audio": audio, "sample_rate": sr,
                "stats": {"load_s": time.perf_counter() - t0}}


def pitch_shifted_format(fmt, semitones: float):
    """The format with its mel filterbank's frequency range scaled by
    2 ** (semitones / 12) (reference: encode.py:223-227, 267-270). A format
    whose mel has no settable top frequency (``ms_mdct_dual_v1``) raises
    ``ValueError``; the JAX stage fails there with ``AttributeError``."""
    rate = 2.0 ** (semitones / 12.0)
    fcfg = fmt.config
    if hasattr(fcfg, "ms_freq_max_override"):
        shifted = dataclasses.replace(fcfg, ms_freq_min=fcfg.ms_freq_min * rate,
                                      ms_freq_max_override=fcfg.ms_freq_max * rate)
    elif hasattr(fcfg, "min_frequency"):
        shifted = dataclasses.replace(fcfg, min_frequency=fcfg.min_frequency * rate,
                                      max_frequency=fcfg.max_frequency * rate)
    else:
        raise ValueError(f"format {type(fmt).__name__} does not support pitch-shift "
                         "augmentation")
    return type(fmt)(shifted)


class EncodeStage(DatasetProcessStage):
    """cuda: the pipeline's DAE encodes each variation's mel into latents,
    and CLAP its audio embeddings where the weights are present (reference:
    processes/encode.py:229-365). The worker loads the model on
    ``EncodeConfig.device`` and logs, when it ends, its peak device memory
    and the kernel launches it counted."""
    stage_type = "cuda"

    def __init__(self, encode_config: EncodeConfig) -> None:
        self.enc = encode_config

    def start_process(self, config, worker_index):
        import torch

        from ..pipelines.pipeline import Pipeline
        self.config = config
        self.device = torch.device(self.enc.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device; encode on the CPU with device 'cpu'")
            torch.cuda.reset_peak_memory_stats(self.device)
        self.pipeline = Pipeline.from_pretrained(self.enc.model_path, device=self.device,
                                                 load_checkpoints=True)
        self.dae = (self.pipeline.modules["dae"].module if "dae" in self.pipeline.modules
                    else None)
        self.fmt = self.pipeline.format
        if not hasattr(self.fmt, "raw_to_mel_spec"):
            raise ValueError(f"encode needs a format with a mel spectrogram "
                             f"(raw_to_mel_spec), not {type(self.fmt).__name__}")
        self.formats = [self.fmt] + [pitch_shifted_format(self.fmt, s)
                                     for s in self.enc.pitch_shift_augmentations]
        self.clap = None
        if self.enc.encode_embeddings:
            from ..models.embeddings import CLAPEmbedding
            clap = CLAPEmbedding(device=self.device)
            try:
                clap._load()
                self.clap = clap
            except RuntimeError as e:
                logger.warning("CLAP unavailable (%s); skipping embedding encode", e)

    def _augmentations(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Equal-length variations (V, C, T'): ``num_time_offset_augmentations``
        offsets of up to 8 hops into a shared window, then each mirrored
        left/right for stereo."""
        enc = self.enc
        hop = getattr(self.fmt.config, "ms_hop_length",
                      getattr(self.fmt.config, "hop_length", 256))
        n = max(enc.num_time_offset_augmentations, 1)
        max_off = 8 * hop * (n - 1) // n
        t_out = audio.shape[-1] - max_off
        outs = []
        for i in range(n):
            off = 8 * hop * i // n
            outs.append(audio[..., off: off + t_out])
        if enc.stereo_mirror_augmentation and audio.shape[0] == 2:
            outs += [a[::-1] for a in list(outs)]
        return np.stack(outs)

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_latents(self, augs: np.ndarray, stats: Dict[str, Any]) -> np.ndarray:
        """(V, C, T') variations -> float16 (V x formats, C_lat, H, W) latents;
        the mel one variation at a time (its STFT frames are the stage's
        largest buffers), each format's variations encoded as one batch."""
        import torch

        from ..models.dae import tiled_encode, tiled_encode_plan
        x = torch.from_numpy(np.ascontiguousarray(augs)).to(self.device)
        out = []
        for fmt in self.formats:
            t0 = time.perf_counter()
            mel = torch.cat([fmt.raw_to_mel_spec(x[i:i + 1]) for i in range(x.shape[0])])
            self._sync()
            t1 = time.perf_counter()
            stats["mel_s"] = stats.get("mel_s", 0.0) + t1 - t0
            if self.dae is None:
                lat = mel
            else:
                ds = self.dae.downsample_ratio
                mel = mel[:, :, : mel.shape[2] // ds * ds]
                stats["chunks"] = len(tiled_encode_plan(mel.shape[2], ds, self.enc.max_chunk,
                                                        self.enc.overlap))
                lat = tiled_encode(self.dae, mel, None, self.enc.max_chunk, self.enc.overlap)
            out.append(lat.to(torch.float16).permute(0, 3, 1, 2).cpu().numpy())
            stats["dae_s"] = stats.get("dae_s", 0.0) + time.perf_counter() - t1
        return np.concatenate(out, axis=0)

    def process(self, item: Dict[str, Any]):
        t0 = time.perf_counter()
        audio, sr = item["audio"], item["sample_rate"]
        stats = dict(item.get("stats", {}))
        latents = self.encode_latents(self._augmentations(audio, sr), stats)
        out: Dict[str, np.ndarray] = {"latents": latents}
        if self.clap is not None:
            t1 = time.perf_counter()
            out["clap_audio_embeddings"] = self.clap.encode_audio(audio, sr)
            stats["clap_s"] = time.perf_counter() - t1
        stats.update(encode_s=time.perf_counter() - t0, audio_s=audio.shape[-1] / sr)
        return {"path": item["path"], "tensors": out, "stats": stats}

    def finish_process(self) -> None:
        import torch

        from ..ops.kernels import launch_counts
        peak = (torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda"
                else 0)
        logger.info("encode worker on %s: peak device memory %d bytes; kernel launches %s",
                    self.device, peak, json.dumps(launch_counts()))


class EncodeSaveStage(DatasetProcessStage):
    """io: copy-on-write safetensors save that keeps the keys an existing
    file holds and the new latents do not (reference: encode.py:368-398);
    logs each song's stage seconds as one JSON object."""
    stage_type = "io"

    def __init__(self, encode_config: EncodeConfig) -> None:
        self.enc = encode_config

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: Dict[str, Any]):
        t0 = time.perf_counter()
        out_path = _latents_path(self.enc, self.config.dataset_path, item["path"])
        if not self.config.test_mode:
            tensors = dict(item["tensors"])
            if out_path.exists():  # merge-preserve existing keys
                for k, v in load_safetensors(out_path).items():
                    tensors.setdefault(k, v)
            save_safetensors(tensors, out_path)
        lat = item["tensors"]["latents"]
        try:  # dataset-relative paths, for portability
            rel_out = str(out_path.relative_to(self.config.dataset_path))
        except ValueError:
            rel_out = str(out_path)
        write_sidecar(item["path"], {
            "latents_file_name": rel_out,
            "latents_length": int(lat.shape[-1]),
            "latents_num_variations": int(lat.shape[0]),
            "latents_has_audio_embeddings": "clap_audio_embeddings" in item["tensors"],
            "latents_has_text_embeddings": "clap_text_embeddings" in item["tensors"],
        }, self.config.test_mode)
        stats = dict(item.get("stats", {}), save_s=time.perf_counter() - t0,
                     shape=list(lat.shape))
        logger.info("encoded %s: %s", item["path"], json.dumps(stats))
        return item["path"]


def _latents_path(enc: EncodeConfig, dataset_path: str, audio_path: str) -> Path:
    """<dataset>/<latents_dir>/<the audio path under the dataset, with the
    suffix .safetensors>; an audio file outside the dataset keeps its name."""
    audio_path = Path(audio_path)
    try:
        rel = audio_path.resolve().relative_to(Path(dataset_path).resolve())
    except ValueError:
        rel = Path(audio_path.name)
    return Path(dataset_path) / enc.latents_dir / rel.with_suffix(".safetensors")


# ---------------------------------------------------------------------------
# label / dedupe / splits / emb db / integrity
# ---------------------------------------------------------------------------

def _mean_audio_embedding(dataset_path: str, item: str, dtype=np.float32) -> Optional[np.ndarray]:
    """The mean of the song's ``clap_audio_embeddings``; None without them."""
    lat_file = latents_file(dataset_path, read_sidecar(item))
    if lat_file is None:
        return None
    tensors = load_safetensors(lat_file)
    if "clap_audio_embeddings" not in tensors:
        return None
    return np.asarray(tensors["clap_audio_embeddings"], dtype).mean(axis=0)


class LabelStage(DatasetProcessStage):
    """CLAP text-label cosine scores (reference: processes/label.py:28-70):
    the mean audio embedding against each label's text embedding, written
    into the sidecar for dataset cleaning."""
    stage_type = "cpu"

    def __init__(self, label_embeddings: Dict[str, np.ndarray]) -> None:
        self.labels = {k: np.asarray(v, np.float32) for k, v in label_embeddings.items()}

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: str):
        emb = _mean_audio_embedding(self.config.dataset_path, item)
        if emb is None:
            return None
        emb = emb / (np.linalg.norm(emb) + 1e-8)
        scores = {}
        for name, v in self.labels.items():
            vn = v / (np.linalg.norm(v) + 1e-8)
            scores[name] = float(emb @ vn)
        write_sidecar(item, {"label_scores": scores}, self.config.test_mode)
        return item


class DedupeStage(DatasetProcessStage):
    """Duplicate detection against an embedding database (reference:
    processes/dedupe.py:100-145)."""
    stage_type = "cpu"

    def __init__(self, emb_db_path: str, threshold: float = 0.97) -> None:
        self.emb_db_path = emb_db_path
        self.threshold = threshold

    def start_process(self, config, worker_index):
        self.config = config
        self.db: Dict[str, np.ndarray] = {}
        if Path(self.emb_db_path).is_file():
            self.db = {k: np.asarray(v, np.float32)
                       for k, v in load_safetensors(self.emb_db_path).items()}

    def process(self, item: str):
        emb = _mean_audio_embedding(self.config.dataset_path, item)
        if emb is None:
            return None
        emb = emb / (np.linalg.norm(emb) + 1e-8)
        dups = []
        for name, v in self.db.items():
            if name == item:
                continue
            sim = float(emb @ (v / (np.linalg.norm(v) + 1e-8)))
            if sim >= self.threshold:
                dups.append({"file": name, "similarity": sim})
        if dups:
            logger.warning("%s: %d likely duplicates (best %.3f)", item, len(dups),
                           max(d["similarity"] for d in dups))
        write_sidecar(item, {"duplicates": dups}, self.config.test_mode)
        return item


class BuildSplitsStage(DatasetProcessStage):
    """Train/validation jsonl records (reference:
    processes/build_splits.py:42-191); ``write_jsonl`` writes the collected
    records afterwards.

    Per-file curation metadata (rating / system / game / song / prompt)
    comes from the audio file's native tags when it is FLAC, else from the
    JSON sidecar (build_splits.py:216-231). Ratings route records as the
    reference does (build_splits.py:79-94): rating <= 1 -> only
    ``<split>_negative``; 2 -> the base split; >= 3 -> the base split and
    ``<split>_positive``.
    """
    stage_type = "io"

    def __init__(self, validation_fraction: float = 0.02, seed: int = 42) -> None:
        self.validation_fraction = validation_fraction
        self.seed = seed
        self.records: List[Dict[str, Any]] = []

    def start_process(self, config, worker_index):
        self.config = config
        self.records = []

    def process(self, item: str):
        from ..utils.audio_metadata import get_audio_metadata
        meta = read_sidecar(item)
        try:
            tags = {k.lower(): v[0] for k, v in get_audio_metadata(item).items() if v}
        except Exception:
            tags = {}
        try:
            audio, sr = load_audio(item, return_sample_rate=True)
            length = audio.shape[-1]
        except Exception:
            return None
        rating: Optional[int] = None
        raw_rating = tags.get("rating", meta.get("rating"))
        if raw_rating is not None:
            try:
                rating = int(raw_rating)
            except (TypeError, ValueError):
                logger.warning("invalid rating %r in %s", raw_rating, item)
        return {"file_name": item, "sample_rate": sr, "sample_length": length,
                "rating": rating,
                "system": tags.get("system", meta.get("system")),
                "game": tags.get("game", meta.get("game")),
                "song": tags.get("song", meta.get("song")),
                "prompt": tags.get("prompt", meta.get("prompt")),
                "post_norm_lufs": meta.get("post_norm_lufs"),
                "latents_file_name": meta.get("latents_file_name"),
                "latents_length": meta.get("latents_length"),
                "latents_num_variations": meta.get("latents_num_variations"),
                "latents_has_audio_embeddings": meta.get("latents_has_audio_embeddings", False),
                "latents_has_text_embeddings": meta.get("latents_has_text_embeddings", False)}

    @staticmethod
    def route_splits(base_split: str, rating: Optional[int]) -> List[str]:
        """Rating -> split names (reference: build_splits.py:79-94)."""
        if rating is None or rating == 2:
            return [base_split]
        if rating <= 1:
            return [f"{base_split}_negative"]
        return [base_split, f"{base_split}_positive"]

    @staticmethod
    def write_jsonl(records: List[Dict[str, Any]], dataset_path: str,
                    validation_fraction: float = 0.02, seed: int = 42) -> None:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(records))
        n_val = int(len(records) * validation_fraction)
        val_idx = set(order[:n_val].tolist())
        splits: Dict[str, List[Dict[str, Any]]] = {"train": [], "validation": []}
        for i, rec in enumerate(records):
            base = "validation" if i in val_idx else "train"
            for split in BuildSplitsStage.route_splits(base, rec.get("rating")):
                splits.setdefault(split, []).append(rec)
        for split, recs in splits.items():
            with open(Path(dataset_path) / f"{split}.jsonl", "w") as fh:
                for rec in recs:
                    fh.write(json.dumps(rec) + "\n")


class BuildEmbDBStage(DatasetProcessStage):
    """Per-file mean embeddings for a database (reference:
    processes/build_emb_db.py)."""
    stage_type = "io"

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: str):
        emb = _mean_audio_embedding(self.config.dataset_path, item)
        return None if emb is None else {"file": item, "embedding": emb}

    @staticmethod
    def write_db(entries: List[Dict[str, Any]], db_path: str) -> None:
        save_safetensors({e["file"]: e["embedding"].astype(np.float16) for e in entries},
                         db_path)


class AggregateEmbeddingsStage(DatasetProcessStage):
    """Per-label mean audio/text CLAP embeddings and the dataset-wide
    ``_unconditional_audio`` / ``_unconditional_text`` means, written to
    ``dataset_embeddings.safetensors``: the table
    ``Pipeline.get_prompt_embedding`` reads (reference:
    src/dataset/dataset_processor.py ~:800-832, read at
    dual_diffusion_pipeline.py:399-420). The label is the sidecar's
    ``label``, else the audio file's parent directory name."""
    stage_type = "io"

    def start_process(self, config, worker_index):
        self.config = config

    def process(self, item: str):
        meta = read_sidecar(item)
        lat_file = latents_file(self.config.dataset_path, meta)
        if lat_file is None:
            return None
        tensors = load_safetensors(lat_file)
        out: Dict[str, Any] = {"label": meta.get("label") or Path(item).parent.name}
        if "clap_audio_embeddings" in tensors:
            out["audio"] = np.asarray(tensors["clap_audio_embeddings"], np.float64).mean(axis=0)
        if "clap_text_embeddings" in tensors:
            out["text"] = np.asarray(tensors["clap_text_embeddings"], np.float64).mean(axis=0)
        return out if len(out) > 1 else None

    @staticmethod
    def write_db(entries: List[Dict[str, Any]], db_path: str) -> None:
        """The mean per label and the dataset mean, each at unit norm (the
        reference's normalize() of each aggregate)."""
        sums: Dict[str, np.ndarray] = {}
        counts: Dict[str, int] = {}

        def add(key: str, v: np.ndarray) -> None:
            sums[key] = sums.get(key, 0.0) + v
            counts[key] = counts.get(key, 0) + 1

        for e in entries:
            if e.get("audio") is not None:
                add("_unconditional_audio", e["audio"])
                add(f"{e['label']}_audio", e["audio"])
            if e.get("text") is not None:
                add("_unconditional_text", e["text"])
                add(f"{e['label']}_text", e["text"])
        table = {}
        for k, s in sums.items():
            mean = s / counts[k]
            table[k] = (mean / (np.linalg.norm(mean) + 1e-12)).astype(np.float32)
        save_safetensors(table, db_path)


class IntegrityCheckStage(DatasetProcessStage):
    """Check that audio files decode to finite samples (reference:
    processes/integrity_check.py)."""
    stage_type = "cpu"

    def start_process(self, config, worker_index):
        self.config = config
        self.bad = 0

    def process(self, item: str):
        try:
            audio, sr = load_audio(item, return_sample_rate=True)
            if not (audio.size > 0 and np.isfinite(audio).all()):
                raise ValueError("empty or non-finite audio")
        except Exception as e:
            logger.error("integrity failure %s: %s", item, e)
            self.bad += 1
            return None
        return item
