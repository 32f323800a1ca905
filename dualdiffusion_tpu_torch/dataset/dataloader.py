# Copied from dualdiffusion_tpu/dataset/dataloader.py, its latent slice spelled without an Ellipsis.
"""Training dataloader: jsonl splits + safetensors slices.

Capability parity with the reference's DualDiffusionDataset
(reference: src/training/dataset.py:76-255) without the HF-datasets
dependency on the hot path:

  * per-split ``<split>.jsonl`` sample records with validity filtering
    (post-norm LUFS, latents length/variations, embeddings present;
    reference :126-155).
  * on-the-fly transform: a random ``raw_crop_width`` crop of the audio
    (WAV); random latent variation + random time crop read as
    a safetensors SLICE (no full-file load); CLAP audio-embedding window
    average with spherical (mp_sum+normalize) endpoint interpolation
    (reference :192-236); text-embedding mean.
  * per-host sharding (each process loads ``process_index::process_count``)
    and background prefetch.

Batches are plain dicts of numpy arrays plus a "paths" list for the
per-sample loss observability channel.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..utils.utils import load_audio

logger = logging.getLogger(__name__)


@dataclass
class DatasetConfig:
    data_dir: str = ""
    load_splits: Sequence[str] = ("train",)
    load_datatypes: Sequence[str] = ("latents", "audio_embeddings")
    filter_invalid_samples: bool = True
    filter_unnormalized_samples: bool = False
    latents_crop_width: int = 688
    raw_crop_width: int = 1408768
    sample_rate: int = 32000
    num_raw_channels: int = 2
    audio_embedding_duration: float = 10.0  # CLAP chunk seconds


def _mp_sum(a, b, t):
    return (a + (b - a) * t) / np.sqrt((1 - t) ** 2 + t ** 2)


class DualDiffusionDataset:
    """jsonl-backed dataset with reference-equivalent transforms."""

    def __init__(self, config: DatasetConfig, rng: Optional[np.random.Generator] = None,
                 process_index: int = 0, process_count: int = 1) -> None:
        self.config = config
        self.rng = rng or np.random.default_rng()
        self.splits: Dict[str, List[dict]] = {}
        self.num_filtered_samples: Dict[str, int] = {}
        for split in config.load_splits:
            path = Path(config.data_dir) / f"{split}.jsonl"
            if not path.is_file():
                logger.warning("missing split file %s", path)
                self.splits[split] = []
                continue
            samples = [json.loads(l) for l in path.read_text().splitlines() if l.strip()]
            n_before = len(samples)
            if config.filter_invalid_samples:
                samples = [s for s in samples if self._is_valid(s)]
            self.num_filtered_samples[split] = n_before - len(samples)
            # per-host shard
            self.splits[split] = samples[process_index::process_count]

    def _abs(self, rel: Optional[str]) -> Optional[str]:
        if not rel:
            return None
        p = Path(rel)
        if p.is_absolute():
            return str(p)
        joined = Path(self.config.data_dir) / p
        if joined.exists():
            return str(joined)
        # records written with paths already rooted at/under the cwd
        return str(p) if p.exists() else str(joined)

    def _is_valid(self, s: dict) -> bool:
        cfg = self.config
        dt = cfg.load_datatypes
        if cfg.filter_unnormalized_samples and s.get("post_norm_lufs") is None:
            return False
        if "audio_embeddings" in dt:
            if not s.get("latents_has_audio_embeddings") or not s.get("latents_file_name"):
                return False
        if "text_embeddings" in dt:
            if not s.get("latents_has_text_embeddings") or not s.get("latents_file_name"):
                return False
        if "latents" in dt:
            if (s.get("latents_length") or 0) < cfg.latents_crop_width:
                return False
            if not s.get("latents_file_name") or not s.get("latents_num_variations"):
                return False
        if "audio" in dt:
            if not s.get("file_name"):
                return False
            if (s.get("sample_length") or 0) < cfg.raw_crop_width:
                return False
            if s.get("sample_rate") != cfg.sample_rate:
                return False
        return True

    def __len__(self) -> int:
        return sum(len(v) for v in self.splits.values())

    # ---- per-sample transform -------------------------------------------
    def load_sample(self, record: dict) -> Dict[str, Any]:
        cfg = self.config
        out: Dict[str, Any] = {"path": record.get("file_name") or
                               record.get("latents_file_name")}
        latents_t_offset = None

        if "audio" in cfg.load_datatypes:
            total = record["sample_length"]
            start = int(self.rng.integers(0, max(total - cfg.raw_crop_width, 0) + 1))
            audio = load_audio(self._abs(record["file_name"]), start=start,
                               count=cfg.raw_crop_width)
            if audio.shape[0] < cfg.num_raw_channels:
                audio = np.tile(audio, (cfg.num_raw_channels // audio.shape[0], 1))
            elif audio.shape[0] > cfg.num_raw_channels:
                audio = audio.mean(axis=0, keepdims=True)
            out["audio"] = audio.astype(np.float32)

        lat_file = self._abs(record.get("latents_file_name"))
        if "latents" in cfg.load_datatypes:
            from safetensors import safe_open
            with safe_open(lat_file, framework="numpy") as f:
                sl = f.get_slice("latents")
                shape = sl.get_shape()
                idx = int(self.rng.integers(0, shape[0]))
                t0 = int(self.rng.integers(0, shape[-1] - cfg.latents_crop_width + 1))
                latents_t_offset = t0
                # explicit slices: some safetensors versions take no Ellipsis
                crop = ((idx,) + (slice(None),) * (len(shape) - 2)
                        + (slice(t0, t0 + cfg.latents_crop_width),))
                out["latents"] = np.asarray(sl[crop], np.float32)

        if "audio_embeddings" in cfg.load_datatypes:
            from safetensors import safe_open
            with safe_open(lat_file, framework="numpy") as f:
                sl = f.get_slice("clap_audio_embeddings")
                emb_len = sl.get_shape()[0]
                dur = cfg.audio_embedding_duration
                if latents_t_offset is not None:
                    spl = cfg.raw_crop_width / cfg.sample_rate / cfg.latents_crop_width
                    e0 = latents_t_offset * spl / dur
                    e1 = (latents_t_offset + cfg.latents_crop_width) * spl / dur
                else:
                    e0, e1 = 0.0, emb_len + 1.0
                start = float(np.clip(e0 - 0.5, 0, emb_len - 1))
                end = float(np.clip(e1 - 0.5, start, emb_len - 1))
                si, sf = int(start), start % 1.0
                ei, ef = int(end), end % 1.0
                selected = np.asarray(sl[si: ei + 1], np.float32)
                if sf > 0 and si + 1 < emb_len:
                    selected[0] = _unit(_mp_sum(np.asarray(sl[si], np.float32),
                                                np.asarray(sl[si + 1], np.float32), sf))
                if ef > 0 and ei + 1 < emb_len:
                    selected[-1] = _unit(_mp_sum(np.asarray(sl[ei], np.float32),
                                                 np.asarray(sl[ei + 1], np.float32), ef))
                out["audio_embeddings"] = _unit(selected.sum(axis=0))

        if "text_embeddings" in cfg.load_datatypes:
            from safetensors import safe_open
            with safe_open(lat_file, framework="numpy") as f:
                te = np.asarray(f.get_slice("clap_text_embeddings")[:], np.float32)
            out["text_embeddings"] = te.mean(axis=0)
        return out

    # ---- batching -------------------------------------------------------
    def iter_batches(self, split: str, batch_size: int, shuffle: bool = True,
                     drop_last: bool = True, seed: Optional[int] = None,
                     prefetch: int = 2,
                     skip_batches: int = 0) -> Iterator[Dict[str, Any]]:
        """``skip_batches``: fast-forward past the first N batches of this
        epoch WITHOUT loading their samples — mid-epoch resume (reference:
        trainer.py:908-916,933 accelerate skip_first_batches). The shuffle
        order is drawn first so the remaining sequence is identical to an
        uninterrupted epoch's."""
        samples = self.splits[split]
        order = np.arange(len(samples))
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(order)

        def gen():
            start = skip_batches * batch_size
            for i in range(start,
                           len(order) - (batch_size - 1 if drop_last else 0),
                           batch_size):
                idxs = order[i: i + batch_size]
                if len(idxs) < batch_size and drop_last:
                    return
                items = [self.load_sample(samples[j]) for j in idxs]
                batch: Dict[str, Any] = {"paths": [it.pop("path") for it in items]}
                for k in items[0]:
                    batch[k] = np.stack([it[k] for it in items])
                yield batch

        if prefetch <= 0:
            yield from gen()
            return
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        SENTINEL = object()
        err: list = []

        def worker():
            try:
                for b in gen():
                    q.put(b)
            except BaseException as e:  # propagate to the consumer
                err.append(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is SENTINEL:
                if err:
                    raise err[0]
                break
            yield b


def _unit(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-8)


def custom_collate(items: List[dict]) -> Dict[str, Any]:
    """Stack a list of sample dicts (reference: dataset.py:43-55)."""
    batch: Dict[str, Any] = {"paths": [it.get("path") for it in items]}
    for k in items[0]:
        if k == "path":
            continue
        batch[k] = np.stack([np.asarray(it[k]) for it in items])
    return batch
