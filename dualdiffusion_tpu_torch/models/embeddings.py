# Helpers and the CLAP wrapper copied from dualdiffusion_tpu/models/embeddings.py:62-210.
"""Conditioning embeddings: the dual-CLAP audio/text encoder and the numpy
analysis helpers (reference: src/modules/embeddings/embedding.py:40-93,
src/modules/embeddings/clap.py:54-122).

CLAP runs two models (HF ``laion/larger_clap_music`` and, where the
reference loads a ``laion_clap`` HTSAT-base checkpoint, the HF
``laion/clap-htsat-unfused`` release of that architecture), each output
mp-normalized (unit RMS per element, L2 norm sqrt(512)) and concatenated to
1024 dims; audio is downmixed to mono, resampled to 48 kHz by linear
interpolation and cut into 10 s chunks, the partial tail dropped.

The weights are never in the repository. The encoder loads them only from
``CLAP_MODEL_PATH`` (one subdirectory per model, named after the model's
last path element), through ``transformers`` with ``local_files_only``
unless ``CLAP_ALLOW_DOWNLOAD=1``; without them, or without
``transformers``, it raises ``RuntimeError``. The dataset factory then
skips embeddings with a warning, as the JAX package does. Loaded models run
on the device they are given (the card by default).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class CLAPConfig:
    """Field names and defaults of the JAX CLAPConfig."""
    model_paths: Tuple[str, ...] = ("laion/larger_clap_music", "laion/clap-htsat-unfused")
    sample_rate: int = 48000
    audio_embedding_duration: float = 10.0   # seconds per chunk
    embedding_dim: int = 512                 # per model


# ---------------------------------------------------------------------------
# analysis helpers (reference: embedding.py:40-93)
# ---------------------------------------------------------------------------

def top_pca_components(embeddings: np.ndarray, k: int = 8) -> np.ndarray:
    """(N, D) -> (k, D) principal directions (each up to its sign)."""
    x = embeddings - embeddings.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return vt[:k]


def cosine_similarity_matrix(a: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    b = a if b is None else b
    an = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-8)
    bn = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-8)
    return an @ bn.T


def dedupe_embeddings(embeddings: np.ndarray, threshold: float = 0.99,
                      window: int = 1) -> np.ndarray:
    """Indices of the rows that are no duplicate (cosine similarity below
    ``threshold``) of an earlier kept row; ``window`` > 1 first smooths each
    column with a moving average of that many rows."""
    e = embeddings
    if window > 1:
        kernel = np.ones(window) / window
        e = np.stack([np.convolve(row, kernel, mode="same") for row in e.T]).T
    sim = cosine_similarity_matrix(e)
    keep: List[int] = []
    for i in range(len(e)):
        if all(sim[i, j] < threshold for j in keep):
            keep.append(i)
    return np.asarray(keep, np.int64)


def mp_normalize(x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Magnitude-preserving normalize over the last dim (reference
    mp_tools.py:42-49): unit RMS per element, so the L2 norm is sqrt(D)."""
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / (eps + norm / np.sqrt(x.shape[-1]))).astype(x.dtype)


# ---------------------------------------------------------------------------
# CLAP encoder (gated on local weights)
# ---------------------------------------------------------------------------

class CLAPEmbedding:
    """Dual-CLAP encoder producing concatenated mp-normalized embeddings."""

    def __init__(self, config: Optional[CLAPConfig] = None, device="cuda") -> None:
        self.config = config or CLAPConfig()
        self.device = device
        self._models = None

    @property
    def output_dim(self) -> int:
        return self.config.embedding_dim * len(self.config.model_paths)

    def _load(self) -> None:
        if self._models is not None:
            return
        allow_download = os.environ.get("CLAP_ALLOW_DOWNLOAD", "0") == "1"
        local_root = os.environ.get("CLAP_MODEL_PATH")
        if not local_root and not allow_download:
            raise RuntimeError(
                "CLAP weights unavailable: set CLAP_MODEL_PATH to a directory with the "
                "checkpoints, or rely on precomputed dataset embeddings (the default "
                "training path).")
        try:
            from transformers import ClapModel, ClapProcessor
        except ImportError as e:
            raise RuntimeError("transformers is required for CLAP encoding") from e
        models = []
        for path in self.config.model_paths:
            load_path = os.path.join(local_root, os.path.basename(path)) if local_root else path
            if local_root and not os.path.isdir(load_path):
                raise RuntimeError(f"CLAP weights unavailable at '{load_path}'")
            try:
                model = ClapModel.from_pretrained(load_path, local_files_only=not allow_download)
                proc = ClapProcessor.from_pretrained(load_path,
                                                     local_files_only=not allow_download)
            except (OSError, ValueError) as e:
                raise RuntimeError(f"CLAP weights unavailable at '{load_path}'") from e
            models.append((model.to(self.device).eval(), proc))
        self._models = models

    def _chunk_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Mono mix, linear resample to 48 kHz, (chunks, 10 s) with the
        partial tail dropped (reference: clap.py:83-110)."""
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        if sample_rate != self.config.sample_rate:
            n_out = int(round(len(audio) * self.config.sample_rate / sample_rate))
            audio = np.interp(np.linspace(0, len(audio) - 1, n_out),
                              np.arange(len(audio)), audio)
        chunk = int(self.config.audio_embedding_duration * self.config.sample_rate)
        if len(audio) < chunk:
            raise ValueError(f"cannot encode audio embedding, audio too short "
                             f"(len: {len(audio)} < chunk {chunk})")
        n_chunks = len(audio) // chunk
        return audio[:n_chunks * chunk].reshape(n_chunks, chunk).astype(np.float32)

    def encode_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """(C, T) or (T,) audio -> (num_chunks, output_dim) embeddings."""
        import torch
        self._load()
        chunks = self._chunk_audio(audio, sample_rate)
        outs = []
        for model, proc in self._models:
            inputs = proc(audios=list(chunks), sampling_rate=self.config.sample_rate,
                          return_tensors="pt")
            with torch.no_grad():
                feats = model.get_audio_features(**_to_device(inputs, model))
            outs.append(mp_normalize(feats.float().cpu().numpy()))
        return np.concatenate(outs, axis=-1)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """list[str] -> (N, output_dim) embeddings."""
        import torch
        self._load()
        outs = []
        for model, proc in self._models:
            inputs = proc(text=list(texts), return_tensors="pt", padding=True)
            with torch.no_grad():
                feats = model.get_text_features(**_to_device(inputs, model))
            outs.append(mp_normalize(feats.float().cpu().numpy()))
        return np.concatenate(outs, axis=-1)


def _to_device(inputs, model) -> dict:
    """The processor's tensors on the model's device (models without a
    ``device`` attribute take them where they are)."""
    device = getattr(model, "device", None)
    return {k: (v.to(device) if device is not None and hasattr(v, "to") else v)
            for k, v in dict(inputs).items()}
