"""Synthetic datasets, in the format ``dataloader.py`` reads, for driving the
trainers without real data, all drawn from a seed: pre-encoded latents
(``train.jsonl`` plus one safetensors file per sample holding ``latents``
(variations, C, H, W) and ``clap_audio_embeddings`` (chunks, E)), and audio
(``train.jsonl`` plus one WAV file per sample and, for configs that load
``audio_embeddings``, one safetensors file per sample holding
``clap_audio_embeddings``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Union

import numpy as np


def write_latent_dataset(path: Union[str, Path], num_samples: int,
                         latent_shape: Sequence[int], emb_dim: int, seed: int = 0,
                         num_variations: int = 1, emb_chunks: int = 5) -> Path:
    """Write ``num_samples`` unit-variance latents of ``latent_shape``
    (C, H, W) with unit-norm CLAP-like embeddings under ``path``."""
    from safetensors.numpy import save_file
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    records = []
    for i in range(num_samples):
        name = f"sample_{i:05d}.safetensors"
        lat = rng.standard_normal((num_variations, *latent_shape)).astype(np.float32)
        emb = rng.standard_normal((emb_chunks, emb_dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        save_file({"latents": lat, "clap_audio_embeddings": emb}, str(path / name))
        records.append({"file_name": f"sample_{i:05d}.flac", "latents_file_name": name,
                        "latents_length": int(latent_shape[-1]),
                        "latents_num_variations": num_variations,
                        "latents_has_audio_embeddings": True})
    (path / "train.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    return path


def write_audio_dataset(path: Union[str, Path], num_samples: int, channels: int, length: int,
                        sample_rate: int = 32000, seed: int = 0, emb_dim: int = 0,
                        emb_chunks: int = 5) -> Path:
    """Write ``num_samples`` WAV files of ``length`` samples: per sample a few
    random sinusoids with a slow vibrato plus a little noise, the channels
    at different gains, peak 0.5. With ``emb_dim`` > 0 each WAV also gets a
    ``.safetensors`` file of ``emb_chunks`` unit-norm CLAP-like audio
    embeddings, named in its record as its latents file (where the
    dataloader reads ``audio_embeddings``); the embeddings come from a
    generator of their own, so the audio is the same either way."""
    from safetensors.numpy import save_file

    from ..utils.utils import save_audio
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    emb_rng = np.random.default_rng([seed, 1])
    t = np.arange(length) / sample_rate
    records = []
    for i in range(num_samples):
        sig = np.zeros(length)
        for _ in range(4):
            f0 = rng.uniform(60.0, 4000.0)
            vibrato = rng.uniform(0.3, 3.0) * np.sin(2 * np.pi * rng.uniform(0.2, 4.0) * t)
            sig += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f0 * t + vibrato
                                                  + rng.uniform(0, 2 * np.pi))
        sig += 0.05 * rng.standard_normal(length)
        audio = np.stack([sig * rng.uniform(0.5, 1.0) for _ in range(channels)])
        audio = 0.5 * audio / np.abs(audio).max()
        name = f"sample_{i:05d}.wav"
        save_audio(audio, sample_rate, path / name)
        record = {"file_name": name, "sample_length": length, "sample_rate": sample_rate}
        if emb_dim > 0:
            emb = emb_rng.standard_normal((emb_chunks, emb_dim)).astype(np.float32)
            emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
            emb_name = f"sample_{i:05d}.safetensors"
            save_file({"clap_audio_embeddings": emb}, str(path / emb_name))
            record.update(latents_file_name=emb_name, latents_has_audio_embeddings=True)
        records.append(record)
    (path / "train.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    return path
