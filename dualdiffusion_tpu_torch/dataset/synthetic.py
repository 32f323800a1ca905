"""A synthetic pre-encoded latent dataset, in the format ``dataloader.py``
reads, for driving the trainer without real data: ``train.jsonl`` plus one
safetensors file per sample holding ``latents`` (variations, C, H, W) and
``clap_audio_embeddings`` (chunks, E), all drawn from a seed."""

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
