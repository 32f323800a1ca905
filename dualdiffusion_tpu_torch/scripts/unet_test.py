"""Config-driven end-to-end UNet sampling harness (JAX: scripts/unet_test.py;
reference: src/tests/unet.py:47-110): load a model, generate a clip per
prompt and seed, print latent statistics and timings, and write audio, the
mel image, the latents' principal components and a JSON sidecar of the
sampler params under ``<model>/output/step_<N>/``.

Usage: python -m dualdiffusion_tpu_torch.scripts.unet_test --model_path <dir>
       [--config configs/tests/unet_test.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.dae import top_pca_components
from ..pipelines import Pipeline
from ..sampling import SampleParams
from ..utils import load_json, normalize_lufs, save_audio, save_img, tensor_to_img
from . import print_launches, resolve_device


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Returns each clip's sidecar record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--config", default="configs/tests/unet_test.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_json(args.config) if Path(args.config).is_file() else {}
    pipe = Pipeline.from_pretrained(args.model_path, device=device,
                                    **cfg.get("model_load_options", {}))
    sr = pipe.format.config.sample_rate
    step = 0
    unet_json = Path(args.model_path) / "unet" / "unet.json"
    if unet_json.is_file():
        step = load_json(unet_json).get("__last_global_step__", 0)
    out_dir = Path(args.model_path) / "output" / f"step_{step}"
    out_dir.mkdir(parents=True, exist_ok=True)

    params = SampleParams(**cfg.get("unet_params", {}))
    seeds = cfg.get("seeds") or [params.seed or 4000]
    prompts = cfg.get("prompts") or [None]
    decode_mode = cfg.get("decode_mode", "auto")
    output_lufs = cfg.get("output_lufs", -20.0)

    records, lat_means, lat_stds = [], [], []
    for prompt in prompts:
        emb = pipe.get_prompt_embedding(prompt) if prompt else None
        for seed in seeds:
            t0 = time.time()
            gen = torch.Generator(device=device).manual_seed(int(seed))
            res = pipe.generate(params, gen, prompt_embedding=emb, decode_mode=decode_mode)
            raw = res["raw"].float().cpu().numpy()
            dt = time.time() - t0
            # a pipeline without a DAE samples the format's own sample
            lat = res["latents"] if res["latents"] is not None else res["sample"]
            lat_means.append(float(lat.mean()))
            lat_stds.append(float(lat.std(correction=0)))
            tag = f"s{seed}" + (f"_{'_'.join(prompt)}" if prompt else "")
            tag = "".join(c if c.isalnum() or c in "._-" else "_" for c in tag)[:80]
            audio = np.asarray(normalize_lufs(raw[0], sr, output_lufs))
            save_audio(audio, sr, out_dir / f"{tag}.flac")
            save_img(tensor_to_img(res["sample"][0].float().cpu().numpy()),
                     out_dir / f"{tag}_mel.png")
            save_img(tensor_to_img(top_pca_components(lat.float(), n_pca=3)[0].cpu().numpy()),
                     out_dir / f"{tag}_latents.png")
            record = {"seed": int(seed), "prompt": prompt, "decode_mode": decode_mode,
                      "seconds": round(dt, 2), "latents_mean": lat_means[-1],
                      "latents_std": lat_stds[-1],
                      "params": {k: v for k, v in params.__dict__.items()
                                 if not k.startswith("_")}}
            with open(out_dir / f"{tag}.json", "w") as f:
                json.dump(record, f, indent=2, default=str)
            records.append(record)
            print(f"{tag}: {dt:.1f}s latents mean {lat_means[-1]:+.4f} "
                  f"std {lat_stds[-1]:.4f} -> {out_dir / tag}.flac")

    print(f"avg latents mean {np.mean(lat_means):+.4f} std {np.mean(lat_stds):.4f}; "
          f"wrote {out_dir}/")
    print_launches()
    return records


if __name__ == "__main__":
    main()
