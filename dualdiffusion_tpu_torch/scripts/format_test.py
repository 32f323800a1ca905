"""Config-driven format invertibility harness (JAX: scripts/format_test.py;
reference: src/modules/formats/ms_mdct_dual_2.py:308-381): encode a clip,
decode it, print the mel-domain error of the round trip, and write the input,
the reconstruction and the sample image for listening.

Usage: python -m dualdiffusion_tpu_torch.scripts.format_test
       [--config configs/tests/format_test.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..models.formats import get_format_class
from ..utils import load_audio, load_json, save_audio, save_img, tensor_to_img
from . import print_launches, resolve_device, synth_audio


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Returns the relative mel-domain MSE of the round trip."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/tests/format_test.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_json(args.config)
    fmt_cls, fmt_cfg_cls = get_format_class(cfg["format"])
    fmt = fmt_cls(fmt_cfg_cls(**cfg.get("format_config", {})))
    sr = fmt.config.sample_rate
    if cfg.get("audio_path"):
        audio = load_audio(cfg["audio_path"])[None]
    else:   # a tone stack and noise, as the JAX harness synthesizes it
        audio = synth_audio(cfg.get("audio_seconds", 4.0), sr,
                            (110.0, 220.0, 330.0, 441.0, 880.0), 160, noise=0.02)
    out = Path(cfg.get("output_path", "format_test_out"))
    out.mkdir(parents=True, exist_ok=True)

    with torch.no_grad():
        x = torch.from_numpy(audio).to(device)
        sample = fmt.raw_to_sample(x)
        recon = fmt.sample_to_raw(sample)
        print(f"sample shape {tuple(sample.shape)}  recon shape {tuple(recon.shape)}")
        sample2 = fmt.raw_to_sample(recon[..., :audio.shape[-1]])
        n = min(sample.shape[2], sample2.shape[2])
        mse = float(((sample[:, :, :n] - sample2[:, :, :n]) ** 2).mean())
        scale = float((sample ** 2).mean())
    print(f"relative mel-domain MSE after roundtrip: {mse / scale:.5f}")

    recon = recon.float().cpu().numpy()
    save_audio(audio[0], sr, out / "input.wav")
    save_audio(recon[0, :, :audio.shape[-1]], sr, out / "recon.wav")
    save_img(tensor_to_img(sample[0].float().cpu().numpy()), out / "sample.png")
    print(f"wrote {out}/input.wav recon.wav sample.png")
    print_launches()
    return mse / scale


if __name__ == "__main__":
    main()
