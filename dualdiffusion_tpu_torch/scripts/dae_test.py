"""DAE round-trip harness (JAX: scripts/dae_test.py; reference:
src/tests/dae.py): a clip's mel through the model's DAE and back, the
relative reconstruction error and latent statistics printed, and the input,
the reconstruction, both mels and the latents' top principal components
written.

Usage: python -m dualdiffusion_tpu_torch.scripts.dae_test --model_path <dir>
       [--audio in.wav] [--seconds 4] [--output_path dae_test_out] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..models.dae import top_pca_components
from ..pipelines import Pipeline
from ..utils import load_audio, save_audio, save_img, tensor_to_img
from . import print_launches, resolve_device, synth_audio


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Returns the relative mel reconstruction MSE."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--audio", default=None, help="input wav (default: synth)")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--output_path", default="dae_test_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pipe = Pipeline.from_pretrained(args.model_path, device=device)
    fmt = pipe.format
    dae = pipe.modules["dae"].module
    sr = fmt.config.sample_rate
    audio = (load_audio(args.audio)[None] if args.audio
             else synth_audio(args.seconds, sr, (147.0, 220.0, 440.0, 1760.0), 200))
    out = Path(args.output_path)
    out.mkdir(parents=True, exist_ok=True)

    with torch.no_grad():
        mel = fmt.raw_to_mel_spec(torch.from_numpy(audio).to(device))
        ds = dae.downsample_ratio
        mel = mel[:, :, : mel.shape[2] // ds * ds]
        latents = dae.encode(mel)
        recon = dae.decode(latents)
        mse = float(((recon - mel) ** 2).mean())
        scale = float((mel ** 2).mean())
        print(f"mel {tuple(mel.shape)} -> latents {tuple(latents.shape)}")
        print(f"relative mel recon MSE: {mse / scale:.5f}")
        print(f"latent stats: mean {float(latents.mean()):+.4f} "
              f"std {float(latents.std(correction=0)):.4f}")
        wav = fmt.sample_to_raw(recon.float()).float().cpu().numpy()
        pca = top_pca_components(latents, n_pca=3)

    save_audio(audio[0], sr, out / "input.wav")
    if wav.ndim == 3:
        save_audio(wav[0, :, :audio.shape[-1]], sr, out / "recon.wav")
    save_img(tensor_to_img(mel[0].cpu().numpy()), out / "mel.png")
    save_img(tensor_to_img(recon[0].float().cpu().numpy()), out / "mel_recon.png")
    save_img(tensor_to_img(pca[0].cpu().numpy()), out / "latents_pca.png")
    print(f"wrote {out}/: input.wav recon.wav mel.png mel_recon.png latents_pca.png")
    print_launches()
    return mse / scale


if __name__ == "__main__":
    main()
