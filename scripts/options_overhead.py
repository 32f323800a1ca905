#!/usr/bin/env python3
"""Seconds per sampler step of the reference-scale pipeline on one NVIDIA
GPU: plain sampling against each generation option, in turns.

    python3 scripts/options_overhead.py

Run from the root of a checkout. Builds the reference-scale UNet of
``chip_smoke.py`` (356M parameters, seeded random weights) and a copy of it
with the inpainting inputs (4 + 4 + 1), then runs ``Pipeline.diffusion_decode``
(the latent stage alone, CFG 1.5, Heun) for ``STEPS`` steps in ``ROUNDS``
rounds; each round runs every variant once, in an order that turns round
by round: plain; with ``debug`` (the per-step reductions); with a chunk
callback every 10 steps; after ``torch.cuda.empty_cache()``; img2img at
strength 1; the seamless loop; inpainting (the 9-input UNet with the
reference and mask channels). Prints each variant's milliseconds per step
in every round, and the card's name and power limit. Checks nothing:
``chip_smoke.py`` holds the options to their counts and to the CPU.
"""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import ref_scale_configs  # noqa: E402
from dualdiffusion_tpu_torch.models import DAE, UNet  # noqa: E402
from dualdiffusion_tpu_torch.models.formats import SpectrogramFormat  # noqa: E402
from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline  # noqa: E402
from dualdiffusion_tpu_torch.sampling import SampleParams  # noqa: E402

STEPS = 40
ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("options_overhead: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ucfg, dcfg, fcfg = ref_scale_configs()
    icfg = dataclasses.replace(ucfg, in_channels=ucfg.in_channels + ucfg.out_channels + 1)
    unet = UNet(ucfg, device="cuda").init_weights(gen)
    inp = UNet(icfg, device="cuda").init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
        inp.core.out_gain.fill_(1.0)
    fmt = SpectrogramFormat(fcfg)
    dae = DAE(dcfg, device="cuda").init_weights(gen)
    pipe = Pipeline({"unet": ModuleHandle("unet", "unet", ucfg, unet.eval()),
                     "unet_inpainting": ModuleHandle("unet_inpainting", "unet", icfg, inp.eval()),
                     "dae": ModuleHandle("dae", "dae", dcfg, dae.eval()),
                     "format": ModuleHandle("format", "format:spectrogram", fcfg, fmt)})
    lat_shape = dae.get_latent_shape(fmt.get_sample_shape(1))
    prompt = torch.randn((1, 1024), generator=gen, device="cuda")
    init = torch.randn(lat_shape, generator=gen, device="cuda")
    mask = torch.zeros((1, 1, lat_shape[2], 1), device="cuda")
    mask[..., lat_shape[2] // 4: lat_shape[2] // 2, :] = 1.0
    base = SampleParams(steps=STEPS, cfg_scale=1.5, use_heun=True, img2img_strength=1.0)
    variants = {
        "plain": (base, {}),
        "debug": (base, {"debug": {}}),
        "chunk callback": (base, {"chunk_size": 10, "chunk_callback": lambda n, s: False}),
        "after empty_cache": (base, {}),
        "img2img": (base, {"init_sample": init}),
        "seamless loop": (dataclasses.replace(base, seamless_loop=True), {}),
        "inpainting": (base, {"init_sample": init, "inpainting_mask": mask}),
    }
    print(f"{smi}; latents {lat_shape}, {STEPS} steps a run, {ROUNDS} rounds", flush=True)
    pipe.diffusion_decode(dataclasses.replace(base, steps=2), lat_shape, prompt, gen)  # warm-up
    ms = {k: [] for k in variants}
    names = list(variants)
    for r in range(ROUNDS):
        order = names[r % len(names):] + names[:r % len(names)]
        for name in order:
            params, kw = variants[name]
            if name == "after empty_cache":
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.diffusion_decode(params, lat_shape, prompt, gen, **kw)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / STEPS * 1e3)
    for name, v in ms.items():
        print(f"{name}: ms per step " + ", ".join(f"{x:.2f}" for x in v)
              + f" (median {sorted(v)[len(v) // 2]:.2f})", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
