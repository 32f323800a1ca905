"""The component harnesses, each run as ``python -m
dualdiffusion_tpu_torch.scripts.<name>`` with the flags, configs and output
files of the root ``scripts/<name>.py`` of the JAX package: ``unet_test``,
``format_test``, ``dae_test`` and ``sigma_sampler_test``. They run on the
card (``--device cuda``, the default) or, when asked, on the CPU, and end by
printing the kernel launches they made as one JSON line."""

from __future__ import annotations

import json

import torch


def resolve_device(name: str) -> torch.device:
    """The device a harness runs on; the card raises when there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; run the harness with --device cpu")
    return device


def print_launches() -> None:
    """The kernel launches this process made, as ``kernel launches: {json}``."""
    from ..ops.kernels import launch_counts
    print("kernel launches: " + json.dumps(launch_counts()), flush=True)


def synth_audio(seconds: float, sample_rate: int, freqs, shift: int,
                noise: float = 0.0) -> "np.ndarray":
    """The harnesses' deterministic test signal, (1, 2, T) fp32: a stack of
    sines at 0.12 (plus seeded noise), the right channel rolled by ``shift``."""
    import numpy as np
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    sig = sum(0.12 * np.sin(2 * np.pi * f * t) for f in freqs)
    if noise:
        sig = sig + noise * np.random.default_rng(0).standard_normal(t.shape)
    return np.stack([sig, np.roll(sig, shift)]).astype(np.float32)[None]
