# Frozen copy of the math of dualdiffusion_tpu_torch/sampling/{sampler,schedule}.py
# (the "edm2" schedule, CFG, Heun, cosh perturbation, per-step renormalization).
"""The plain reference's EDM sampler. Every per-step scalar is worked out
on the host in float64 and rounded to float32. The noise comes from a
``torch.Generator`` drawn in the order the port draws it: the initial
noise, then one tensor after each step."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .model import normalize


def step_constants(steps: int, sigma_max: float, sigma_min: float, sigma_data: float,
                   rho: float = 7.0, perturbation: float = 1.0, offset: float = 0.0):
    t = np.linspace(1.0, 0.0, steps + 1)
    sched = (sigma_max ** (1 / rho) + (1 - t) * (sigma_min ** (1 / rho)
                                                 - sigma_max ** (1 / rho))) ** rho
    cur, nxt = sched[:-1].astype(np.float64), sched[1:].astype(np.float64)
    eff = np.clip(perturbation * (1.0 - 1.0 / np.cosh(np.log(nxt * cur) / 2.0 + offset)) ** 2,
                  0.0, 1.0)
    last = np.arange(steps) + 1 < steps
    sigma_next = nxt * (1.0 - eff)
    c = dict(sigma_curr=cur, t_lerp=np.where(last, sigma_next / cur, 0.0),
             sigma_hat=np.maximum(nxt, sigma_min),
             readd=np.where(last, np.sqrt(np.maximum(nxt ** 2 - sigma_next ** 2, 0.0)), 0.0),
             renorm=np.sqrt(nxt ** 2 + sigma_data ** 2))
    c["t_hat"] = c["sigma_hat"] / cur
    return {k: v.astype(np.float32) for k, v in c.items()}, float(sched[0])


def edm_sample(denoise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], shape: tuple,
               steps: int, sigma_max: float, sigma_min: float, sigma_data: float,
               cfg_scale: Optional[float], generator: torch.Generator,
               keep: Optional[slice] = None) -> torch.Tensor:
    """Heun sampling of ``shape`` (B, H, W, C) with ``denoise(x, sigma)``;
    ``cfg_scale`` given: ``denoise`` takes the doubled batch (conditional
    half first). ``keep`` selects the batch rows the reference computes
    (rows are independent; the draws are of the whole ``shape``)."""
    keep = keep or slice(None)
    consts, s0 = step_constants(steps, sigma_max, sigma_min, sigma_data)
    device = generator.device
    sample = (torch.randn(shape, generator=generator, device=device) * s0)[keep]
    b = sample.shape[0]

    def run(x, sigma):
        if cfg_scale is None:
            return denoise(x, torch.full((b,), sigma, device=x.device)).float()
        out = denoise(torch.cat([x, x]), torch.full((2 * b,), sigma, device=x.device)).float()
        return out[b:] + (out[:b] - out[b:]) * cfg_scale

    for j in range(steps):
        c = {k: float(v[j]) for k, v in consts.items()}
        x = sample
        out = run(x, c["sigma_curr"])
        x_hat = out + (x - out) * c["t_hat"]
        out = 0.5 * (out + run(x_hat, c["sigma_hat"]))
        new = out + (x - out) * c["t_lerp"]
        new = new + torch.randn(shape, generator=generator, device=device)[keep] * c["readd"]
        sample = normalize(new) * c["renorm"]
    return normalize(sample) * sigma_data


def skip_draws(shape: tuple, steps: int, generator: torch.Generator) -> None:
    """Advance ``generator`` past one stage's draws of ``shape``."""
    for _ in range(steps + 1):
        torch.randn(shape, generator=generator, device=generator.device)
