"""The EDM sampler loop (JAX: dualdiffusion_tpu/sampling/sampler.py:40-298;
reference: src/pipelines/dual_diffusion_pipeline.py:350-752): CFG through a
doubled batch and ``uncond.lerp(cond, cfg_scale)``, optional Heun
correction, cosh/tanh-shaped perturbation that shrinks sigma_next and
re-adds the difference as fresh noise, and per-step renormalization.

Every per-step scalar is precomputed host-side in float64 and rounded to
fp32, as the JAX package does. Noise comes from the ``torch.Generator``
given, or is passed in (``init_noise`` / ``step_noise``) so a test can
replay another implementation's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.mp import mp_sum, normalize
from .schedule import get_schedule


@dataclass
class SampleParams:
    """Sampling parameters; field names and defaults of the JAX SampleParams."""
    steps: int = 100
    seed: Optional[int] = None
    batch_size: int = 1
    length: Optional[int] = None

    cfg_scale: float = 1.5
    sigma_max: Optional[float] = None
    sigma_min: Optional[float] = None
    sigma_data: Optional[float] = None
    schedule: str = "edm2"
    rho: float = 7.0

    use_heun: bool = True
    input_perturbation: float = 1.0
    input_perturbation_offset: float = 0.0
    perturbation_shape: str = "cosh"
    renormalize_per_step: Optional[bool] = None
    init_noise_mode: str = "sigma_max"
    num_fgla_iters: int = 100
    fgla_phase_init: Optional[str] = "spsi"

    img2img_strength: float = 0.5
    seamless_loop: bool = False
    stereo_fix: float = 0.0

    prompt: Dict[str, float] = field(default_factory=dict)


def per_step_constants(params: SampleParams, sigma_max: float, sigma_min: float,
                       sigma_data: float):
    """Per-step scalars (float64 math, rounded to fp32) and the schedule."""
    sched = get_schedule(params.schedule, params.steps, sigma_max=sigma_max,
                         sigma_min=sigma_min, rho=params.rho)
    sigma_curr = sched[:-1].astype(np.float64)
    sigma_next_sched = sched[1:].astype(np.float64)
    if params.perturbation_shape == "cosh":
        eff = params.input_perturbation * (
            1.0 - 1.0 / np.cosh(np.log(sigma_next_sched * sigma_curr) / 2.0
                                + params.input_perturbation_offset)) ** 2
    elif params.perturbation_shape == "tanh":
        ipo = np.log(sigma_curr) + params.input_perturbation_offset
        eff = (np.tanh(ipo) / 2.0 + 0.5) * params.input_perturbation
    else:
        raise ValueError(f"unknown perturbation_shape {params.perturbation_shape}")
    eff = np.clip(eff, 0.0, 1.0)
    old_sigma_next = sigma_next_sched.copy()
    sigma_next = sigma_next_sched * (1.0 - eff)
    n = params.steps
    consts = dict(
        sigma_curr=sigma_curr, sigma_next=sigma_next,
        t_lerp=np.where(np.arange(n) + 1 < n, sigma_next / sigma_curr, 0.0),
        sigma_hat=np.maximum(old_sigma_next, sigma_min),
        readd=np.where(np.arange(n) + 1 < n,
                       np.sqrt(np.maximum(old_sigma_next ** 2 - sigma_next ** 2, 0.0)), 0.0),
        renorm=np.sqrt(old_sigma_next ** 2 + sigma_data ** 2))
    consts["t_hat"] = consts["sigma_hat"] / sigma_curr
    return {k: v.astype(np.float32) for k, v in consts.items()}, sched


def draw_noise(shape: Tuple[int, ...], stereo_fix: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """Gaussian noise with optional stereo correlation: channel 1 copied into
    channel 0, then fresh noise mp_sum'd toward it with t = stereo_fix."""
    noise = torch.randn(shape, generator=generator, device=device)
    if stereo_fix > 0 and shape[-1] >= 2:
        corr = noise[..., 1:2].expand(shape)
        fresh = torch.randn(shape, generator=generator, device=device)
        noise = mp_sum(fresh, corr, t=stereo_fix)
    return noise


def _noise_device(device, generator: Optional[torch.Generator],
                  init_noise: Optional[torch.Tensor],
                  init_sample: Optional[torch.Tensor]) -> torch.device:
    """Where the sampler draws its noise: ``device`` when given, else the
    device of ``generator``, ``init_noise`` or ``init_sample``, else the
    card (which must exist)."""
    if device is not None:
        return torch.device(device)
    if generator is not None:
        return generator.device
    for t in (init_noise, init_sample):
        if t is not None:
            return t.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass a device, a generator or init_noise on the CPU "
                           "to sample there")
    return torch.device("cuda")


def edm_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               sample_shape: Tuple[int, ...], params: SampleParams,
               sigma_max: float, sigma_min: float, sigma_data: float,
               generator: Optional[torch.Generator] = None, device=None,
               init_sample: Optional[torch.Tensor] = None,
               init_noise: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None,
               use_cfg: bool = True) -> torch.Tensor:
    """Run the EDM sampler; returns the sample normalized to sigma_data.

    denoise_fn(x, sigma) -> D(x): with ``use_cfg`` it receives the doubled
    batch (cond first half, uncond second half). ``init_noise`` is the x_T
    noise and ``step_noise[i]`` the noise re-added after step i; each is
    drawn from ``generator`` when not given, on ``device``: by default the
    device of ``generator``, ``init_noise`` or ``init_sample``, else the card.
    """
    if params.seamless_loop:
        raise NotImplementedError("seamless-loop sampling is not ported")
    if init_sample is not None:
        raise NotImplementedError("img2img (init_sample) is not ported")
    if step_noise is not None and len(step_noise) != params.steps:
        raise ValueError(f"step_noise holds {len(step_noise)} draws for {params.steps} steps")
    device = _noise_device(device, generator, init_noise, init_sample)
    consts, sched = per_step_constants(params, sigma_max, sigma_min, sigma_data)
    b = sample_shape[0]
    noise = (init_noise.float() if init_noise is not None
             else draw_noise(sample_shape, params.stereo_fix, generator, device))
    if params.init_noise_mode == "sigma_plus_data":
        init_scale = float(np.sqrt(sched[0] ** 2 + sigma_data ** 2))
    else:
        init_scale = float(sched[0])
    sample = noise * init_scale
    renorm_steps = (params.renormalize_per_step if params.renormalize_per_step is not None
                    else params.perturbation_shape == "cosh")

    def run_model(x: torch.Tensor, sigma: float) -> torch.Tensor:
        if use_cfg:
            out = denoise_fn(torch.cat([x, x], dim=0),
                             torch.full((2 * b,), sigma, device=x.device)).float()
            return out[b:] + (out[:b] - out[b:]) * params.cfg_scale
        return denoise_fn(x, torch.full((b,), sigma, device=x.device)).float()

    for i in range(params.steps):
        c = {k: float(v[i]) for k, v in consts.items()}
        cfg_out = run_model(sample, c["sigma_curr"])
        if params.use_heun:
            x_hat = cfg_out + (sample - cfg_out) * c["t_hat"]
            cfg_out = 0.5 * (cfg_out + run_model(x_hat, c["sigma_hat"]))
        new = cfg_out + (sample - cfg_out) * c["t_lerp"]
        fresh = (step_noise[i].float() if step_noise is not None
                 else draw_noise(sample_shape, params.stereo_fix, generator, sample.device))
        new = new + fresh * c["readd"]
        if renorm_steps:
            new = normalize(new) * c["renorm"]
        sample = new
    return normalize(sample) * sigma_data
