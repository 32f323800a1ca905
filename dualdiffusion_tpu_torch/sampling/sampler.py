"""The EDM sampler loop (JAX: dualdiffusion_tpu/sampling/sampler.py:40-298;
reference: src/pipelines/dual_diffusion_pipeline.py:350-752): CFG through a
doubled batch and ``uncond.lerp(cond, cfg_scale)``, optional Heun
correction, cosh/tanh-shaped perturbation that shrinks sigma_next and
re-adds the difference as fresh noise, per-step renormalization, img2img
entry part-way down the schedule, seamless-loop sampling on a torus (a
random roll and a fixed circular pad each step) with its final crossfade,
and the preview/abort callback after every chunk of steps.

Every per-step scalar is precomputed host-side in float64 and rounded to
fp32, as the JAX package does. Noise and seamless-loop shifts come from the
``torch.Generator`` given, or are passed in (``init_noise`` /
``step_noise`` / ``step_shifts``) so a test can replay another
implementation's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.mp import mp_sum, normalize
from ..utils.trace import span
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


#: seamless-loop circular pad columns (JAX sampler.py:78; reference :655-658)
LOOP_PAD = 32


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


def circular_pad_w(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Circular pad of ``pad`` columns on each side of the time axis (axis -2
    of (B, H, W, C)); wraps more than once when ``pad`` exceeds W."""
    w = x.shape[-2]
    idx = torch.arange(-pad, w + pad, device=x.device) % w
    return x.index_select(-2, idx)


def edm_sample(denoise_fn: Callable[..., torch.Tensor],
               sample_shape: Tuple[int, ...], params: SampleParams,
               sigma_max: float, sigma_min: float, sigma_data: float,
               generator: Optional[torch.Generator] = None, device=None,
               init_sample: Optional[torch.Tensor] = None,
               init_noise: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None,
               use_cfg: bool = True, x_ref: Optional[torch.Tensor] = None,
               step_shifts: Optional[Sequence[int]] = None,
               chunk_size: Optional[int] = None,
               chunk_callback: Optional[Callable[[int, torch.Tensor], bool]] = None,
               debug: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Run the EDM sampler; returns the sample normalized to sigma_data.

    denoise_fn(x, sigma) -> D(x), or denoise_fn(x, sigma, ref) when ``x_ref``
    is given (already CFG-doubled with ``use_cfg``): the reference is passed
    per step so that the seamless loop's roll and pad move it with the
    sample. With ``use_cfg`` the denoiser receives the doubled batch (cond
    first half, uncond second half).

    ``init_sample`` (img2img): the schedule is entered at step
    ``steps - round(steps * strength)`` with ``params.img2img_strength``
    clipped to [0, 1], from ``noise * sigma_entry + init_sample * sigma_data``.
    ``params.seamless_loop``: each step rolls the sample (and ``x_ref``) by a
    random shift on W, pads it circularly by ``LOOP_PAD`` columns, and crops
    and un-rolls the step's result. ``chunk_callback(steps_done, sample)``
    (the un-normalized sample) is called after every ``chunk_size`` steps;
    True stops the run, whose partial sample is normalized and returned.
    ``debug``, when given, receives ``sigma_schedule`` and per-step
    ``sample_std``, ``cfg_output_mean`` and ``cfg_output_std`` (as JAX), and
    under the seamless loop the ``step_shifts`` taken.

    Noise: ``init_noise`` is the x_T noise, ``step_noise[i]`` the noise
    re-added after the i-th step run and ``step_shifts[i]`` its seamless-loop
    shift; each is drawn from ``generator`` when not given, on ``device``: by
    default the device of ``generator``, ``init_noise`` or ``init_sample``,
    else the card.
    """
    device = _noise_device(device, generator, init_noise, init_sample)
    consts, sched = per_step_constants(params, sigma_max, sigma_min, sigma_data)
    b = sample_shape[0]
    noise = (init_noise.float() if init_noise is not None
             else draw_noise(sample_shape, params.stereo_fix, generator, device))
    if params.init_noise_mode == "sigma_plus_data":
        init_scale = float(np.sqrt(sched[0] ** 2 + sigma_data ** 2))
    else:
        init_scale = float(sched[0])
    skip_steps = 0
    if init_sample is not None:
        strength = float(np.clip(params.img2img_strength, 0.0, 1.0))
        skip_steps = params.steps - int(round(params.steps * strength))
        if skip_steps > 0:
            init_scale = float(sched[skip_steps])
        sample = noise * init_scale + init_sample.float() * sigma_data
    else:
        sample = noise * init_scale
    run_steps = params.steps - skip_steps
    for name, given in (("step_noise", step_noise), ("step_shifts", step_shifts)):
        if given is not None and len(given) != run_steps:
            raise ValueError(f"{name} holds {len(given)} draws for {run_steps} steps")
    width = sample_shape[-2]
    if params.seamless_loop and step_shifts is None:
        step_shifts = torch.randint(0, width, (run_steps,), generator=generator,
                                    device=device).tolist()
    renorm_steps = (params.renormalize_per_step if params.renormalize_per_step is not None
                    else params.perturbation_shape == "cosh")
    # as JAX: no callback unless the steps run in more than one chunk
    chunked = chunk_callback is not None and bool(chunk_size) and chunk_size < run_steps
    stats = {"sample_std": [], "cfg_output_mean": [], "cfg_output_std": []}

    def run_model(x: torch.Tensor, sigma: float, ref: Optional[torch.Tensor]) -> torch.Tensor:
        args = () if ref is None else (ref,)
        if use_cfg:
            out = denoise_fn(torch.cat([x, x], dim=0),
                             torch.full((2 * b,), sigma, device=x.device), *args).float()
            return out[b:] + (out[:b] - out[b:]) * params.cfg_scale
        return denoise_fn(x, torch.full((b,), sigma, device=x.device), *args).float()

    done = 0
    for j in range(run_steps):
        # the step closes before the callback, which may start or stop a profile
        with span("dd.sampler.step"):
            c = {k: float(v[skip_steps + j]) for k, v in consts.items()}
            x, ref = sample, x_ref
            if params.seamless_loop:
                shift = int(step_shifts[j])
                x = circular_pad_w(torch.roll(sample, shift, dims=-2), LOOP_PAD)
                if ref is not None:
                    ref = circular_pad_w(torch.roll(ref, shift, dims=-2), LOOP_PAD)
            cfg_out = run_model(x, c["sigma_curr"], ref)
            if params.use_heun:
                x_hat = cfg_out + (x - cfg_out) * c["t_hat"]
                cfg_out = 0.5 * (cfg_out + run_model(x_hat, c["sigma_hat"], ref))
            new = cfg_out + (x - cfg_out) * c["t_lerp"]
            if params.seamless_loop:
                new = torch.roll(new[..., LOOP_PAD:-LOOP_PAD, :], -shift, dims=-2)
                cfg_out = torch.roll(cfg_out[..., LOOP_PAD:-LOOP_PAD, :], -shift, dims=-2)
            fresh = (step_noise[j].float() if step_noise is not None
                     else draw_noise(sample_shape, params.stereo_fix, generator, sample.device))
            new = new + fresh * c["readd"]
            if renorm_steps:
                new = normalize(new) * c["renorm"]
            sample = new
            if debug is not None:
                stats["sample_std"].append(new.std(correction=0))
                stats["cfg_output_mean"].append(cfg_out.mean())
                stats["cfg_output_std"].append(cfg_out.std(correction=0))
            done = j + 1
        if (chunked and (done % chunk_size == 0 or done == run_steps)
                and chunk_callback(done, sample)):
            break
    if debug is not None:
        debug["sigma_schedule"] = np.asarray(sched)
        if params.seamless_loop:
            debug["step_shifts"] = [int(v) for v in step_shifts[:done]]
        debug.update({k: torch.stack(v) for k, v in stats.items() if v})
    return normalize(sample) * sigma_data


def seamless_loop_crossfade(raw: torch.Tensor, hop_length: int,
                            exponent: float = 2.0 / 3.0) -> torch.Tensor:
    """Blend the two ends of seamless-loop audio (B, C, T) into a loop that is
    ``int((LOOP_PAD - 0.5) * hop_length) * 2`` samples shorter (JAX
    sampler.py:301-312; reference: dual_diffusion_pipeline.py:573-582)."""
    pad = int((LOOP_PAD - 0.5) * hop_length) * 2
    if raw.shape[-1] < pad + pad // 2:
        raise ValueError(f"the seamless crossfade at hop {hop_length} needs "
                         f"{pad + pad // 2} samples or more, not {raw.shape[-1]}")
    w = torch.arange(pad, dtype=torch.float32, device=raw.device) / pad
    blended = raw[..., -pad:] * (1 - w) ** exponent + raw[..., :pad] * w ** exponent
    out = raw[..., pad // 2: -pad // 2].clone()
    out[..., : pad // 2] = blended[..., -pad // 2:]
    out[..., -pad // 2:] = blended[..., : pad // 2]
    return out
