"""Sigma (noise-level) samplers for diffusion training
(JAX: dualdiffusion_tpu/training/sigma_sampler.py:32-206; reference:
src/training/sigma_sampler.py:35-212).

Distributions: ln_normal, ln_sech, ln_sech^2, ln_linear, linear,
scale_invariant and ln_pdf (inverse-CDF sampling of a pdf learned from the
UNet's per-sigma logvar, warmup-scaled and sanitized to rise then fall).
Stratified whole-batch quantiles ((i + 0.5)/n + one shared jitter) or static
quantiles.

The random draws are split from the arithmetic: ``draw_quantiles`` takes a
``torch.Generator``; ``sample(quantiles, pdf)`` is deterministic, so a test
can pass in the quantiles JAX's key splits give.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class SigmaSamplerConfig:
    """Field names and defaults of the JAX package's SigmaSamplerConfig."""
    sigma_max: float = 200.0
    sigma_min: float = 0.03
    sigma_data: float = 1.0
    distribution: str = "ln_sech"
    dist_scale: float = 1.0
    dist_offset: float = 0.3
    use_stratified_sigma_sampling: bool = True
    use_static_sigma_sampling: bool = False
    sigma_pdf_warmup_steps: int = 5000
    sigma_pdf_resolution: int = 127
    sigma_pdf_sanitization: bool = True
    sigma_pdf_offset: float = 0.0
    sigma_pdf_min: float = 1e-3

    @property
    def ln_sigma_min(self) -> float:
        return float(np.log(self.sigma_min))

    @property
    def ln_sigma_max(self) -> float:
        return float(np.log(self.sigma_max))


DISTRIBUTIONS = ("ln_normal", "ln_sech", "ln_sech^2", "ln_linear", "linear",
                 "scale_invariant", "ln_pdf")


class SigmaSampler:
    def __init__(self, config: SigmaSamplerConfig) -> None:
        if config.distribution not in DISTRIBUTIONS:
            raise ValueError(f"invalid distribution: {config.distribution}; "
                             f"known: {DISTRIBUTIONS}")
        self.config = config

    # ---- pdf state (ln_pdf) -------------------------------------------------
    def init_pdf_state(self, device=None) -> torch.Tensor:
        """Uniform pdf over ``sigma_pdf_resolution`` bins."""
        n = self.config.sigma_pdf_resolution
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)

    @staticmethod
    def sanitize_pdf(pdf: torch.Tensor) -> torch.Tensor:
        """Force a monotonic rise to the max, then a monotonic fall
        (running max before the argmax, running min from it on)."""
        max_idx = int(torch.argmax(pdf))
        rise = torch.cummax(pdf[:max_idx + 1], dim=0).values
        fall = torch.cummin(pdf[max_idx:], dim=0).values
        return torch.cat([rise, fall[1:]])

    def update_pdf_from_logvar(self, logvar_fn, pdf_state: torch.Tensor,
                               global_step: float) -> torch.Tensor:
        """New pdf from the UNet's per-sigma logvar head; ``logvar_fn(sigma)
        -> logvar``."""
        cfg = self.config
        if cfg.sigma_pdf_warmup_steps > 0:
            warmup = min(float(global_step) / cfg.sigma_pdf_warmup_steps, 1.0)
        else:
            warmup = 1.0
        ln_sigma = torch.linspace(cfg.ln_sigma_min, cfg.ln_sigma_max, cfg.sigma_pdf_resolution,
                                  dtype=torch.float32, device=pdf_state.device)
        err = logvar_fn(torch.exp(ln_sigma)).reshape(-1).float()
        pdf = torch.exp(-warmup * cfg.dist_scale * err)
        pdf = torch.clamp(pdf + cfg.sigma_pdf_offset, min=cfg.sigma_pdf_min)
        if cfg.sigma_pdf_sanitization:
            pdf = self.sanitize_pdf(pdf)
        return pdf / pdf.sum()

    # ---- quantiles ------------------------------------------------------------
    def draw_quantiles(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """The batch's n quantiles in a random order (the random half of
        ``sample``): static or stratified with one shared jitter, or
        independent uniforms, then a random permutation so the quantiles do
        not follow the sample index."""
        cfg = self.config
        dev = generator.device
        base = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
        if cfg.use_static_sigma_sampling:
            q = base
        elif cfg.use_stratified_sigma_sampling:
            jitter = (torch.rand((), generator=generator, device=dev) - 0.5) / n
            q = base + jitter
        else:
            q = torch.rand((n,), generator=generator, device=dev)
        return q[torch.randperm(n, generator=generator, device=dev)]

    # ---- sampling ------------------------------------------------------------
    def sample(self, quantiles: torch.Tensor,
               pdf_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sigmas at the given quantiles (the deterministic half)."""
        q = quantiles.float()
        name = self.config.distribution
        if name == "ln_pdf":
            if pdf_state is None:
                pdf_state = self.init_pdf_state(q.device)
            return self._ln_pdf(q, pdf_state)
        return getattr(self, "_" + name.replace("^2", "2"))(q)

    def _clip(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.clamp(sigma, self.config.sigma_min, self.config.sigma_max)

    def _ln_normal(self, q):
        cfg = self.config

        def quantile_of(ln_s):
            return 0.5 * (1 + math.erf((2 ** 0.5 * ln_s - 2 ** 0.5 * cfg.dist_offset)
                                       / (2 * cfg.dist_scale)))
        lo = quantile_of(cfg.ln_sigma_min)
        hi = quantile_of(cfg.ln_sigma_max)
        q = lo + q * (hi - lo)
        ln_sigma = cfg.dist_offset + (cfg.dist_scale * 2 ** 0.5) * torch.clamp(
            torch.special.erfinv(q * 2 - 1), -6.0, 6.0)
        return self._clip(torch.exp(ln_sigma))

    def _ln_sech(self, q):
        cfg = self.config
        theta_min = np.arctan(1 / cfg.sigma_max * np.exp(cfg.dist_offset))
        theta_max = np.arctan(1 / cfg.sigma_min * np.exp(cfg.dist_offset))
        theta = q * float(theta_max - theta_min) + float(theta_min)
        ln_sigma = torch.log(1.0 / torch.tan(theta)) * cfg.dist_scale + cfg.dist_offset
        return self._clip(torch.exp(ln_sigma))

    def _ln_sech2(self, q):
        cfg = self.config
        low, high = float(np.tanh(cfg.ln_sigma_min)), float(np.tanh(cfg.ln_sigma_max))
        ln_sigma = torch.atanh(q * (high - low) + low) * cfg.dist_scale + cfg.dist_offset
        span = cfg.ln_sigma_max - cfg.ln_sigma_min
        ln_sigma = torch.where(ln_sigma < cfg.ln_sigma_min, ln_sigma + span, ln_sigma)
        ln_sigma = torch.where(ln_sigma > cfg.ln_sigma_max, ln_sigma - span, ln_sigma)
        return self._clip(torch.exp(ln_sigma))

    def _ln_linear(self, q):
        cfg = self.config
        ln_sigma = q * (cfg.ln_sigma_max - cfg.ln_sigma_min) + cfg.ln_sigma_min
        return self._clip(torch.exp(ln_sigma))

    def _linear(self, q):
        cfg = self.config
        p = 1 / cfg.dist_scale
        s = q * (cfg.sigma_max ** p - cfg.sigma_min ** p) + cfg.sigma_min ** p
        return self._clip(s ** cfg.dist_scale)

    def _scale_invariant(self, q):
        cfg = self.config
        lo = 1 / cfg.sigma_max ** cfg.dist_scale
        hi = 1 / cfg.sigma_min ** cfg.dist_scale
        return 1.0 / (q * (hi - lo) + lo) ** (1 / cfg.dist_scale)

    def _ln_pdf(self, q, pdf: torch.Tensor):
        cfg = self.config
        pdf = pdf.float()
        cdf = torch.cat([torch.zeros((1,), device=pdf.device), torch.cumsum(pdf / pdf.sum(), 0)])
        idx = torch.clamp(torch.searchsorted(cdf, q), max=cdf.shape[0] - 2)
        left, right = cdf[idx], cdf[idx + 1]
        t = (q - left) / torch.clamp(right - left, min=1e-12)
        u = (idx + t) / (cdf.shape[0] - 1)
        ln_sigma = u * (cfg.ln_sigma_max - cfg.ln_sigma_min) + cfg.ln_sigma_min
        return self._clip(torch.exp(ln_sigma))
