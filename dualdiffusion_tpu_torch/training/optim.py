"""Optimizer and gradient/parameter transforms
(JAX: dualdiffusion_tpu/training/optim.py; reference: src/training/
trainer.py:407-431,639-700, src/modules/mp_tools.py:375-378).

* forced MP weight re-normalization after each step (every ``w_mp``);
* dynamic z-score gradient clipping from log-domain EMAs of the grad norm,
  its state kept on the device (no host sync per step);
* the edm2 / edm2_smooth / constant learning-rate schedules;
* AdamW (``torch.optim.AdamW``) behind the clip, as JAX chains
  ``dynamic_grad_clip`` before ``optax.adamw``.

Muon / NorMuon (JAX optim.py:149-230) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..models.layers import MP_WEIGHT_NAME
from ..models.mp import normalize


@torch.no_grad()
def normalize_mp_weights(module: nn.Module) -> None:
    """Re-normalize every ``w_mp`` parameter to per-output-channel unit RMS,
    in place."""
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] == MP_WEIGHT_NAME:
            p.copy_(normalize(p))


class DynamicGradClip:
    """Clip by global norm at mean + z*std of the grad-norm history
    (log-domain EMAs); ``z=None`` clips at the static max norm. Until the
    statistics are seeded the static bound holds. Non-finite gradient
    elements are zeroed, and a non-finite norm zeroes the whole update."""

    def __init__(self, z: Optional[float] = 4.0, static_max_norm: float = 10.0,
                 mean_ema_beta: float = 0.99, std_ema_beta: float = 0.99,
                 eps: float = 1e-8, device=None):
        self.z = z
        self.static_max_norm = static_max_norm
        self.mean_ema_beta = mean_ema_beta
        self.std_ema_beta = std_ema_beta
        self.eps = eps
        zero = torch.zeros((), dtype=torch.float32, device=device)
        self.grad_norm_logmean = zero.clone()
        self.grad_norm_logvar = zero.clone()
        self.last_grad_norm = zero.clone()
        self.last_max_norm = torch.full((), static_max_norm, dtype=torch.float32, device=device)

    @torch.no_grad()
    def clip_(self, grads: Sequence[torch.Tensor]) -> None:
        """Scale ``grads`` in place and advance the statistics."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))).float())
        finite = torch.isfinite(norm)
        norm_s = torch.clamp(torch.where(finite, norm, self.eps), min=self.eps)
        static = torch.full_like(norm, self.static_max_norm)
        if self.z is not None:
            dynamic = (torch.exp(self.grad_norm_logmean)
                       + torch.exp(self.grad_norm_logvar / 2.0) * self.z)
            max_norm = torch.where(self.grad_norm_logmean != 0.0, dynamic, static)
        else:
            max_norm = static
        scale = torch.where(finite, torch.clamp(max_norm / norm_s, max=1.0), 0.0)
        torch._foreach_mul_(list(grads), scale)
        for g in grads:
            torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)

        grad_var = torch.clamp((norm_s - torch.exp(self.grad_norm_logmean)) ** 2, min=self.eps)
        b1, b2 = self.mean_ema_beta, self.std_ema_beta
        self.grad_norm_logmean = torch.where(
            finite, self.grad_norm_logmean * b1 + (1 - b1) * torch.log(norm_s),
            self.grad_norm_logmean)
        self.grad_norm_logvar = torch.where(
            finite, self.grad_norm_logvar * b2 + (1 - b2) * torch.log(grad_var),
            self.grad_norm_logvar)
        self.last_grad_norm = norm
        self.last_max_norm = max_norm

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k).clone() for k in
                ("grad_norm_logmean", "grad_norm_logvar", "last_grad_norm", "last_max_norm")}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for k, v in state.items():
            setattr(self, k, v.to(getattr(self, k).device))


def lr_schedule(name: str, learning_rate: float, warmup_steps: int = 5000,
                reference_steps: int = 70000, decay_exponent: float = 1.0,
                min_learning_rate: float = 0.0, num_processes: int = 1) -> Callable:
    """step -> learning rate (JAX optim.py:115-142)."""
    w = warmup_steps * num_processes
    r = reference_steps * num_processes

    if name == "edm2":
        def fn(step):
            lr = step / max(w, 1) if step < w else 1.0
            if step > r:
                decayed = lr / max((step / r) ** decay_exponent, 1.0)
                lr = max(decayed * learning_rate, min_learning_rate) / learning_rate
            return lr * learning_rate
    elif name == "edm2_smooth":
        def fn(step):
            lr = (math.cos(step / max(w, 1) * math.pi + math.pi) + 1.0) / 2.0 if step < w else 1.0
            return lr / (1.0 + (step / r) ** decay_exponent) * learning_rate
    elif name == "constant":
        def fn(step):
            return (step / max(w, 1) if step < w else 1.0) * learning_rate
    else:
        raise ValueError(f"unsupported lr schedule: {name}")
    return fn


class Optimizer:
    """The gradient chain: dynamic clip, then AdamW at the scheduled rate.

    ``step(update_index)`` takes the gradients in the parameters' ``.grad``;
    a parameter without one counts as a zero gradient (as in JAX, where
    every leaf has a gradient), so its moments still decay."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Callable], betas: Sequence[float] = (0.9, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 dynamic_clip_z: Optional[float] = 4.0, max_grad_norm: float = 10.0):
        self.params = list(params)
        self.learning_rate = learning_rate
        device = self.params[0].device if self.params else None
        self.clip = DynamicGradClip(z=dynamic_clip_z, static_max_norm=max_grad_norm,
                                    device=device)
        self.adamw = torch.optim.AdamW(self.params, lr=self.lr(0), betas=tuple(betas),
                                       eps=eps, weight_decay=weight_decay)
        self.hyperparams = {k: v for k, v in self.adamw.defaults.items() if k != "lr"}

    def lr(self, update_index: int) -> float:
        lr = self.learning_rate
        return float(lr(update_index)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, update_index: int) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip.clip_([p.grad for p in self.params])
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(update_index)
        self.adamw.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "clip": self.clip.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restores the moments, counts and clip statistics; the
        hyperparameters stay those of the current config (as JAX rebuilds
        its optax chain from the config and restores only its state)."""
        self.adamw.load_state_dict(state["adamw"])
        for group in self.adamw.param_groups:
            group.update(self.hyperparams)
        self.clip.load_state_dict(state["clip"])


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    learning_rate: Union[float, Callable] = 1e-3,
                    betas: Sequence[float] = (0.9, 0.99), eps: float = 1e-8,
                    weight_decay: float = 0.0, muon_patterns: Sequence[str] = ("*w_mp*",),
                    dynamic_clip_z: Optional[float] = 4.0,
                    max_grad_norm: float = 10.0) -> Optimizer:
    """Dynamic clip -> AdamW (JAX optim.py:233-266)."""
    if name in ("muon", "normuon"):
        raise NotImplementedError(f"optimizer '{name}' is not ported")
    if name != "adamw":
        raise ValueError(f"unknown optimizer '{name}'")
    return Optimizer(params, learning_rate, betas=betas, eps=eps, weight_decay=weight_decay,
                     dynamic_clip_z=dynamic_clip_z, max_grad_norm=max_grad_norm)
