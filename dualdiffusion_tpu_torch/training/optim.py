"""Optimizer and gradient/parameter transforms
(JAX: dualdiffusion_tpu/training/optim.py; reference: src/training/
trainer.py:407-431,639-700, src/modules/mp_tools.py:375-378).

* forced MP weight re-normalization after each step (every ``w_mp``);
* dynamic z-score gradient clipping from log-domain EMAs of the grad norm,
  its state kept on the device (no host sync per step);
* the edm2 / edm2_smooth / constant learning-rate schedules;
* AdamW (``torch.optim.AdamW``) behind the clip, as JAX chains
  ``dynamic_grad_clip`` before ``optax.adamw``;
* Muon / NorMuon (JAX optim.py:146-266; reference: src/training/muon.py,
  nor_muon.py:72-227): Newton-Schulz-5 orthogonalized momentum for the
  >= 2-D parameters whose JAX path matches ``muon_patterns``, AdamW for the
  rest, both behind the same clip.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..models.layers import MP_WEIGHT_NAME
from ..models.mp import normalize
from ..ops.kernels.common import no_tf32
from ..weights import flax_key


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


def _newton_schulz5(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalization of a 2-D matrix in fp32, TF32
    off (reference: nor_muon.py:72-110)."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.float()
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.t()
    with no_tf32():
        x = x / (torch.linalg.vector_norm(x) + eps)
        for _ in range(steps):
            xxt = x @ x.t()
            x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.t() if transposed else x


class Muon:
    """Muon, or NorMuon with ``use_normuon``, over >= 2-D parameters: the
    momentum in JAX's sum convention (m = beta m + g, Nesterov mix beta m +
    g; the reference lerps, which only changes the mix ratio), each weight
    flattened to (out, -1), orthogonalized by Newton-Schulz-5 and scaled by
    sqrt(max(1, rows / cols)); NorMuon divides each row by the root of its
    running mean square first and rescales the whole to the update's RMS.
    The step's rate is the schedule at the optimizer's own 1-based count."""

    def __init__(self, params: Sequence[torch.nn.Parameter], momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5, use_normuon: bool = False,
                 nu_beta: float = 0.95, eps: float = 1e-8):
        self.params = list(params)
        if any(p.dim() < 2 for p in self.params):
            raise ValueError("Muon takes >= 2-D parameters only")
        self.momentum, self.nesterov, self.ns_steps = momentum, nesterov, ns_steps
        self.use_normuon, self.nu_beta, self.eps = use_normuon, nu_beta, eps
        self.momentum_bufs = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros((p.shape[0],), dtype=torch.float32, device=p.device)
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        beta = self.momentum
        for p, m, nu in zip(self.params, self.momentum_bufs, self.nu):
            g = p.grad
            m.mul_(beta).add_(g)
            eff = m * beta + g if self.nesterov else m
            flat = eff.reshape(eff.shape[0], -1)
            o = _newton_schulz5(flat, self.ns_steps)
            if self.use_normuon:
                nu.mul_(self.nu_beta).add_(o.square().mean(dim=1), alpha=1 - self.nu_beta)
                o = o / (nu.sqrt()[:, None] + self.eps)
                o = o * math.sqrt(o.shape[0] / max(o.numel(), 1))
            scale = math.sqrt(max(1.0, flat.shape[0] / flat.shape[1]))
            p.add_((o * scale).reshape(p.shape).to(p.dtype), alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "momentum": [m.clone() for m in self.momentum_bufs],
                "nu": [n.clone() for n in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, key in ((self.momentum_bufs, "momentum"), (self.nu, "nu")):
            for d, v in zip(dst, state[key], strict=True):
                d.copy_(v)


class Optimizer:
    """The gradient chain: dynamic clip, then AdamW at the scheduled rate,
    and Muon for the parameters in ``muon_params`` (Muon / NorMuon).

    ``step(update_index)`` takes the gradients in the parameters' ``.grad``;
    a parameter without one counts as a zero gradient (as in JAX, where
    every leaf has a gradient), so its moments still decay."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Callable], betas: Sequence[float] = (0.9, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 dynamic_clip_z: Optional[float] = 4.0, max_grad_norm: float = 10.0,
                 muon_params: Optional[Sequence[torch.nn.Parameter]] = None,
                 muon_kwargs: Optional[dict] = None):
        self.params = list(params)
        self.learning_rate = learning_rate
        device = self.params[0].device if self.params else None
        self.clip = DynamicGradClip(z=dynamic_clip_z, static_max_norm=max_grad_norm,
                                    device=device)
        routed = {id(p) for p in muon_params or ()}
        self.muon = (Muon([p for p in self.params if id(p) in routed], **(muon_kwargs or {}))
                     if muon_params is not None else None)
        adam = [p for p in self.params if id(p) not in routed]
        self.adamw = (torch.optim.AdamW(adam, lr=self.lr(0), betas=tuple(betas), eps=eps,
                                        weight_decay=weight_decay) if adam else None)
        self.hyperparams = ({k: v for k, v in self.adamw.defaults.items() if k != "lr"}
                            if self.adamw is not None else {})

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
        if self.muon is not None:
            self.muon.step(self.lr(self.muon.count + 1))
        if self.adamw is not None:
            for group in self.adamw.param_groups:
                group["lr"] = self.lr(update_index)
            self.adamw.step()

    def state_dict(self) -> dict:
        state = {"adamw": None if self.adamw is None else self.adamw.state_dict(),
                 "clip": self.clip.state_dict()}
        if self.muon is not None:
            state["muon"] = self.muon.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restores the moments, counts and clip statistics; the
        hyperparameters stay those of the current config (as JAX rebuilds
        its optax chain from the config and restores only its state)."""
        if (state.get("muon") is None) != (self.muon is None):
            raise ValueError("the checkpoint's optimizer routes parameters otherwise")
        if self.adamw is not None:
            self.adamw.load_state_dict(state["adamw"])
            for group in self.adamw.param_groups:
                group.update(self.hyperparams)
        if self.muon is not None:
            self.muon.load_state_dict(state["muon"])
        self.clip.load_state_dict(state["clip"])


def jax_param_paths(module: nn.Module, collection: bool = True,
                    root: str = "") -> List[Tuple[str, torch.nn.Parameter]]:
    """(path, parameter) of each parameter of ``module``, the path as JAX's
    Muon routing matches it: the '/'-joined path in the tree the JAX
    optimizer is given, ``root`` then the flax key, with its "params/"
    collection prefix where that tree has it (a UNet's or DDEC's whole
    variables) and without it where it holds the "params" collection alone
    (the DAE's)."""
    out = []
    for name, p in module.named_parameters():
        key = flax_key(name, False)
        out.append((root + (key if collection else key.split("/", 1)[1]), p))
    return out


def build_optimizer(name: str, params: Iterable,
                    learning_rate: Union[float, Callable] = 1e-3,
                    betas: Sequence[float] = (0.9, 0.99), eps: float = 1e-8,
                    weight_decay: float = 0.0, muon_patterns: Sequence[str] = ("*w_mp*",),
                    dynamic_clip_z: Optional[float] = 4.0,
                    max_grad_norm: float = 10.0, **muon_kwargs) -> Optimizer:
    """Dynamic clip -> AdamW, or -> Muon / NorMuon beside AdamW (JAX
    optim.py:233-266). ``params``: parameters, or (JAX path, parameter)
    pairs (``jax_param_paths``), which "muon" and "normuon" need: a >= 2-D
    parameter whose path matches a pattern of ``muon_patterns`` (fnmatch)
    goes to Muon, every other one to AdamW."""
    items = list(params)
    named = [it for it in items if isinstance(it, tuple)]
    plain = [it[1] if isinstance(it, tuple) else it for it in items]
    kw = dict(betas=betas, eps=eps, weight_decay=weight_decay, dynamic_clip_z=dynamic_clip_z,
              max_grad_norm=max_grad_norm)
    if name == "adamw":
        return Optimizer(plain, learning_rate, **kw)
    if name in ("muon", "normuon"):
        if len(named) != len(items):
            raise ValueError(f"optimizer '{name}' routes by path: pass (path, parameter) pairs")
        muon = [p for path, p in named
                if p.dim() >= 2 and any(fnmatch.fnmatch(path, pat) for pat in muon_patterns)]
        return Optimizer(plain, learning_rate, muon_params=muon,
                         muon_kwargs=dict(muon_kwargs, use_normuon=name == "normuon"), **kw)
    raise ValueError(f"unknown optimizer '{name}'")
