"""Train state and the UNet diffusion train step
(JAX: dualdiffusion_tpu/training/train_state.py:46-309; reference:
src/training/module_trainers/unet_trainer.py:74-308, src/training/
trainer.py:979-1160).

One step, as the JAX step:

* the ln_pdf sigma distribution's pdf is refreshed from the logvar head;
* the whole batch's sigmas come from stratified quantiles in a random order;
* per microbatch (gradient accumulation): conditioning dropout, noise,
  optional input perturbation, the UNet, the EDM2-weighted MSE (dynamic
  sigma_data optional) and the NLL with the learned logvar, backward;
* the summed gradients / accum -> dynamic clip -> AdamW -> forced MP weight
  re-normalization -> EMA.

A ``prepare_fn`` (the DDEC trainer's teacher pipeline) turns each
microbatch into ``samples`` / ``ref_samples`` / ``embeddings`` without
gradients before the loss, as JAX's does inside its step.

The step's random draws (``StepDraws``: quantiles after the permutation,
and per microbatch the prepare stage's draws, the conditioning uniforms,
noise, perturbation) are made apart from its arithmetic, from the state's
``torch.Generator``, so a test can pass in the draws of JAX's key splits
instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from .ema import EMABank
from .optim import Optimizer, normalize_mp_weights
from .sigma_sampler import SigmaSampler, SigmaSamplerConfig


@dataclass
class TrainState:
    module: nn.Module                   # holds the trained parameters
    optimizer: Optimizer                # clip + AdamW state
    ema_state: Dict[str, Dict[str, torch.Tensor]]
    sigma_pdf: torch.Tensor
    generator: torch.Generator          # the step's random draws
    global_step: int = 0
    total_samples_processed: int = 0


@dataclass
class UNetTrainConfig:
    """Field names and defaults of the JAX package's UNetTrainConfig."""
    sigma: SigmaSamplerConfig = field(default_factory=SigmaSamplerConfig)
    conditioning_dropout: float = 0.1
    conditioning_perturbation: float = 0.0
    input_perturbation: float = 0.0
    use_dynamic_sigma_data: bool = False
    dynamic_sigma_data_min: float = 0.5
    dynamic_sigma_data_max: float = 2.0
    dynamic_sigma_data_exp: float = 1.0
    num_loss_buckets: int = 10
    loss_buckets_sigma_min: float = 0.0002
    loss_buckets_sigma_max: float = 20000.0
    crop_edges: int = 0
    grad_accum_steps: int = 1


@dataclass
class MicroDraws:
    """One microbatch's random draws (None where the option is off)."""
    cond_u: Optional[torch.Tensor]         # (b,) uniforms for conditioning dropout
    noise: torch.Tensor                    # N(0,1), the samples' shape
    perturbation: Optional[torch.Tensor]   # N(0,1), the samples' shape
    cond_noise: Optional[torch.Tensor]     # N(0,1), the embeddings' shape
    prepare: Any = None                    # the prepare stage's draws (its ``.to``)
    dropout_seed: Optional[torch.Tensor] = None  # () int64, seeds the UNet's dropout masks


@dataclass
class StepDraws:
    quantiles: torch.Tensor                # (total_batch,), permuted
    micro: List[MicroDraws]

    def to(self, device) -> "StepDraws":
        """The same draws on ``device``."""
        def move(t):
            return None if t is None else t.to(device)
        return StepDraws(move(self.quantiles),
                         [MicroDraws(*(move(getattr(m, f.name)) for f in dataclasses.fields(m)))
                          for m in self.micro])


def _crop(samples: torch.Tensor, config: UNetTrainConfig) -> torch.Tensor:
    c = config.crop_edges
    return samples[..., c:-c, :] if c > 0 else samples


def draw_micro(generator: torch.Generator, config: UNetTrainConfig, micro_shape,
               has_embeddings: bool, emb_channels: int, prepare: Any = None,
               dropout: bool = False) -> MicroDraws:
    """One microbatch's draws, from ``generator``; ``prepare`` is the
    prepare stage's draws, made before these. ``dropout``: the model drops
    out in training, so a seed for its masks is drawn last."""
    dev = generator.device

    def normal(shape):
        return torch.randn(tuple(shape), generator=generator, device=dev)

    b = micro_shape[0]
    cond_u = torch.rand((b,), generator=generator, device=dev) if has_embeddings else None
    noise = normal(micro_shape)
    pert = normal(micro_shape) if config.input_perturbation > 0 else None
    cond_noise = (normal((b, emb_channels))
                  if has_embeddings and config.conditioning_perturbation > 0 else None)
    seed = (torch.randint(0, 2 ** 62, (), generator=generator, device=dev) if dropout
            else None)
    return MicroDraws(cond_u, noise, pert, cond_noise, prepare, seed)


def draw_unet_step(generator: torch.Generator, sampler: SigmaSampler, config: UNetTrainConfig,
                   total_batch_size: int, micro_shape, has_embeddings: bool,
                   emb_channels: int, draw_prepare: Optional[Callable] = None,
                   dropout: bool = False) -> StepDraws:
    """Every random number one train step uses, from ``generator``, in the
    order the step draws them itself. ``micro_shape`` is the shape of a
    microbatch's (prepared and cropped) samples; ``draw_prepare(generator,
    b)`` makes the prepare stage's draws of a step with a ``prepare_fn``;
    ``dropout`` as in ``draw_micro``."""
    q = sampler.draw_quantiles(generator, total_batch_size)
    micro = []
    for _ in range(config.grad_accum_steps):
        prep = draw_prepare(generator, micro_shape[0]) if draw_prepare is not None else None
        micro.append(draw_micro(generator, config, micro_shape, has_embeddings, emb_channels,
                                prep, dropout))
    return StepDraws(q, micro)


def model_embeddings(model, emb_in: torch.Tensor,
                     conditioning_mask: torch.Tensor) -> Optional[torch.Tensor]:
    """The default ``get_embeddings`` hook: the UNet's CFG label embedding."""
    return model.get_embeddings(emb_in, conditioning_mask)


def make_unet_train_step(optimizer: Optimizer, ema_bank: Optional[EMABank],
                         config: UNetTrainConfig, total_batch_size: int,
                         prepare_fn: Optional[Callable] = None,
                         draw_prepare: Optional[Callable] = None,
                         get_embeddings: Callable = model_embeddings):
    """Build ``train_step(state, batch, draws=None) -> logs``; it updates
    ``state`` in place. ``batch``: {"samples": (B, [Z,] H, W, C), "embeddings":
    (B, E) optional}, B = device batch x grad_accum_steps; or, with
    ``prepare_fn(micro_batch, prepare_draws) -> {"samples", "ref_samples",
    "embeddings"?}`` (run without gradients per microbatch, its draws from
    ``draw_prepare(generator, b)``), whatever that takes.
    ``get_embeddings(model, emb_in, mask)`` gives the label embedding, None
    for a model without one."""
    sampler = SigmaSampler(config.sigma)
    accum = config.grad_accum_steps

    def loss_fn(model, batch, sigma, draws: MicroDraws):
        samples = _crop(batch["samples"].float(), config)
        emb_in = batch.get("embeddings")
        embeddings = None
        if emb_in is not None:
            cond_mask = (draws.cond_u > config.conditioning_dropout).float()
            # as the JAX builder, whose get_embeddings runs with training=False
            embeddings = get_embeddings(model, emb_in, cond_mask)
            if config.conditioning_perturbation > 0:
                embeddings = embeddings + draws.cond_noise * config.conditioning_perturbation
        dims = tuple(range(1, samples.dim()))
        sig_b = sigma.reshape((-1,) + (1,) * len(dims))
        x_noisy = samples + draws.noise * sig_b
        x_pert = None
        if config.input_perturbation > 0:
            x_pert = x_noisy + draws.perturbation * sig_b * config.input_perturbation
        kw = {}
        if draws.dropout_seed is not None:
            kw["dropout_generator"] = torch.Generator(device=samples.device).manual_seed(
                int(draws.dropout_seed))
        denoised = model(x_noisy, sigma, embeddings, batch.get("ref_samples"), training=True,
                         x_perturbed=x_pert, **kw)

        if config.use_dynamic_sigma_data:
            n = np.prod(samples.shape[1:])
            sd = torch.sqrt(samples.square().sum(dim=dims, keepdim=True) / n)
            sd = sd.clamp(config.dynamic_sigma_data_min,
                          config.dynamic_sigma_data_max) ** config.dynamic_sigma_data_exp
        else:
            sd = config.sigma.sigma_data
        loss_weight = (sig_b ** 2 + sd ** 2) / (sig_b * sd) ** 2
        weighted = ((denoised - samples) ** 2 * loss_weight).mean(dim=dims)
        logvar = model.get_sigma_loss_logvar(sigma).reshape(-1)
        loss = (weighted / torch.exp(logvar) + logvar).mean()
        return loss, weighted.detach(), denoised.detach().std(correction=0)

    def bucket_losses(weighted, sigma):
        nb = config.num_loss_buckets
        lo, hi = np.log(config.loss_buckets_sigma_min), np.log(config.loss_buckets_sigma_max)
        idx = ((torch.log(sigma) - lo) / (hi - lo) * nb).to(torch.int32).clamp(0, nb - 1)
        sums = torch.zeros((nb,), device=weighted.device).index_add_(0, idx, weighted)
        counts = torch.zeros((nb,), device=weighted.device).index_add_(
            0, idx, torch.ones_like(weighted))
        return sums, counts

    def micro_draws(state: TrainState, micro: Dict[str, Any]) -> MicroDraws:
        """The step's own draws for a prepared microbatch."""
        has_emb = micro.get("embeddings") is not None
        emb_ch = (state.module.emb_label.out_channels
                  if has_emb and config.conditioning_perturbation > 0 else 0)
        dropout = getattr(getattr(state.module, "cfg", None), "dropout", 0.0) > 0
        return draw_micro(state.generator, config, _crop(micro["samples"], config).shape,
                          has_emb, emb_ch, dropout=dropout)

    def train_step(state: TrainState, batch: Dict[str, Any],
                   draws: Optional[StepDraws] = None) -> Dict[str, Any]:
        model = state.module
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        mb = n // accum
        quantiles = (draws.quantiles if draws is not None
                     else sampler.draw_quantiles(state.generator, total_batch_size))

        if config.sigma.distribution == "ln_pdf":
            with torch.no_grad():
                state.sigma_pdf = sampler.update_pdf_from_logvar(
                    model.get_sigma_loss_logvar, state.sigma_pdf, float(state.global_step))
        sigma_all = sampler.sample(quantiles, state.sigma_pdf)[:n]

        optimizer.zero_grad()
        loss_sum = 0.0
        dstd, sample_losses = [], []
        nb = max(config.num_loss_buckets, 1)
        bucket_sums = torch.zeros((nb,), device=sigma_all.device)
        bucket_counts = torch.zeros((nb,), device=sigma_all.device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            micro = {k: v[sl] for k, v in batch.items()}
            md = draws.micro[i] if draws is not None else None
            if prepare_fn is not None:
                prep = md.prepare if md is not None else draw_prepare(state.generator, mb)
                with torch.no_grad():
                    micro = prepare_fn(micro, prep)
            if md is None:
                md = micro_draws(state, micro)
            sigma = sigma_all[sl]
            loss, weighted, std = loss_fn(model, micro, sigma, md)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            dstd.append(std)
            sample_losses.append(weighted)
            if config.num_loss_buckets > 0:
                s, c = bucket_losses(weighted, sigma)
                bucket_sums += s
                bucket_counts += c
        with torch.no_grad():
            for p in optimizer.params:
                if p.grad is not None:
                    p.grad.div_(accum)
        optimizer.step(state.global_step)
        normalize_mp_weights(model)
        if ema_bank is not None:
            ema_bank.update(state.ema_state, model, state.total_samples_processed,
                            total_batch_size, state.global_step)
        state.global_step += 1
        state.total_samples_processed += total_batch_size
        return {"loss": loss_sum / accum, "denoised_std": torch.stack(dstd).mean(),
                "grad_norm": optimizer.clip.last_grad_norm,
                "max_grad_norm": optimizer.clip.last_max_norm,
                "bucket_sums": bucket_sums, "bucket_counts": bucket_counts,
                "sample_losses": torch.cat(sample_losses)}

    return train_step


@dataclass
class EvalDraws:
    """The validation step's draws for one batch."""
    noise: torch.Tensor                    # N(0,1), the samples' shape
    quantiles: torch.Tensor                # (b,), static, permuted
    prepare: Any = None                    # the prepare stage's draws


def make_unet_eval_step(config: UNetTrainConfig, prepare_fn: Optional[Callable] = None,
                        draw_prepare: Optional[Callable] = None,
                        get_embeddings: Callable = model_embeddings):
    """Validation loss: EDM2-weighted MSE at static stratified sigmas, no
    conditioning dropout, no logvar term. ``eval_step(model, batch,
    generator, draws=None) -> loss``; ``prepare_fn`` and ``draw_prepare`` as
    in ``make_unet_train_step``."""
    sampler = SigmaSampler(dataclasses.replace(config.sigma, use_static_sigma_sampling=True))

    @torch.no_grad()
    def eval_step(model, batch, generator: torch.Generator,
                  draws: Optional[EvalDraws] = None) -> torch.Tensor:
        if prepare_fn is not None:
            b = next(iter(batch.values())).shape[0]
            prep = draws.prepare if draws is not None else draw_prepare(generator, b)
            batch = prepare_fn(batch, prep)
        samples = _crop(batch["samples"].float(), config)
        b = samples.shape[0]
        emb_in = batch.get("embeddings")
        embeddings = None
        if emb_in is not None:
            embeddings = get_embeddings(model, emb_in, torch.ones((b,), device=emb_in.device))
        if draws is None:
            draws = EvalDraws(
                torch.randn(samples.shape, generator=generator, device=generator.device),
                sampler.draw_quantiles(generator, b))
        sigma = sampler.sample(draws.quantiles.to(samples.device))
        sig = sigma.reshape((-1,) + (1,) * (samples.dim() - 1))
        denoised = model(samples + draws.noise.to(samples.device) * sig, sigma, embeddings,
                         batch.get("ref_samples"))
        sd = config.sigma.sigma_data
        weight = (sig ** 2 + sd ** 2) / (sig * sd) ** 2
        return (((denoised - samples) ** 2) * weight).mean()

    return eval_step


def init_train_state(module: nn.Module, optimizer: Optimizer, ema_bank: Optional[EMABank],
                     sigma_config: SigmaSamplerConfig,
                     generator: torch.Generator) -> TrainState:
    device = next(module.parameters()).device
    return TrainState(module=module, optimizer=optimizer,
                      ema_state=ema_bank.init(module) if ema_bank is not None else {},
                      sigma_pdf=SigmaSampler(sigma_config).init_pdf_state(device),
                      generator=generator)
