"""The DAE trainer (JAX: dualdiffusion_tpu/training/module_trainers.py:45-50,
127-342; reference: src/training/module_trainers/dae_p1_trainer.py:228-431).

One step, as the JAX step: per microbatch, a random stereo flip, the mel
spectrogram (cropped by ``crop_edges`` and cut to a multiple of the DAE's
downsample ratio), the DAE's training forward (which moves its latent stats),
the recon loss (MSS2D, fused through K5/K6 with ``use_fused_mss2d``) plus a
decaying point L1, its NLL under the learned logvar, the phase-invariance
term (a second encode, with ``training=False``, of the mel of a phase-rotated
MDCT view of the same audio), optional dispersion, and KL-to-unit-variance on
the pre-norm latents; then the summed gradients / accum -> clip -> AdamW ->
forced MP weight norm -> EMA of the parameters and the stats buffers.

The step's random draws (``DAEMicroDraws``: the stereo flips and the phase
angles) are made apart from its arithmetic, from the state's
``torch.Generator``, so a test can pass in the draws of JAX's key splits.
The MDCT-domain variant, the randomized-prime MSS, the 1-D prime MSS and the
equivariance loss are not ported, nor the DDEC and joint trainers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.kernels import mss2d_loss_fused
from .ema import EMABank
from .losses import (MSSLoss2D, MSSLoss2DConfig, latents_dispersion_loss,
                     phase_invariance_loss)
from .optim import Optimizer, normalize_mp_weights
from .train_state import TrainState


def random_stereo_augmentation(audio: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Swap L/R of the samples where ``flip`` (B,) is true. audio: (B, C, T)."""
    return torch.where(flip[:, None, None], audio.flip(1), audio)


@dataclass
class DAETrainConfig:
    """Field names and defaults of the JAX DAETrainConfig."""
    kl_loss_weight: float = 0.01
    kl_mean_weight: float = 1.0
    kl_warmup_steps: int = 20000
    phase_invariance_loss_weight: float = 1.0
    latents_dispersion_loss_weight: float = 0.0
    equivariance_loss_weight: float = 0.0
    latents_regularization_warmup_steps: int = 20000
    point_loss_weight: float = 2.0
    point_loss_warmup_steps: int = 100
    random_stereo_augmentation: bool = True
    crop_edges: int = 4
    grad_accum_steps: int = 1
    domain: str = "mel"               # "mel" (p1) | "mdct" (m1, not ported)
    use_random_prime_mss: bool = False
    #: the recon loss through K5/K6 (ops/kernels/mss2d.py): no unfolded block
    #: tensor for widths >= 32; midside "stack" or "none" only
    use_fused_mss2d: bool = False
    mss1d_prime_loss_weight: float = 0.0
    mss2d: MSSLoss2DConfig = field(default_factory=MSSLoss2DConfig)


@dataclass
class DAEMicroDraws:
    """One microbatch's random draws (None where the option is off)."""
    stereo_flip: Optional[torch.Tensor]   # (b,) bool
    phase_theta: Optional[torch.Tensor]   # (b,) MDCT rotation angles of the second view

    def to(self, device) -> "DAEMicroDraws":
        return DAEMicroDraws(*(None if t is None else t.to(device)
                               for t in (self.stereo_flip, self.phase_theta)))


def draw_dae_step(generator: torch.Generator, config: DAETrainConfig,
                  micro_batch: int) -> List[DAEMicroDraws]:
    """Every random number one DAE train step uses, from ``generator``."""
    dev = generator.device
    out = []
    for _ in range(config.grad_accum_steps):
        flip = (torch.rand((micro_batch,), generator=generator, device=dev) < 0.5
                if config.random_stereo_augmentation else None)
        theta = (torch.rand((micro_batch,), generator=generator, device=dev) * (2 * np.pi)
                 if config.phase_invariance_loss_weight > 0 else None)
        out.append(DAEMicroDraws(flip, theta))
    return out


def _check_ported(cfg: DAETrainConfig) -> None:
    if cfg.domain != "mel":
        raise NotImplementedError(f"DAETrainConfig.domain={cfg.domain!r} is not ported")
    if cfg.use_random_prime_mss:
        raise NotImplementedError("DAETrainConfig.use_random_prime_mss is not ported")
    for name in ("mss1d_prime_loss_weight", "equivariance_loss_weight"):
        if getattr(cfg, name) > 0:
            raise NotImplementedError(f"DAETrainConfig.{name} > 0 is not ported")
    if cfg.use_fused_mss2d and cfg.mss2d.use_midside_transform not in ("stack", "none"):
        raise ValueError("the fused MSS2D takes midside 'stack' or 'none'")


def make_dae_train_step(fmt, optimizer: Optimizer, ema_bank: Optional[EMABank],
                        config: DAETrainConfig, total_batch_size: int):
    """Build ``train_step(state, batch, draws=None) -> logs`` over
    ``state.module``, a DAE; it updates ``state`` in place. ``batch``:
    {"audio": (B, C, T)}, B = device batch x grad_accum_steps."""
    cfg = config
    _check_ported(cfg)
    mss = MSSLoss2D(cfg.mss2d)
    c = cfg.crop_edges
    accum = cfg.grad_accum_steps

    def warmup(step: int, n: int) -> float:
        return 1.0 if n <= 0 else min(step / n, 1.0)

    def decay(step: int, n: int) -> float:
        return 0.0 if n <= 0 else max(1.0 - step / n, 0.0)

    def mel_view(model, audio: torch.Tensor) -> torch.Tensor:
        mel = fmt.raw_to_mel_spec(audio)
        mel = mel[:, :, c:-c] if c > 0 else mel
        ds = model.downsample_ratio
        return mel[:, :, : mel.shape[2] // ds * ds]

    def loss_fn(model, audio: torch.Tensor, draws: DAEMicroDraws, step: int):
        audio = audio.float()
        if cfg.random_stereo_augmentation:
            audio = random_stereo_augmentation(audio, draws.stereo_flip)
        with torch.no_grad():
            samples = mel_view(model, audio)
        latents, recon, pre_norm = model(samples, training=True)

        s_cf = samples.permute(0, 3, 1, 2)
        r_cf = recon.float().permute(0, 3, 1, 2)
        if cfg.use_fused_mss2d:
            recon_loss = mss2d_loss_fused(
                r_cf, s_cf, block_widths=cfg.mss2d.block_widths,
                block_overlap=cfg.mss2d.block_overlap,
                use_midside=cfg.mss2d.use_midside_transform == "stack")
        else:
            recon_loss = mss(r_cf, s_cf)
        point_loss = (recon - samples).abs().mean(dim=(1, 2, 3))
        recon_loss = recon_loss + point_loss * (cfg.point_loss_weight
                                                * decay(step, cfg.point_loss_warmup_steps))
        logvar = model.get_recon_loss_logvar()
        total = (recon_loss / torch.exp(logvar) + logvar).mean()
        reg_w = warmup(step, cfg.latents_regularization_warmup_steps)
        logs: Dict[str, torch.Tensor] = {"loss_recon": recon_loss.mean(),
                                         "loss_point": point_loss.mean(),
                                         "recon_loss_logvar": logvar}

        if cfg.phase_invariance_loss_weight > 0:
            with torch.no_grad():
                alt = mel_view(model, fmt.mdct_to_raw(fmt.raw_to_mdct(audio, draws.phase_theta)))
            latents2 = model.encode(alt, training=False)
            pi = phase_invariance_loss(latents, latents2.float()) / 2.0
            total = total + pi.mean() * cfg.phase_invariance_loss_weight * reg_w
            logs["loss_phase_invariance"] = pi.mean()
        if cfg.latents_dispersion_loss_weight > 0:
            disp = latents_dispersion_loss(latents)
            total = total + disp.mean() * cfg.latents_dispersion_loss_weight * reg_w
            logs["loss_dispersion"] = disp.mean()

        var = pre_norm.square().mean(dim=(0, 1, 2)) + 1e-20
        kl = (var - 1.0 - torch.log(var)).mean() + (
            pre_norm.mean(dim=(0, 1, 2)).square().mean() * cfg.kl_mean_weight)
        total = total + kl * (cfg.kl_loss_weight * warmup(step, cfg.kl_warmup_steps))
        logs["loss_kl"] = kl
        logs["latents_var"] = latents.var(correction=0)
        logs["latents_mean"] = latents.mean()
        return total, {k: v.detach() for k, v in logs.items()}, recon_loss.detach()

    def train_step(state: TrainState, batch: Dict[str, Any],
                   draws: Optional[List[DAEMicroDraws]] = None) -> Dict[str, Any]:
        model = state.module
        audio = batch["audio"]
        n = audio.shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        mb = n // accum
        if draws is None:
            draws = draw_dae_step(state.generator, cfg, mb)
        optimizer.zero_grad()
        loss_sum = 0.0
        logs_seq: Dict[str, List[torch.Tensor]] = {}
        sample_losses = []
        for i in range(accum):
            loss, logs, per_sample = loss_fn(model, audio[i * mb:(i + 1) * mb], draws[i],
                                             state.global_step)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in logs.items():
                logs_seq.setdefault(k, []).append(v)
            sample_losses.append(per_sample)
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
        out = {k: torch.stack(v).mean() for k, v in logs_seq.items()}
        out.update(loss=loss_sum / accum, grad_norm=optimizer.clip.last_grad_norm,
                   sample_losses=torch.cat(sample_losses))
        return out

    return train_step
