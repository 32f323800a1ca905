"""The DAE, DDEC and joint DAE + DDEC trainers (JAX:
dualdiffusion_tpu/training/module_trainers.py; reference:
src/training/module_trainers/dae_p1_trainer.py:228-431,
ddec_q4_trainer.py:46-145, trainer.py:204-209).

The DAE step, as the JAX step: per microbatch, a random stereo flip, the
label embedding of the batch's ``audio_embeddings`` where it has them, the
samples (``domain="mel"``, the p1 trainer: the mel spectrogram;
``domain="mdct"``, the m1 trainer: the MDCT of a random phase rotation),
cropped by ``crop_edges`` and cut to a multiple of the DAE's downsample
ratio, the DAE's training forward (which moves its latent stats), the
recon loss (MSS2D, fused through K5/K6 with ``use_fused_mss2d``, or the
randomized-prime MSS with ``use_random_prime_mss``; plus the prime-width
1-D MSS over the width axis with ``mss1d_prime_loss_weight``) plus a
decaying point L1, its NLL under the learned logvar, the phase-invariance
term (a second encode, with ``training=False``, of another phase rotation
of the same audio: its mel, or in the MDCT domain the rotated MDCT
itself), optional dispersion and latent shift-equivariance, and
KL-to-unit-variance on the pre-norm latents; then the summed gradients /
accum -> clip -> the optimizer -> forced MP weight norm -> EMA of the
parameters and the stats buffers.

The DDEC step is the UNet diffusion step over a prepare stage that uses the
frozen DAE as its teacher: stereo flip, MDCT with a per-sample phase
rotation, back to raw, the mel, the DAE's reconstruction, the edge crop,
``mel_spec_to_linear`` as the conditioning and the MDCT as the target. The
joint step trains both modules under one optimizer, the DDEC conditioned on
the live DAE reconstruction.

Each step's random draws (stereo flips, phase angles, noise) are made apart
from its arithmetic, from the state's ``torch.Generator``, so a test can
pass in the draws of JAX's key splits. The JAX phase rotation lines its (B,)
angles up with the channel axis (per sample only at B = 1, an error at B > 2
unless B = C); the port rotates each sample by its own angle.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.mp import normalize
from ..ops.kernels import mss2d_loss_fused
from .ema import EMABank
from .losses import (PRIME_BLOCK_STEPS_1D, PRIME_BLOCK_WIDTHS_1D, EquivarianceLossConfig,
                     MSSLoss2D, MSSLoss2DConfig, PrimeMSSDraws, draw_equivariance_offsets,
                     draw_random_prime_mss, equivariance_loss, latents_dispersion_loss,
                     phase_invariance_loss, prime_mss_1d, random_prime_mss_2d)
from .optim import Optimizer, normalize_mp_weights
from .sigma_sampler import SigmaSampler
from .train_state import (TrainState, UNetTrainConfig, make_unet_eval_step,
                          make_unet_train_step)


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
    domain: str = "mel"               # "mel" (p1) | "mdct" (m1)
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
    phase_theta: Optional[torch.Tensor]   # (b,) the phase-invariance view's MDCT angles
    mdct_theta: Optional[torch.Tensor] = None   # (b,) the m1 samples' MDCT angles
    prime_mss: Optional[PrimeMSSDraws] = None   # the randomized-prime MSS's draws
    #: each sample's equivariance crop offsets (yo, xo), on the host
    equivariance: Optional[Tuple[List[int], List[int]]] = None

    def to(self, device) -> "DAEMicroDraws":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in ("stereo_flip", "phase_theta", "mdct_theta")
            if getattr(self, k) is not None})


def _draw_flip_theta(generator: torch.Generator, b: int, flip: bool,
                     theta: bool) -> DAEMicroDraws:
    dev = generator.device
    return DAEMicroDraws(
        torch.rand((b,), generator=generator, device=dev) < 0.5 if flip else None,
        torch.rand((b,), generator=generator, device=dev) * (2 * np.pi) if theta else None)


def draw_dae_step(generator: torch.Generator, config: DAETrainConfig, micro_batch: int,
                  sample_hw: Optional[Tuple[int, int]] = None) -> List[DAEMicroDraws]:
    """Every random number one DAE train step uses, from ``generator``;
    ``sample_hw`` is the samples' (rows, frames) after the crop and
    alignment, which the randomized-prime MSS's draws need."""
    cfg = config
    draws = []
    for _ in range(cfg.grad_accum_steps):
        d = _draw_flip_theta(generator, micro_batch, cfg.random_stereo_augmentation,
                             cfg.phase_invariance_loss_weight > 0)
        if cfg.domain == "mdct":
            d.mdct_theta = torch.rand((micro_batch,), generator=generator,
                                      device=generator.device) * (2 * np.pi)
        if cfg.use_random_prime_mss:
            d.prime_mss = draw_random_prime_mss(generator, *sample_hw)
        if cfg.equivariance_loss_weight > 0:
            d.equivariance = draw_equivariance_offsets(generator, micro_batch)
        draws.append(d)
    return draws


def _check_config(cfg: DAETrainConfig) -> None:
    if cfg.domain not in ("mel", "mdct"):
        raise ValueError(f"DAETrainConfig.domain must be 'mel' or 'mdct', not {cfg.domain!r}")
    if cfg.use_fused_mss2d and cfg.mss2d.use_midside_transform not in ("stack", "none"):
        raise ValueError("the fused MSS2D takes midside 'stack' or 'none'")


def make_dae_train_step(fmt, optimizer: Optimizer, ema_bank: Optional[EMABank],
                        config: DAETrainConfig, total_batch_size: int):
    """Build ``train_step(state, batch, draws=None) -> logs`` over
    ``state.module``, a DAE; it updates ``state`` in place. ``batch``:
    {"audio": (B, C, T), "audio_embeddings": (B, E) optional}, B = device
    batch x grad_accum_steps."""
    cfg = config
    _check_config(cfg)
    mss = MSSLoss2D(cfg.mss2d)
    c = cfg.crop_edges
    accum = cfg.grad_accum_steps

    def warmup(step: int, n: int) -> float:
        return 1.0 if n <= 0 else min(step / n, 1.0)

    def decay(step: int, n: int) -> float:
        return 0.0 if n <= 0 else max(1.0 - step / n, 0.0)

    def crop_align(model, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, c:-c] if c > 0 else x
        ds = model.downsample_ratio
        return x[:, :, : x.shape[2] // ds * ds]

    def sample_view(model, audio: torch.Tensor, theta: Optional[torch.Tensor]) -> torch.Tensor:
        """The samples (mel) or, in the MDCT domain, the MDCT rotated by ``theta``."""
        if cfg.domain == "mel":
            return crop_align(model, fmt.raw_to_mel_spec(audio))
        return crop_align(model, fmt.raw_to_mdct(audio, theta))

    def alt_view(model, audio: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """The phase-invariance view: the rotated MDCT, as a mel in the mel domain."""
        mdct = fmt.raw_to_mdct(audio, theta)
        if cfg.domain == "mel":
            return crop_align(model, fmt.raw_to_mel_spec(fmt.mdct_to_raw(mdct)))
        return crop_align(model, mdct)

    sample_hw: Dict[Tuple[int, ...], Tuple[int, int]] = {}

    @torch.no_grad()
    def sample_hw_of(model, audio: torch.Tensor) -> Tuple[int, int]:
        """The samples' (rows, frames) for audio of this shape, from one silent clip."""
        key = tuple(audio.shape[1:])
        if key not in sample_hw:
            silent = audio.new_zeros((1,) + key)
            sample_hw[key] = tuple(sample_view(model, silent, silent.new_zeros(1)).shape[1:3])
        return sample_hw[key]

    def loss_fn(model, audio: torch.Tensor, emb_in: Optional[torch.Tensor],
                draws: DAEMicroDraws, step: int):
        audio = audio.float()
        if cfg.random_stereo_augmentation:
            audio = random_stereo_augmentation(audio, draws.stereo_flip)
        dae_emb = (model.get_embeddings(normalize(emb_in.float(), dim=-1))
                   if emb_in is not None else None)
        with torch.no_grad():
            samples = sample_view(model, audio, draws.mdct_theta)
        latents, recon, pre_norm = model(samples, dae_emb, training=True)

        s_cf = samples.permute(0, 3, 1, 2)
        r_cf = recon.float().permute(0, 3, 1, 2)
        if cfg.use_random_prime_mss:
            recon_loss = random_prime_mss_2d(r_cf, s_cf, draws.prime_mss)
        elif cfg.use_fused_mss2d:
            recon_loss = mss2d_loss_fused(
                r_cf, s_cf, block_widths=cfg.mss2d.block_widths,
                block_overlap=cfg.mss2d.block_overlap,
                use_midside=cfg.mss2d.use_midside_transform == "stack")
        else:
            recon_loss = mss(r_cf, s_cf)
        if cfg.mss1d_prime_loss_weight > 0:
            # over the width (time) axis of (B, C*H, W), block widths capped at W
            s1 = s_cf.reshape(s_cf.shape[0], -1, s_cf.shape[-1])
            r1 = r_cf.reshape(r_cf.shape[0], -1, r_cf.shape[-1])
            bws = tuple(b for b in PRIME_BLOCK_WIDTHS_1D if b <= s1.shape[-1])
            recon_loss = recon_loss + prime_mss_1d(
                r1, s1, bws, PRIME_BLOCK_STEPS_1D[:len(bws)]) * cfg.mss1d_prime_loss_weight
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
                alt = alt_view(model, audio, draws.phase_theta)
            latents2 = model.encode(alt, dae_emb, training=False)
            pi = phase_invariance_loss(latents, latents2.float()) / 2.0
            total = total + pi.mean() * cfg.phase_invariance_loss_weight * reg_w
            logs["loss_phase_invariance"] = pi.mean()
        if cfg.latents_dispersion_loss_weight > 0:
            disp = latents_dispersion_loss(latents)
            total = total + disp.mean() * cfg.latents_dispersion_loss_weight * reg_w
            logs["loss_dispersion"] = disp.mean()
        if cfg.equivariance_loss_weight > 0:
            eq_cfg = EquivarianceLossConfig(levels=int(np.log2(model.downsample_ratio)) + 1)
            eq = equivariance_loss(lambda m: model.encode(m, dae_emb, training=False), samples,
                                   latents.float(), draws.equivariance, eq_cfg)
            total = total + eq.mean() * cfg.equivariance_loss_weight * reg_w
            logs["loss_equivariance"] = eq.mean()

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
        emb = batch.get("audio_embeddings")
        n = audio.shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        mb = n // accum
        if draws is None:
            hw = sample_hw_of(model, audio) if cfg.use_random_prime_mss else None
            draws = draw_dae_step(state.generator, cfg, mb, hw)
        optimizer.zero_grad()
        loss_sum = 0.0
        logs_seq: Dict[str, List[torch.Tensor]] = {}
        sample_losses = []
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss, logs, per_sample = loss_fn(model, audio[sl], None if emb is None else emb[sl],
                                             draws[i], state.global_step)
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


# ---------------------------------------------------------------------------
# the DDEC trainer (JAX module_trainers.py:56-120)
# ---------------------------------------------------------------------------

@dataclass
class DDECTrainConfig:
    """Field names and defaults of the JAX DDECTrainConfig."""
    unet: UNetTrainConfig = field(default_factory=UNetTrainConfig)
    random_stereo_augmentation: bool = True
    random_phase_augmentation: bool = True
    crop_edges: int = 4
    #: the ddecmp_p4 variant: condition on the ground-truth mel, not the DAE's
    condition_on_ground_truth: bool = False


#: the DDEC prepare stage's draws for one microbatch: the DAE step's two
DDECPrepareDraws = DAEMicroDraws


def ddec_prepare_drawer(config: DDECTrainConfig):
    """``draw(generator, b) -> DDECPrepareDraws`` for ``config``."""
    def draw(generator: torch.Generator, b: int) -> DDECPrepareDraws:
        return _draw_flip_theta(generator, b, config.random_stereo_augmentation,
                                config.random_phase_augmentation)
    return draw


def make_ddec_prepare(fmt, dae, config: DDECTrainConfig):
    """``prepare(batch, draws) -> {"samples", "ref_samples", "embeddings"?}``:
    the DDEC's training target (the MDCT, cropped) and conditioning (the
    linear PSD of the frozen DAE's reconstruction of the mel), both (b, bins,
    frames, C). Run it without gradients. The DAE gets no label embedding, as
    JAX `build_ddec_trainer` passes none."""
    c = config.crop_edges

    def prepare(batch: Dict[str, Any], draws: DDECPrepareDraws) -> Dict[str, Any]:
        audio = batch["audio"].float()
        if config.random_stereo_augmentation:
            audio = random_stereo_augmentation(audio, draws.stereo_flip)
        # back to raw from the rotated MDCT, so the target and the
        # conditioning share the same phases
        mdct = fmt.raw_to_mdct(audio, draws.phase_theta
                               if config.random_phase_augmentation else None)
        mel = fmt.raw_to_mel_spec(fmt.mdct_to_raw(mdct))
        ds = dae.downsample_ratio
        mel = mel[:, :, : mel.shape[2] // ds * ds]
        recon = mel if config.condition_on_ground_truth else dae(mel, training=False)[1]
        recon = recon[:, :, c:-c] if c > 0 else recon
        lin = fmt.mel_spec_to_linear(recon.float())
        target = mdct[:, :, c:-c] if c > 0 else mdct
        out = {"samples": target[:, :, : lin.shape[2]], "ref_samples": lin}
        if batch.get("audio_embeddings") is not None:
            out["embeddings"] = batch["audio_embeddings"]
        return out
    return prepare


def no_embeddings(model, emb_in, mask) -> None:
    """The DDEC has no label embedding (JAX module_trainers.py:115-116)."""
    return None


def _ddec_unet_config(config: DDECTrainConfig) -> UNetTrainConfig:
    # cropping happens in the prepare stage
    return dataclasses.replace(config.unet, crop_edges=0)


def make_ddec_train_step(fmt, dae, optimizer: Optimizer, ema_bank: Optional[EMABank],
                         config: DDECTrainConfig, total_batch_size: int):
    """The UNet diffusion step over ``state.module``, a DDEC, on the frozen
    ``dae``'s prepare stage. ``batch``: {"audio": (B, C, T),
    "audio_embeddings": optional}; ``draws`` a ``StepDraws`` whose
    microbatches carry ``DDECPrepareDraws``."""
    return make_unet_train_step(optimizer, ema_bank, _ddec_unet_config(config),
                                total_batch_size, prepare_fn=make_ddec_prepare(fmt, dae, config),
                                draw_prepare=ddec_prepare_drawer(config),
                                get_embeddings=no_embeddings)


def make_ddec_eval_step(fmt, dae, config: DDECTrainConfig):
    """The validation loss of a DDEC on the frozen ``dae``'s prepare stage."""
    return make_unet_eval_step(_ddec_unet_config(config), make_ddec_prepare(fmt, dae, config),
                               ddec_prepare_drawer(config), no_embeddings)


@torch.no_grad()
def ddec_sample_shape(fmt, dae, config: DDECTrainConfig, audio_shape) -> Tuple[int, ...]:
    """The prepared samples' shape (b, bins, frames, C) for audio of
    ``audio_shape`` (b, C, T), found by running the format on one silent
    clip on the CPU."""
    b, ch, t = audio_shape
    mdct = fmt.raw_to_mdct(torch.zeros((1, ch, t)))
    mel = fmt.raw_to_mel_spec(fmt.mdct_to_raw(mdct))
    c, ds = config.crop_edges, dae.downsample_ratio
    width = min(mel.shape[2] // ds * ds, mdct.shape[2]) - 2 * c
    return (b, mdct.shape[1], width, mdct.shape[3])


# ---------------------------------------------------------------------------
# joint DAE + DDEC training (JAX module_trainers.py:350-480)
# ---------------------------------------------------------------------------

@dataclass
class JointDAEDDECConfig:
    """Field names and defaults of the JAX JointDAEDDECConfig."""
    dae: DAETrainConfig = field(default_factory=DAETrainConfig)
    ddec: DDECTrainConfig = field(default_factory=DDECTrainConfig)
    dae_loss_weight: float = 1.0
    ddec_loss_weight: float = 1.0
    grad_accum_steps: int = 1


@dataclass
class JointMicroDraws:
    """One joint microbatch's draws (None where off or not drawn yet)."""
    stereo_flip: Optional[torch.Tensor]   # (b,) bool
    phase_theta: Optional[torch.Tensor]   # (b,) MDCT rotation angles
    noise: Optional[torch.Tensor]         # N(0, 1), the DDEC target's shape

    def to(self, device) -> "JointMicroDraws":
        return JointMicroDraws(*(None if t is None else t.to(device)
                                 for t in (self.stereo_flip, self.phase_theta, self.noise)))


@dataclass
class JointStepDraws:
    quantiles: torch.Tensor               # (total_batch,), permuted
    micro: List[JointMicroDraws]

    def to(self, device) -> "JointStepDraws":
        return JointStepDraws(self.quantiles.to(device), [m.to(device) for m in self.micro])


def draw_joint_step(generator: torch.Generator, config: JointDAEDDECConfig,
                    total_batch_size: int, noise_shape) -> JointStepDraws:
    """Every random number one joint step uses, from ``generator``, in the
    order the step draws them itself; ``noise_shape`` is a microbatch's DDEC
    target shape (``ddec_sample_shape``)."""
    sampler = SigmaSampler(config.ddec.unet.sigma)
    q = sampler.draw_quantiles(generator, total_batch_size)
    draw = ddec_prepare_drawer(config.ddec)
    micro = []
    for _ in range(config.grad_accum_steps):
        d = draw(generator, noise_shape[0])
        noise = torch.randn(tuple(noise_shape), generator=generator, device=generator.device)
        micro.append(JointMicroDraws(d.stereo_flip, d.phase_theta, noise))
    return JointStepDraws(q, micro)


def make_joint_dae_ddec_train_step(fmt, optimizer: Optimizer, ema_bank: Optional[EMABank],
                                   config: JointDAEDDECConfig, total_batch_size: int):
    """Build ``train_step(state, batch, draws=None) -> logs`` over
    ``state.module``, an ``nn.ModuleDict`` of "dae" and "ddec"; it updates
    ``state`` in place. One optimizer, one gradient clip, the forced MP
    weight norm and the EMA cover both modules (the EMA the DAE's stats
    too). The DAE's losses are its recon NLL (the unfolded MSS2D) and KL;
    the DDEC's diffusion loss is conditioned on the DAE's live
    reconstruction, so its gradient reaches the DAE. The sigmas come from
    the state's pdf, which the joint step never updates (as in JAX).
    ``batch``: {"audio": (B, C, T)}."""
    cfg = config
    dae_cfg, ddec_cfg = cfg.dae, cfg.ddec
    mss = MSSLoss2D(dae_cfg.mss2d)
    sampler = SigmaSampler(ddec_cfg.unet.sigma)
    draw_prepare = ddec_prepare_drawer(ddec_cfg)
    c = ddec_cfg.crop_edges
    sd = ddec_cfg.unet.sigma.sigma_data
    accum = cfg.grad_accum_steps

    def loss_fn(dae, ddec, audio: torch.Tensor, sigma: torch.Tensor, d: JointMicroDraws,
                step: int, generator: torch.Generator):
        audio = audio.float()
        if ddec_cfg.random_stereo_augmentation:
            audio = random_stereo_augmentation(audio, d.stereo_flip)
        mdct = fmt.raw_to_mdct(audio, d.phase_theta
                               if ddec_cfg.random_phase_augmentation else None)
        with torch.no_grad():
            mel = fmt.raw_to_mel_spec(fmt.mdct_to_raw(mdct))
            ds = dae.downsample_ratio
            mel = mel[:, :, : mel.shape[2] // ds * ds]
        _, recon_mel, pre_norm = dae(mel, training=True)

        recon_loss = mss(recon_mel.float().permute(0, 3, 1, 2), mel.permute(0, 3, 1, 2))
        logvar = dae.get_recon_loss_logvar()
        dae_loss = (recon_loss / torch.exp(logvar) + logvar).mean()
        var = pre_norm.float().square().mean(dim=(0, 1, 2)) + 1e-20
        kl = (var - 1.0 - torch.log(var)).mean()
        dae_loss = dae_loss + kl * (dae_cfg.kl_loss_weight
                                    * min(step / max(dae_cfg.kl_warmup_steps, 1), 1.0))

        recon_c = recon_mel[:, :, c:-c] if c > 0 else recon_mel
        lin = fmt.mel_spec_to_linear(recon_c.float())
        target = (mdct[:, :, c:-c] if c > 0 else mdct)[:, :, : lin.shape[2]].detach()
        noise = d.noise
        if noise is None:
            noise = torch.randn(target.shape, generator=generator, device=generator.device)
        sig = sigma.reshape(-1, 1, 1, 1)
        denoised = ddec(target + noise.to(target.device) * sig, sigma, None, lin, training=True)
        weight = (sig ** 2 + sd ** 2) / (sig * sd) ** 2
        w_loss = ((denoised - target) ** 2 * weight).mean(dim=(1, 2, 3))
        dd_logvar = ddec.get_sigma_loss_logvar(sigma).reshape(-1)
        ddec_loss = (w_loss / torch.exp(dd_logvar) + dd_logvar).mean()
        total = dae_loss * cfg.dae_loss_weight + ddec_loss * cfg.ddec_loss_weight
        return total, dae_loss.detach(), ddec_loss.detach()

    def train_step(state: TrainState, batch: Dict[str, Any],
                   draws: Optional[JointStepDraws] = None) -> Dict[str, Any]:
        module = state.module
        dae, ddec = module["dae"], module["ddec"]
        audio = batch["audio"]
        n = audio.shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        mb = n // accum
        gen = state.generator
        quantiles = (draws.quantiles if draws is not None
                     else sampler.draw_quantiles(gen, total_batch_size))
        sigma_all = sampler.sample(quantiles, state.sigma_pdf)[:n]
        optimizer.zero_grad()
        loss_sum = 0.0
        dae_losses, ddec_losses = [], []
        for i in range(accum):
            if draws is not None:
                d = draws.micro[i]
            else:
                p = draw_prepare(gen, mb)
                d = JointMicroDraws(p.stereo_flip, p.phase_theta, None)
            sl = slice(i * mb, (i + 1) * mb)
            loss, ld, ldd = loss_fn(dae, ddec, audio[sl], sigma_all[sl], d, state.global_step,
                                    gen)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            dae_losses.append(ld)
            ddec_losses.append(ldd)
        with torch.no_grad():
            for p in optimizer.params:
                if p.grad is not None:
                    p.grad.div_(accum)
        optimizer.step(state.global_step)
        normalize_mp_weights(module)
        if ema_bank is not None:
            ema_bank.update(state.ema_state, module, state.total_samples_processed,
                            total_batch_size, state.global_step)
        state.global_step += 1
        state.total_samples_processed += total_batch_size
        return {"loss": loss_sum / accum, "grad_norm": optimizer.clip.last_grad_norm,
                "loss_dae": torch.stack(dae_losses).mean(),
                "loss_ddec": torch.stack(ddec_losses).mean()}

    return train_step
