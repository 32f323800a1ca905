"""The legacy KL VAE with uniform target SNR, channel last (JAX:
dualdiffusion_tpu/models/vae.py; reference: src/modules/old/vaes/
vae_edm2.py:48,151-271).

MP-conv encoder and decoder of embedding-modulated blocks, a constant
channel and the normalized ln-frequency channel appended to both inputs,
and latents with one fixed noise logvar, log(1 / (snr^2 + 1)), whose
``latents_out_gain`` starts at the matching sample std. The JAX package
creates the label conditioning (``emb_label``, each block's ``emb_gain``
and ``emb_linear``) only when its init runs an embedding; the port always
has it, and loads a directory without it as the DAE does
(``weights.load_flat``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from .layers import MPConv
from .mp import mp_silu, mp_sum, normalize, resample_2d


class IsotropicGaussianDistribution:
    """Latents N(mean, exp(logvar)) with one shared scalar logvar."""

    def __init__(self, mean: torch.Tensor, logvar: torch.Tensor):
        self.mean = mean
        self.logvar = logvar

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; the noise is given, or drawn from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=generator.device if generator is not None
                                else self.mean.device)
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(self.mean)

    def kl(self) -> torch.Tensor:
        """KL(N(mean, var) || N(0, 1)) per sample."""
        var = torch.exp(self.logvar)
        return 0.5 * (self.mean.square() + var - 1.0 - self.logvar).sum(
            dim=tuple(range(1, self.mean.dim())))


@dataclass
class VAEConfig:
    """Field names and defaults of dualdiffusion_tpu.models.vae.VAEConfig."""
    in_channels: int = 2
    out_channels: int = 2
    latent_channels: int = 4
    label_dim: int = 512
    model_channels: int = 64
    channel_mult: Tuple[int, ...] = (1, 2, 3, 5)
    channel_mult_emb: Optional[int] = None
    num_layers_per_block: int = 2
    res_balance: float = 0.3
    mlp_multiplier: int = 1
    mlp_groups: int = 1
    target_snr: float = 32.0


class VAEBlock(nn.Module):
    """The old-style EDM2 block (reference: old/vaes/vae_edm2.py:51-149):
    mp_silu before conv_res0, the encoder's pixel norm always, the embedding
    modulation followed by mp_silu (JAX vae.py:66-110)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 flavor: str = "enc", resample_mode: str = "keep", res_balance: float = 0.3,
                 mlp_multiplier: int = 1, clip_act: float = 256.0, device=None):
        super().__init__()
        self.flavor = flavor
        self.resample_mode = resample_mode
        self.res_balance = res_balance
        self.clip_act = clip_act
        self.emb_channels = emb_channels
        c_mid = out_channels * mlp_multiplier
        c_in0 = out_channels if flavor == "enc" else in_channels
        self.conv_skip = (MPConv(in_channels, out_channels, (1, 1), device=device)
                          if in_channels != out_channels else None)
        self.conv_res0 = MPConv(c_in0, c_mid, (3, 3), device=device)
        if emb_channels > 0:
            self.emb_gain = nn.Parameter(torch.zeros((), device=device))
            self.emb_linear = MPConv(emb_channels, c_mid, (), device=device)
        self.conv_res1 = MPConv(c_mid, out_channels, (3, 3), device=device)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None,
                training: bool = False) -> torch.Tensor:
        x = resample_2d(x, self.resample_mode)
        if self.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x, training=training)
            x = normalize(x, dim=-1)
        y = self.conv_res0(mp_silu(x), training=training)
        if self.emb_channels > 0 and emb is not None:
            c = self.emb_linear(emb, gain=self.emb_gain, training=training) + 1.0
            y = y * c[:, None, None, :].to(y.dtype)
        y = self.conv_res1(mp_silu(y), training=training)
        if self.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x, training=training)
        return mp_sum(x, y, t=self.res_balance).clamp(-self.clip_act, self.clip_act)


class VAE(nn.Module):
    """AutoencoderKL with uniform-target-SNR latents:
    (B, H, W, in_channels) -> latents (B, H/ds, W/ds, latent_channels)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        cblock = [cfg.model_channels * m for m in cfg.channel_mult]
        cemb = (cfg.model_channels * cfg.channel_mult_emb if cfg.channel_mult_emb
                else max(cblock))
        self.emb_label = MPConv(cfg.label_dim, cemb, (), device=device)
        self.recon_loss_logvar = nn.Parameter(torch.zeros((), device=device))
        bkw = dict(emb_channels=cemb, res_balance=cfg.res_balance,
                   mlp_multiplier=cfg.mlp_multiplier, device=device)
        # the encoder's down blocks keep the previous level's channels; the
        # layer blocks make the channel transition (reference :182-200)
        self.conv_in = MPConv(cfg.in_channels + 2, cblock[0], (3, 3), device=device)
        enc, cout = [], cblock[0]
        for level, ch in enumerate(cblock):
            if level > 0:
                enc.append(VAEBlock(cout, cout, flavor="enc", resample_mode="down", **bkw))
            for _ in range(cfg.num_layers_per_block):
                enc.append(VAEBlock(cout, ch, flavor="enc", **bkw))
                cout = ch
        self.enc = nn.ModuleList(enc)
        self.conv_latents_out = MPConv(cout, cfg.latent_channels, (3, 3), device=device)
        self.latents_out_gain = nn.Parameter(torch.zeros((), device=device))
        self.out_gain = nn.Parameter(torch.ones((), device=device))
        # the decoder: two mid blocks at the deepest level, up blocks keep the
        # channels, num_layers + 1 layer blocks a level (reference :205-222)
        self.conv_latents_in = MPConv(cfg.latent_channels + 2, cblock[-1], (3, 3),
                                      device=device)
        dec, cout = [], cblock[-1]
        for level, ch in reversed(list(enumerate(cblock))):
            if level == len(cblock) - 1:
                dec += [VAEBlock(cout, cout, flavor="dec", **bkw) for _ in range(2)]
            else:
                dec.append(VAEBlock(cout, cout, flavor="dec", resample_mode="up", **bkw))
            for _ in range(cfg.num_layers_per_block + 1):
                dec.append(VAEBlock(cout, ch, flavor="dec", **bkw))
                cout = ch
        self.dec = nn.ModuleList(dec)
        self.conv_out = MPConv(cout, cfg.out_channels, (3, 3), device=device)
        self.reset_gains()

    @torch.no_grad()
    def reset_gains(self) -> None:
        """The JAX init of the scalar parameters: the latents' gain at the
        target sample std (reference :168-171), the output gain 1, the
        blocks' embedding gains and the recon logvar 0."""
        noise_std = float(np.sqrt(1.0 / (self.cfg.target_snr ** 2 + 1)))
        self.latents_out_gain.fill_(float(np.sqrt(1.0 - noise_std ** 2)))
        self.out_gain.fill_(1.0)
        self.recon_loss_logvar.zero_()
        for m in self.modules():
            if isinstance(m, VAEBlock) and m.emb_channels > 0:
                m.emb_gain.zero_()

    @property
    def num_levels(self) -> int:
        return len(self.cfg.channel_mult)

    @property
    def downsample_ratio(self) -> int:
        return 2 ** (self.num_levels - 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VAE":
        for m in self.modules():
            if isinstance(m, MPConv):
                m.init_weights(generator)
        self.reset_gains()
        return self

    def label_embedding_keys(self) -> Set[str]:
        """The state keys the JAX package creates only when its init runs an
        embedding."""
        return {k for k in self.state_dict()
                if k.startswith("emb_label.") or ".emb_gain" in k or ".emb_linear." in k}

    @torch.no_grad()
    def init_label_embedding(self, generator: torch.Generator) -> None:
        """Fresh label conditioning: normalized N(0, 1) weights and zero
        block gains, under which an embedding leaves every block as it is."""
        for name, m in self.named_modules():
            if name == "emb_label" or name.endswith(".emb_linear"):
                m.init_weights(generator)
                m.weight.copy_(normalize(m.weight))
            elif isinstance(m, VAEBlock) and m.emb_channels > 0:
                m.emb_gain.zero_()

    def get_embeddings(self, emb_in: torch.Tensor, training: bool = False) -> torch.Tensor:
        return mp_silu(self.emb_label(normalize(emb_in, dim=-1), training=training))

    def get_recon_loss_logvar(self) -> torch.Tensor:
        return self.recon_loss_logvar

    def get_target_snr(self) -> float:
        return self.cfg.target_snr

    def get_latent_shape(self, sample_shape: Sequence[int]) -> Tuple[int, ...]:
        b, h, w, _ = sample_shape
        ds = self.downsample_ratio
        return (b, h // ds, w // ds, self.cfg.latent_channels)

    @staticmethod
    def _aux_channels(x: torch.Tensor, ln_freqs: Optional[torch.Tensor]) -> torch.Tensor:
        """x with a constant ones channel and the normalized ln-frequency
        channel appended (reference :259-268)."""
        ones = x.new_ones(x.shape[:-1] + (1,))
        if ln_freqs is None:
            lf = np.log(np.linspace(20.0, 16000.0, x.shape[1]))
            ln_freqs = torch.as_tensor((lf - lf.mean()) / lf.std(), dtype=x.dtype,
                                       device=x.device)
        pos = ln_freqs.to(x)[None, :, None, None].expand(x.shape[:-1] + (1,))
        return torch.cat([x, ones, pos], dim=-1)

    def encode(self, x: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
               ln_freqs: Optional[torch.Tensor] = None,
               training: bool = False) -> IsotropicGaussianDistribution:
        x = self.conv_in(self._aux_channels(x, ln_freqs), training=training)
        for block in self.enc:
            x = block(x, embeddings, training=training)
        latents = self.conv_latents_out(x, gain=self.latents_out_gain, training=training)
        noise_logvar = torch.tensor(np.log(1.0 / (self.cfg.target_snr ** 2 + 1)),
                                    dtype=torch.float32, device=latents.device)
        return IsotropicGaussianDistribution(latents, noise_logvar)

    def decode(self, latents: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
               ln_freqs: Optional[torch.Tensor] = None, training: bool = False) -> torch.Tensor:
        x = self.conv_latents_in(self._aux_channels(latents, ln_freqs), training=training)
        for block in self.dec:
            x = block(x, embeddings, training=training)
        return self.conv_out(x, gain=self.out_gain, training=training)

    def forward(self, x: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, training: bool = True):
        """-> (latents, reconstruction, distribution). The latents are a
        sample of the distribution when ``generator`` or ``noise`` is given
        (JAX: a ``key``), else its mode."""
        dist = self.encode(x, embeddings, training=training)
        latents = (dist.sample(generator, noise) if generator is not None or noise is not None
                   else dist.mode())
        return latents, self.decode(latents, embeddings, training=training), dist
