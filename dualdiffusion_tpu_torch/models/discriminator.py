"""The CLAP-conditioned discriminator, on stereo-folded (B, Z, H, W, C)
samples (JAX: dualdiffusion_tpu/models/discriminator.py; reference:
src/modules/discs/disc_j3.py:44-210, disc.py:32-49).

A stack of embedding-modulated MP blocks of rank-3 convs (W reflect padded;
kz = 1 folds Z into the batch, on cuDNN) with a learned sigmoid residual
balance, a constant channel appended at the input with a learned gain and
shift, and a per-block KL penalty on the hidden activations summed over the
blocks: ``forward(samples, embeddings) -> (logits_map, hidden_kld (B,))``.
As for the VAE, the JAX package creates the label conditioning only when
its init runs an embedding, and the port loads a directory without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Set, Tuple

import torch
import torch.nn as nn

from .layers import MPConv
from .mp import mp_silu, normalize


@dataclass
class DiscriminatorConfig:
    """Field names and defaults of the JAX DiscriminatorConfig."""
    in_channels: int = 1
    in_channels_emb: int = 1024
    in_num_freqs: int = 256
    model_channels: int = 32
    channel_mult_emb: int = 12
    num_layers: int = 6
    mlp_multiplier: int = 2
    mlp_groups: int = 1
    clip_act: float = 256.0
    kernel: Tuple[int, int, int] = (1, 3, 3)


class DiscBlock(nn.Module):
    """(JAX discriminator.py:44-84)."""

    def __init__(self, cfg: DiscriminatorConfig, in_channels: int, out_channels: int,
                 emb_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.emb_channels = emb_channels
        c_mid = out_channels * cfg.mlp_multiplier
        kernel = tuple(cfg.kernel)
        self.conv_res0 = MPConv(in_channels, c_mid, kernel, groups=cfg.mlp_groups,
                                w_pad_mode="reflect", device=device)
        if emb_channels > 0:
            self.emb_gain = nn.Parameter(torch.zeros((), device=device))
            self.emb_linear = MPConv(emb_channels, c_mid, (), device=device)
        self.conv_res1 = MPConv(c_mid, out_channels, kernel, groups=cfg.mlp_groups,
                                w_pad_mode="reflect", device=device)
        self.conv_skip = (MPConv(in_channels, out_channels, (1, 1, 1), device=device)
                          if in_channels != out_channels or cfg.mlp_groups > 1 else None)
        # the residual balance's logit, init -0.7: sigmoid ~ 0.33 (reference :139)
        self.res_balance = nn.Parameter(torch.full((), -0.7, device=device))

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor],
                training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.conv_res0(mp_silu(x), training=training)
        if self.emb_channels > 0 and emb is not None:
            c = self.emb_linear(emb, gain=self.emb_gain, training=training) + 1.0
            y = y * c.reshape((c.shape[0],) + (1,) * (y.dim() - 2) + (c.shape[-1],)).to(y.dtype)
        y = self.conv_res1(mp_silu(y), training=training)
        if self.conv_skip is not None:
            x = self.conv_skip(x, training=training)
        t = torch.sigmoid(self.res_balance)
        x = (x + (y - x) * t) / torch.sqrt((1 - t) ** 2 + t ** 2)
        if self.cfg.clip_act is not None:
            x = x.clamp(-self.cfg.clip_act, self.cfg.clip_act)
        # the hidden-activation KL penalty (reference :160-164), var as torch's (ddof 1)
        dims = tuple(range(1, x.dim()))
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, correction=1).clamp_min(1e-2)
        return x, mean.square() + var - 1.0 - torch.log(var)


class Discriminator(nn.Module):
    """(B, Z, H, W, C) samples -> (logits_map (B, Z, H, W, 1), hidden_kld (B,))."""

    def __init__(self, cfg: DiscriminatorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kernel = tuple(cfg.kernel)
        cemb = cfg.model_channels * cfg.channel_mult_emb if cfg.in_channels_emb > 0 else 0
        if cfg.in_channels_emb > 0:
            self.emb_label = MPConv(cfg.in_channels_emb, cemb, (), device=device)
        self.input_gain = nn.Parameter(torch.ones((), device=device))
        self.input_shift = nn.Parameter(torch.zeros((), device=device))
        self.conv_in = MPConv(cfg.in_channels + 1, cfg.model_channels, kernel,
                              w_pad_mode="reflect", device=device)
        self.blocks = nn.ModuleList(
            DiscBlock(cfg, cfg.model_channels, cfg.model_channels, cemb, device=device)
            for _ in range(cfg.num_layers))
        self.conv_out = MPConv(cfg.model_channels, 1, kernel, w_pad_mode="reflect",
                               device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Discriminator":
        """The JAX init: N(0, 1) conv weights, input gain 1, shift 0, block
        embedding gains 0, residual balance logits -0.7."""
        for m in self.modules():
            if isinstance(m, MPConv):
                m.init_weights(generator)
            elif isinstance(m, DiscBlock):
                m.res_balance.fill_(-0.7)
                if m.emb_channels > 0:
                    m.emb_gain.zero_()
        self.input_gain.fill_(1.0)
        self.input_shift.zero_()
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
            elif isinstance(m, DiscBlock) and m.emb_channels > 0:
                m.emb_gain.zero_()

    def get_embeddings(self, emb_in: torch.Tensor,
                       training: bool = False) -> Optional[torch.Tensor]:
        """The blocks' conditioning; unlike the UNet's and DAE's it is not
        activated (reference disc_j3.py:221-225)."""
        if self.cfg.in_channels_emb <= 0:
            return None
        return self.emb_label(normalize(emb_in, dim=-1), training=training)

    def forward(self, samples: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
                training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([samples, samples.new_ones(samples.shape[:-1] + (1,))], dim=-1)
        x = self.conv_in(x, gain=self.input_gain, training=training) + self.input_shift
        kld = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, k = block(x, embeddings, training=training)
            kld = kld + k
        return self.conv_out(x, training=training), kld
