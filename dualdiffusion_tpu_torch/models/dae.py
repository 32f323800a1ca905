"""DAE, the stage-1 autoencoder, channel last: encode, decode and the
training forward (JAX: dualdiffusion_tpu/models/dae.py:140-333; reference:
src/modules/daes/dae_edm2_q4.py:91-405).

The latent stats tracker (the flax "stats" collection) is four buffers,
moved in place by a training-mode ``encode``. ``training`` re-normalizes
every MP weight in the forward, as the JAX package does. A supersampled
(d3-series) DAE keeps its encoder at full resolution and pools the latent
projection by the decoder's downsample ratio; a label-conditioned one
(``in_channels_emb > 0``) modulates every block by its embedding. The
training forward adds latent noise (``latents_sigma`` times a noise tensor
the caller draws). ``tiled_encode`` encodes a long mel in overlapping chunks
(the dataset factory's encode, JAX dae.py:336-375) and ``top_pca_components``
projects latents on their principal components (JAX dae.py:378-396).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

import torch
import torch.nn as nn

from ..utils.trace import span
from .layers import MPConv
from .mp import mp_silu, mp_sum, normalize, normalize_groups, resample_2d


@dataclass
class DAEConfig:
    """Field names and defaults of dualdiffusion_tpu.models.dae.DAEConfig."""
    in_channels: int = 2
    out_channels: int = 2
    in_channels_emb: int = 0
    in_num_freqs: int = 256
    latent_channels: int = 8

    model_channels: int = 64
    channel_mult_enc: Tuple[int, ...] = (1, 2, 4, 8)
    channel_mult_dec: Tuple[int, ...] = (1, 2, 4, 8)
    channel_mult_emb: int = 4
    num_enc_layers_per_block: int = 3
    num_dec_layers_per_block: int = 3
    res_balance: float = 0.3
    clip_act: float = 256.0
    mlp_multiplier: int = 2
    mlp_groups: int = 1
    emb_linear_groups: int = 1
    add_pixel_norm: bool = False
    latent_stats_momentum: float = 0.99
    supersampled: bool = False
    compute_dtype: str = "bfloat16"
    #: TPU-only (W-axis lane packing); only the default is taken
    w_pack_channels: int = 0


class DAEBlock(nn.Module):
    """MP residual block (JAX dae.py:69-137)."""

    def __init__(self, cfg: DAEConfig, in_channels: int, out_channels: int,
                 emb_channels: int, flavor: str = "enc", resample_mode: str = "keep",
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.flavor = flavor
        self.resample_mode = resample_mode
        self.emb_channels = emb_channels
        c_mid = out_channels * cfg.mlp_multiplier
        c_in0 = out_channels if flavor == "enc" else in_channels
        self.conv_skip = (MPConv(in_channels, out_channels, (1, 1), device=device)
                          if in_channels != out_channels else None)
        self.conv_res0 = MPConv(c_in0, c_mid, (3, 3), groups=cfg.mlp_groups, device=device)
        self.conv_res1 = MPConv(c_mid, out_channels, (3, 3), groups=cfg.mlp_groups,
                                device=device)
        if emb_channels > 0:
            self.emb_gain = nn.Parameter(torch.zeros((), device=device))
            self.emb_linear = MPConv(emb_channels, c_mid, (), groups=cfg.emb_linear_groups,
                                     device=device)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None,
                training: bool = False) -> torch.Tensor:
        cfg = self.cfg
        x = resample_2d(x, self.resample_mode)
        if self.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x, training=training)
            if cfg.add_pixel_norm:
                x = normalize(x, dim=-1)
        # no activation before conv_res0 (dae_edm2_q4.py:180)
        y = self.conv_res0(x, training=training)
        if self.emb_channels > 0 and emb is not None:
            c = self.emb_linear(emb, gain=self.emb_gain, training=training) + 1.0
            y = y * c[:, None, None, :].to(y.dtype)
        y = self.conv_res1(mp_silu(normalize_groups(y, cfg.mlp_groups)), training=training)
        if self.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x, training=training)
        x = mp_sum(x, y, t=cfg.res_balance)
        if cfg.clip_act is not None:
            x = x.clamp(-cfg.clip_act, cfg.clip_act)
        return x


class DAE(nn.Module):
    """Stage-1 autoencoder. Latents: (B, H/ds, W/ds, latent_channels)."""

    def __init__(self, cfg: DAEConfig, device=None):
        super().__init__()
        if cfg.w_pack_channels != 0:
            raise NotImplementedError("DAEConfig.w_pack_channels is TPU-only; use 0")
        self.cfg = cfg
        enc_ch = [cfg.model_channels * m for m in cfg.channel_mult_enc]
        dec_ch = [cfg.model_channels * m for m in cfg.channel_mult_dec]
        if not cfg.supersampled and len(enc_ch) != len(dec_ch):
            raise ValueError("asymmetric enc/dec levels require supersampled=True")
        cemb = (cfg.model_channels * cfg.channel_mult_emb * cfg.mlp_multiplier
                if cfg.in_channels_emb > 0 else 0)
        if cemb:
            self.emb_label = MPConv(cfg.in_channels_emb, cemb, (), device=device)

        self.conv_in = MPConv(cfg.in_channels, enc_ch[0], (5, 5), use_bias=True, device=device)
        enc = []
        cin = enc_ch[0]
        # a supersampled encoder's levels all keep the full resolution
        down = "keep" if cfg.supersampled else "down"
        for level, cout in enumerate(enc_ch):
            if level > 0:
                enc.append(DAEBlock(cfg, cin, cout, cemb, "enc", down, device=device))
            for _ in range(cfg.num_enc_layers_per_block):
                enc.append(DAEBlock(cfg, cout, cout, cemb, "enc", device=device))
            cin = cout
        self.enc = nn.ModuleList(enc)
        self.conv_latents_out = MPConv(enc_ch[-1], cfg.latent_channels, (3, 3), device=device)
        self.conv_latents_in = MPConv(cfg.latent_channels, dec_ch[-1], (3, 3), use_bias=True,
                                      device=device)
        dec = []
        cin = dec_ch[-1]
        for level in reversed(range(len(dec_ch))):
            cout = dec_ch[level]
            mode = "keep" if level == len(dec_ch) - 1 else "up"
            dec.append(DAEBlock(cfg, cin, cout, cemb, "dec", mode, device=device))
            for _ in range(cfg.num_dec_layers_per_block):
                dec.append(DAEBlock(cfg, cout, cout, cemb, "dec", device=device))
            cin = cout
        self.dec = nn.ModuleList(dec)
        self.conv_out = MPConv(dec_ch[0], cfg.out_channels, (5, 5), device=device)
        self.out_gain = nn.Parameter(torch.ones((), device=device))
        self.recon_loss_logvar = nn.Parameter(torch.zeros((), device=device))
        lc = cfg.latent_channels
        # the latent stats tracker's state (the flax "stats" collection)
        self.register_buffer("latents_mean", torch.zeros(lc, device=device))
        self.register_buffer("latents_var", torch.ones(lc, device=device))
        self.register_buffer("latents_global_mean", torch.zeros((), device=device))
        self.register_buffer("latents_global_var", torch.ones((), device=device))

    @property
    def num_levels(self) -> int:
        return len(self.cfg.channel_mult_dec)

    @property
    def downsample_ratio(self) -> int:
        return 2 ** (self.num_levels - 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DAE":
        for m in self.modules():
            if isinstance(m, MPConv):
                m.init_weights(generator)
        return self

    def label_embedding_keys(self) -> Set[str]:
        """The state keys of the label conditioning (``emb_label`` and every
        block's ``emb_gain`` and ``emb_linear``). The JAX package creates
        these parameters only when its init runs them, so a DAE that JAX's
        ``create_new_model`` wrote has none of them."""
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
            elif isinstance(m, DAEBlock) and m.emb_channels > 0:
                m.emb_gain.zero_()

    def get_embeddings(self, emb_in: torch.Tensor,
                       training: bool = False) -> Optional[torch.Tensor]:
        """The blocks' conditioning from a label embedding (B, in_channels_emb);
        None for a DAE without label conditioning."""
        if self.cfg.in_channels_emb <= 0:
            return None
        return mp_silu(self.emb_label(normalize(emb_in, dim=-1), training=training))

    def get_latent_shape(self, sample_shape: Sequence[int]) -> Tuple[int, ...]:
        b, h, w, _ = sample_shape
        ds = self.downsample_ratio
        return (b, h // ds, w // ds, self.cfg.latent_channels)

    def get_sample_shape(self, latent_shape: Sequence[int]) -> Tuple[int, ...]:
        """The sample shape a (B, h, w, C) latent decodes to (JAX dae.py:229-232)."""
        b, h, w, _ = latent_shape
        ds = self.downsample_ratio
        return (b, h * ds, w * ds, self.cfg.out_channels)

    def get_recon_loss_logvar(self) -> torch.Tensor:
        return self.recon_loss_logvar

    def normalize_latents(self, latents: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        """(x - tracked mean) / tracked std."""
        std = torch.sqrt(self.latents_var + eps)
        return ((latents - self.latents_mean) / std).to(latents.dtype)

    def unnormalize_latents(self, latents: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        std = torch.sqrt(self.latents_var + eps)
        return (latents * std + self.latents_mean).to(latents.dtype)

    def encode(self, x: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
               training: bool = False, stats_axis=None) -> torch.Tensor:
        """(B, H, W, in_channels) -> (B, H/ds, W/ds, latent_channels) fp32.
        ``training`` also moves the latent stats buffers, by the statistics
        of the global batch over ``stats_axis`` (the data axis) where given."""
        x = x.to(getattr(torch, self.cfg.compute_dtype))
        x = self.conv_in(x, training=training)
        for block in self.enc:
            x = block(x, embeddings, training=training)
        latents = self.conv_latents_out(x, training=training).float()
        if self.cfg.supersampled and self.downsample_ratio > 1:
            # pool after the projection (reference dae_edm2_d3.py:349)
            latents = resample_2d(latents, "down", ratio=self.downsample_ratio)
        if training:
            self._track_stats(latents, stats_axis)
        return latents

    @torch.no_grad()
    def _track_stats(self, latents: torch.Tensor, axis=None) -> None:
        """EMA (momentum ``latent_stats_momentum``) of the per-channel and
        global mean and unbiased variance, in place; over the global batch of
        ``axis`` where given."""
        m = self.cfg.latent_stats_momentum
        lx = latents.detach().float()
        dims = (0, 1, 2)
        if axis is None or axis.size == 1:
            stats = (lx.mean(dim=dims), lx.var(dim=dims, correction=1), lx.mean(),
                     lx.var(correction=1))
        else:
            def mean_var(d, n):
                mean = axis.mean_of(lx.mean(dim=d))
                n = n * axis.size
                return mean, axis.mean_of((lx - mean).square().mean(dim=d)) * (n / (n - 1))
            stats = (mean_var(dims, lx.numel() // lx.shape[-1])
                     + mean_var((0, 1, 2, 3), lx.numel()))
        for buf, new in zip((self.latents_mean, self.latents_var, self.latents_global_mean,
                             self.latents_global_var), stats):
            buf.copy_(buf * m + new * (1 - m))

    def decode(self, latents: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
               training: bool = False) -> torch.Tensor:
        """(B, h, w, latent_channels) -> (B, h*ds, w*ds, out_channels) fp32."""
        with span("dd.model.forward"):
            x = latents.to(getattr(torch, self.cfg.compute_dtype))
            x = self.conv_latents_in(x, training=training)
            for block in self.dec:
                x = block(x, embeddings, training=training)
            return self.conv_out(x, gain=self.out_gain, training=training).float()

    def forward(self, samples: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
                latents_sigma: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, training: bool = True,
                stats_axis=None):
        """Training forward: (latents, reconstruction, pre-norm latents). With
        ``latents_sigma`` and ``noise`` (N(0, 1), the latents' shape) the
        decoder sees the latents plus ``latents_sigma * noise``;
        ``stats_axis`` as in ``encode``."""
        pre_norm = self.encode(samples, embeddings, training=training, stats_axis=stats_axis)
        latents = pre_norm
        if latents_sigma is not None and noise is not None:
            latents = latents + latents_sigma * noise.to(latents.dtype)
        recon = self.decode(latents, embeddings, training=training)
        return latents, recon, pre_norm


def tiled_encode_plan(width: int, downsample_ratio: int, max_chunk: int = 6144,
                      overlap: int = 256) -> List[Tuple[int, int, int, int, int, int]]:
    """The chunks ``tiled_encode`` encodes a mel of ``width`` frames in, as
    (chunk start, chunk end) in mel frames, (keep start, keep end) in the
    chunk's latent columns and (start, end) of where they go in the whole
    latents. Chunks of ``max_chunk`` frames step by ``max_chunk - 2 *
    overlap``; a last chunk shorter than ``3 * overlap`` starts earlier; each
    inner seam drops ``overlap // ratio`` latent columns on either side. One
    chunk when the mel fits in ``max_chunk`` (JAX dae.py:336-375)."""
    ds = downsample_ratio
    if max_chunk % ds or overlap % ds or width % ds:
        raise ValueError(f"max_chunk {max_chunk}, overlap {overlap} and width {width} must be "
                         f"multiples of the downsample ratio {ds}")
    if width <= max_chunk:
        return [(0, width, 0, width // ds, 0, width // ds)]
    out_overlap = overlap // ds
    min_chunk = overlap * 3
    plan = []
    for w_start in range(0, width, max_chunk - overlap * 2):
        c0, c1 = w_start, min(width, w_start + max_chunk)
        if c1 - c0 < min_chunk:
            c0 -= min_chunk - (c1 - c0)
        first, last = w_start == 0, c1 == width
        n = (c1 - c0) // ds
        v0 = 0 if first else out_overlap
        v1 = n if last else n - out_overlap
        plan.append((c0, c1, v0, v1, c0 // ds + v0, c0 // ds + v1))
    return plan


@torch.inference_mode()
def tiled_encode(dae: DAE, x: torch.Tensor, embeddings: Optional[torch.Tensor] = None,
                 max_chunk: int = 6144, overlap: int = 256) -> torch.Tensor:
    """``dae.encode`` of a (B, H, W, C) mel over the chunks of
    ``tiled_encode_plan``, each chunk's inner-seam columns dropped: (B, H/ds,
    W/ds, latent_channels) fp32."""
    ds = dae.downsample_ratio
    plan = tiled_encode_plan(x.shape[2], ds, max_chunk, overlap)
    if len(plan) == 1:
        return dae.encode(x, embeddings).float()
    latents = x.new_zeros((x.shape[0], x.shape[1] // ds, x.shape[2] // ds,
                           dae.cfg.latent_channels), dtype=torch.float32)
    for c0, c1, v0, v1, d0, d1 in plan:
        latents[:, :, d0:d1] = dae.encode(x[:, :, c0:c1], embeddings)[:, :, v0:v1]
    return latents


@torch.no_grad()
def top_pca_components(x: torch.Tensor, n_pca: int = 4) -> torch.Tensor:
    """Per-sample PCA of channel-last latents (B, H, W, C): the centered
    latents projected on their top ``n_pca`` principal directions, (B, H, W,
    n_pca) fp32. A direction's sign is the SVD's, so it may differ between
    implementations."""
    b, h, w, c = x.shape
    n_pca = min(n_pca, c)
    flat = x.reshape(b, h * w, c).float()
    centered = flat - flat.mean(dim=1, keepdim=True)
    _, _, vh = torch.linalg.svd(centered, full_matrices=False)
    return (centered @ vh[:, :n_pca].transpose(1, 2)).reshape(b, h, w, n_pca)
