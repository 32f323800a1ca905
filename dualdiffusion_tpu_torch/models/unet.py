"""EDM2 magnitude-preserving UNet, channel last
(JAX: dualdiffusion_tpu/models/unet.py:115-709; reference:
src/modules/unets/unet_edm2_d1.py, unet_edm2_q4_ddec.py).

The 2-D path takes (B, H, W, C); with ``use_3d`` the stereo-folded path
takes (B, Z, H, W, C), its convs rank-3 (``io_kernel_z``, ``skip_kernel_z``;
the res convs (1, 3, 3)), its resampling on H and W only, its attention
over Z*H*W ("full"), H ("freq") or W ("time"). EDM2 preconditioning is
in-model, with bf16 activations and fp32 io. Module and parameter names
mirror the JAX package's flax paths, so ``weights.py`` maps one onto the
other by rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.mel import hz_to_mel, mel_to_hz
from ..utils.trace import span
from .attention import scaled_dot_product_attention
from .layers import MPConv, MPFourier, rematerialized
from .mp import mp_cat, mp_silu, mp_sum, normalize, resample_2d, resample_3d

#: the trunk's activation dtype (JAX unet.py:562)
ACT_DTYPE = torch.bfloat16


@dataclass
class UNetConfig:
    """Field names and defaults of dualdiffusion_tpu.models.unet.UNetConfig."""
    in_channels: int = 4
    out_channels: int = 4
    in_channels_emb: int = 0
    in_num_freqs: int = 256
    in_psd_freqs: int = 0

    sigma_max: float = 200.0
    sigma_min: float = 0.03
    sigma_data: float = 1.0

    model_channels: int = 64
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    channel_mult_noise: Optional[int] = None
    channel_mult_emb: Optional[int] = None
    num_layers_per_block: int = 2
    attn_levels: Tuple[int, ...] = ()
    attn_axis: Literal["freq", "time", "full"] = "freq"
    midblock_attn: bool = False
    double_midblock: bool = False
    channels_per_head: int = 64
    label_balance: float = 0.5
    concat_balance: float = 0.5
    res_balance: float = 0.3
    attn_balance: float = 0.3
    clip_act: float = 256.0
    mlp_multiplier: int = 1
    mlp_groups: int = 1
    emb_linear_groups: int = 1
    dropout: float = 0.0
    logvar_channels: int = 128
    use_3d: bool = False
    input_kernel: Tuple[int, int] = (3, 3)
    io_kernel_z: int = 1
    skip_kernel_z: int = 2
    io_bias: bool = True
    always_skip: bool = False
    conv_w_pad: str = "zeros"
    add_constant_channel: bool = False
    add_ln_freqs_channel: bool = False
    #: recompute each UNetBlock's activations in the backward (training
    #: only): a training forward keeps each block's input instead of its
    #: internals, for one more forward of the blocks (JAX unet.py:99-103)
    remat_blocks: bool = False
    #: TPU-only (W-axis lane packing); only the default is taken
    w_pack_channels: int = 0


def _check_supported(cfg: UNetConfig) -> None:
    if cfg.w_pack_channels != 0:
        raise NotImplementedError(f"UNetConfig.w_pack_channels={cfg.w_pack_channels!r} "
                                  f"is not ported")


def _conv_kernel(cfg: UNetConfig, k: Tuple[int, int], kz: int = 1) -> Tuple[int, ...]:
    """(kh, kw), or (kz, kh, kw) under ``use_3d`` (JAX unet.py:115-116)."""
    return ((kz,) + tuple(k)) if cfg.use_3d else tuple(k)


def mp_dropout(y: torch.Tensor, p: float, keep: torch.Tensor) -> torch.Tensor:
    """Magnitude-preserving dropout on the kept positions ``keep`` (JAX
    unet.py:260-264; reference: unet_edm2_d1.py:186-187)."""
    return torch.where(keep, y / (1.0 - p), 0.0) * (1.0 - p) ** 0.5


def _bcast(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, C) -> (B, 1, ..., 1, C) against an ``ndim``-d activation."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 2) + (c.shape[-1],))


def default_ln_freqs(num_freqs: int) -> np.ndarray:
    """ln of ``num_freqs`` mel-spaced centres from 20 Hz to 16 kHz, the
    endpoints dropped (JAX unet.py:597-601)."""
    m = np.linspace(hz_to_mel(20.0), hz_to_mel(16000.0), num_freqs + 2)[1:-1]
    return np.log(mel_to_hz(m))


def build_schedule(cfg: UNetConfig):
    """(name, kind, level, cin, cout) of each op in execution order (JAX
    unet.py:389-434). The input conv takes the PSD fold's channels
    (``in_psd_freqs // in_num_freqs`` per input channel) and the constant
    and ln-freq channels beside the sample's."""
    cblock = [cfg.model_channels * m for m in cfg.channel_mult]
    cout = cfg.in_channels
    if cfg.in_psd_freqs > 0:
        cout += (cfg.in_psd_freqs // cfg.in_num_freqs) * cfg.in_channels
    cout += int(cfg.add_constant_channel) + int(cfg.add_ln_freqs_channel)
    ops, skip_ch = [], []
    for level, channels in enumerate(cblock):
        if level == 0:
            ops.append(("enc_conv_in", "enc_in", 0, cout, channels))
            cout = channels
        else:
            ops.append((f"enc_b{level}_down", "enc_down", level, cout, cout))
        skip_ch.append(cout)
        for idx in range(cfg.num_layers_per_block):
            ops.append((f"enc_b{level}_l{idx}", "enc_layer", level, cout, channels))
            cout = channels
            skip_ch.append(cout)
    for level, channels in reversed(list(enumerate(cblock))):
        if level == len(cblock) - 1:
            ops.append((f"dec_b{level}_in0", "dec_mid", level, cout, cout))
            if cfg.double_midblock:
                ops.append((f"dec_b{level}_in1", "dec_mid", level, cout, cout))
        else:
            ops.append((f"dec_b{level}_up", "dec_up", level, cout, cout))
        for idx in range(cfg.num_layers_per_block + 1):
            sc = skip_ch.pop()
            ops.append((f"dec_b{level}_l{idx}", "dec_layer", level, cout + sc, channels))
            cout = channels
    ops.append(("conv_out", "conv_out", 0, cout, cfg.out_channels))
    return ops


class UNetBlock(nn.Module):
    """Emb-modulated MP residual block with optional freq/time/full
    self-attention (JAX unet.py:155-360)."""

    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int,
                 emb_channels: int, flavor: str = "enc", resample_mode: str = "keep",
                 use_attention: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.emb_channels = emb_channels
        self.flavor = flavor
        self.resample_mode = resample_mode
        self.use_attention = use_attention
        c_mid = out_channels * cfg.mlp_multiplier
        c_in_res0 = out_channels if flavor == "enc" else in_channels
        if cfg.always_skip or in_channels != out_channels:
            kz = cfg.skip_kernel_z if cfg.use_3d else 1
            self.conv_skip = MPConv(in_channels, out_channels, _conv_kernel(cfg, (1, 1), kz),
                                    device=device)
        else:
            self.conv_skip = None
        k3 = _conv_kernel(cfg, (3, 3))
        self.conv_res0 = MPConv(c_in_res0, c_mid, k3, groups=cfg.mlp_groups,
                                w_pad_mode=cfg.conv_w_pad, device=device)
        self.conv_res1 = MPConv(c_mid, out_channels, k3, groups=cfg.mlp_groups,
                                w_pad_mode=cfg.conv_w_pad, device=device)
        if emb_channels > 0:
            self.emb_gain = nn.Parameter(torch.zeros((), device=device))
            self.emb_linear = MPConv(emb_channels, c_mid, (), groups=cfg.emb_linear_groups,
                                     device=device)
        if use_attention:
            ch = out_channels
            k1 = _conv_kernel(cfg, (1, 1))
            self.attn_qk = MPConv(ch, ch * 2, k1, device=device)
            self.attn_v = MPConv(ch, ch, k1, device=device)
            self.attn_proj = MPConv(ch, ch, k1, device=device)
            if emb_channels > 0:
                self.emb_gain_qk = nn.Parameter(torch.zeros((), device=device))
                self.emb_linear_qk = MPConv(emb_channels, ch, (), device=device)
                self.emb_gain_v = nn.Parameter(torch.zeros((), device=device))
                self.emb_linear_v = MPConv(emb_channels, ch, (), device=device)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor],
                training: bool = False,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator`` draws the dropout keep mask (training with
        ``cfg.dropout > 0``); None draws from torch's default generator."""
        cfg = self.cfg
        x = (resample_3d if cfg.use_3d else resample_2d)(x, self.resample_mode)
        if self.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x, training=training)
            x = normalize(x, dim=-1)
        y = self.conv_res0(mp_silu(x), training=training)
        if self.emb_channels > 0 and emb is not None:
            c = self.emb_linear(emb, gain=self.emb_gain, training=training) + 1.0
            y = y * _bcast(c, y.dim()).to(y.dtype)
        y = mp_silu(y)
        if cfg.dropout > 0 and training:
            keep = torch.rand(y.shape, generator=dropout_generator, device=y.device)
            y = mp_dropout(y, cfg.dropout, keep < 1.0 - cfg.dropout)
        y = self.conv_res1(y, training=training)
        if self.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x, training=training)
        x = mp_sum(x, y, t=cfg.res_balance)
        if self.use_attention:
            x = self._attention(x, emb, training)
        if cfg.clip_act is not None:
            x = x.clamp(-cfg.clip_act, cfg.clip_act)
        return x

    def _modulation(self, name: str, emb: Optional[torch.Tensor], x: torch.Tensor,
                    training: bool):
        if self.emb_channels > 0 and emb is not None:
            c = getattr(self, f"emb_linear_{name}")(emb, gain=getattr(self, f"emb_gain_{name}"),
                                                   training=training)
            c = c + 1.0
            return _bcast(c, x.dim()).to(x.dtype)
        return 1.0

    def _attention(self, x: torch.Tensor, emb: Optional[torch.Tensor],
                   training: bool) -> torch.Tensor:
        """q/k-normalized SDPA with emb-modulated qk and v gains."""
        cfg = self.cfg
        ch = self.out_channels
        num_heads = max(ch // cfg.channels_per_head, 1)
        qk = self.attn_qk(x * self._modulation("qk", emb, x, training), training=training)
        v = self.attn_v(x, training=training)
        b = x.shape[0]
        # the H axis, moved beside C for "freq" (batch' = B * [Z *] W)
        h_ax = 2 if cfg.use_3d else 1
        freq_perm = [d for d in range(x.dim()) if d != h_ax]
        freq_perm.insert(x.dim() - 2, h_ax)

        def to_seq(t: torch.Tensor) -> torch.Tensor:
            if cfg.attn_axis == "full":   # sequence = [Z *] H * W
                return t.reshape(b, -1, t.shape[-1])
            if cfg.attn_axis == "freq":   # sequence = H
                return t.permute(freq_perm).reshape(-1, t.shape[h_ax], t.shape[-1])
            return t.reshape(-1, t.shape[-2], t.shape[-1])  # "time": sequence = W

        qk_s, v_s = to_seq(qk), to_seq(v)
        bs, seq = qk_s.shape[:2]
        hd = ch // num_heads
        qk_h = qk_s.reshape(bs, seq, num_heads, 2, hd)
        q = normalize(qk_h[..., 0, :], dim=-1)
        k = normalize(qk_h[..., 1, :], dim=-1)
        vh = normalize(v_s.reshape(bs, seq, num_heads, hd), dim=-1)
        y = scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         vh.transpose(1, 2), scale=1.0 / np.sqrt(hd),
                                         training=training)
        y = y.transpose(1, 2).to(x.dtype).reshape(bs, seq, ch)
        if cfg.attn_axis == "freq":
            lead = [x.shape[d] for d in freq_perm[:-2]]
            y = y.reshape(lead + [seq, ch]).permute(np.argsort(freq_perm).tolist())
        else:
            y = y.reshape(x.shape[:-1] + (ch,))
        y = mp_silu(y * self._modulation("v", emb, x, training))
        y = self.attn_proj(y, training=training)
        return mp_sum(x, y, t=cfg.attn_balance)


def remat_block(block: UNetBlock, x: torch.Tensor, emb: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, emb, True, generator)`` under a non-reentrant
    ``checkpoint`` (JAX's ``nn.remat`` of the block): the forward keeps the
    block's inputs alone and the backward runs the block again. ``checkpoint``
    restores torch's default generators for the recompute, never one passed
    in, so the recompute draws its dropout masks from a copy of
    ``generator`` at its state before the block; ``generator`` advances once,
    as without remat."""
    state = generator.get_state() if generator is not None else None
    recompute = False

    def run(x, emb):
        nonlocal recompute
        g = generator
        if recompute and generator is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(state)
        recompute = True
        with rematerialized():
            return block(x, emb, True, g)

    return checkpoint(run, x, emb, use_reentrant=False)


class UNetCore(nn.Module):
    """EDM2-preconditioned MP-UNet trunk (JAX unet.py:363-638)."""

    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        cblock = [cfg.model_channels * m for m in cfg.channel_mult]
        cemb = (cfg.model_channels * cfg.channel_mult_emb if cfg.channel_mult_emb
                else max(cblock)) * cfg.mlp_multiplier
        cnoise = (cfg.model_channels * cfg.channel_mult_noise if cfg.channel_mult_noise
                  else max(cblock))
        self.schedule = build_schedule(cfg)
        self.emb_fourier = MPFourier(cnoise, device=device)
        self.emb_noise = MPConv(cnoise, cemb, (), device=device)
        for name, kind, level, cin, cout in self.schedule:
            if kind == "enc_in":
                mod = MPConv(cin, cout, _conv_kernel(cfg, cfg.input_kernel, cfg.io_kernel_z),
                             use_bias=cfg.io_bias, w_pad_mode=cfg.conv_w_pad, device=device)
            elif kind == "conv_out":
                mod = MPConv(cin, cout, _conv_kernel(cfg, (3, 3), cfg.io_kernel_z),
                             w_pad_mode=cfg.conv_w_pad, device=device)
            else:
                flavor = "enc" if kind.startswith("enc") else "dec"
                resample = {"enc_down": "down", "dec_up": "up"}.get(kind, "keep")
                attn = cfg.midblock_attn if kind == "dec_mid" else level in cfg.attn_levels
                mod = UNetBlock(cfg, cin, cout, cemb, flavor=flavor, resample_mode=resample,
                                use_attention=attn, device=device)
            self.add_module(name, mod)
        self.out_gain = nn.Parameter(torch.zeros((), device=device))

    def precondition(self, x_in: torch.Tensor, sigma: torch.Tensor,
                     embeddings: Optional[torch.Tensor], x_ref: Optional[torch.Tensor] = None,
                     training: bool = False, x_perturbed: Optional[torch.Tensor] = None,
                     ln_freqs: Optional[torch.Tensor] = None):
        """EDM2 preconditioning, the PSD fold, the constant and ln-freq
        channels and the noise/label embedding. Returns (x, emb, c_skip, c_out).
        ``x_ref`` is the PSD conditioning (B, psd_bins, W, C) of a model with
        ``in_psd_freqs``, else the inpainting reference and mask channels
        (B, H, W, out_channels + 1). ``x_perturbed`` (training-time input perturbation)
        replaces ``x_in`` as the network input only; the c_skip path keeps
        ``x_in`` (JAX unet.py:570). ``ln_freqs`` (H,) are the log
        frequencies of the ln-freq channel, standardized here (default:
        ``default_ln_freqs``)."""
        with span("dd.model.precondition"):
            cfg = self.cfg
            sigma = sigma.reshape((-1,) + (1,) * (x_in.dim() - 1)).float()
            sd = cfg.sigma_data
            c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
            c_out = sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)
            c_in = 1.0 / torch.sqrt(sd ** 2 + sigma ** 2)
            c_noise = torch.log(sigma.reshape(-1)) / 4.0
            net_in = x_in if x_perturbed is None else x_perturbed
            x = (c_in * net_in.float()).to(ACT_DTYPE)
            if x_ref is not None and cfg.in_psd_freqs > 0:
                # (B, pbins, W, C) -> (B, pbins / per, W, per * C): the per PSD
                # rows under each model row become channels, row-major over
                # (row, C); the row count follows the ref (JAX unet.py:573-582)
                b, pbins, w, c = x_ref.shape
                per = cfg.in_psd_freqs // cfg.in_num_freqs
                r = x_ref.reshape(b, pbins // per, per, w, c).permute(0, 1, 3, 2, 4)
                r = r.reshape(b, pbins // per, w, per * c)
                x = mp_cat(x, r.to(ACT_DTYPE), dim=-1, t=cfg.label_balance)
            elif x_ref is not None:
                # the inpainting reference and mask as extra input channels (JAX
                # unet.py:583-587; models/convert.py sizes the input conv)
                x = torch.cat([x, x_ref.to(ACT_DTYPE)], dim=-1)
            if cfg.add_constant_channel:
                x = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)],
                              dim=-1)
            if cfg.add_ln_freqs_channel:
                # the standardized ln-freq positional channel, broadcast along H
                # (JAX unet.py:595-608)
                h_ax = 2 if cfg.use_3d else 1
                if ln_freqs is None:
                    ln_freqs = torch.as_tensor(default_ln_freqs(x.shape[h_ax]))
                lf = ln_freqs.to(device=x.device, dtype=torch.float32)
                lf = (lf - lf.mean()) / lf.std(correction=0)
                shape = [1] * x.dim()
                shape[h_ax] = x.shape[h_ax]
                pos = lf.reshape(shape).expand(x.shape[:-1] + (1,)).to(x.dtype)
                x = torch.cat([x, pos], dim=-1)
            emb = self.emb_noise(self.emb_fourier(c_noise), training=training)
            if cfg.in_channels_emb > 0 and embeddings is not None:
                emb = mp_silu(mp_sum(emb, embeddings.to(emb.dtype), t=cfg.label_balance))
            return x, emb.to(ACT_DTYPE), c_skip, c_out

    def run_ops(self, x: torch.Tensor, emb: torch.Tensor, skips: Sequence[torch.Tensor],
                lo: int = 0, hi: Optional[int] = None, training: bool = False,
                dropout_generator: Optional[torch.Generator] = None):
        """Run ops [lo, hi) of ``self.schedule`` (the whole trunk by default)
        on the trunk input ``x`` after ``precondition`` (JAX unet.py:483-546,
        without its W-packing). ``skips`` are the skip activations alive
        before op ``lo``: the encoder ops push theirs, each ``dec_layer``
        pops one. Returns (x, skips). A pipeline stage runs its own range on
        a core that holds only that range's modules
        (``parallel/unet_pipeline.py``). With ``cfg.remat_blocks``, a
        training forward under autograd runs each ``UNetBlock`` through
        ``remat_block``; ``dec_layer``'s concatenation with its skip stays
        outside, as in JAX, where it is the block's input."""
        cfg = self.cfg
        hi = len(self.schedule) if hi is None else hi
        skips = list(skips)
        drop = dropout_generator
        remat = cfg.remat_blocks and training and torch.is_grad_enabled()

        def block(mod, x):
            return remat_block(mod, x, emb, drop) if remat else mod(x, emb, training, drop)

        for name, kind, _, _, _ in self.schedule[lo:hi]:
            mod = getattr(self, name)
            with span("dd.model.block"):
                if kind == "enc_in":
                    x = mod(x, training=training)
                    skips.append(x)
                elif kind in ("enc_down", "enc_layer"):
                    x = block(mod, x)
                    skips.append(x)
                elif kind in ("dec_mid", "dec_up"):
                    x = block(mod, x)
                elif kind == "dec_layer":
                    x = block(mod, mp_cat(x, skips.pop(), dim=-1, t=cfg.concat_balance))
                else:
                    x = mod(x, gain=self.out_gain, training=training)
        return x, skips

    def forward(self, x_in: torch.Tensor, sigma: torch.Tensor,
                embeddings: Optional[torch.Tensor] = None,
                x_ref: Optional[torch.Tensor] = None, training: bool = False,
                x_perturbed: Optional[torch.Tensor] = None,
                ln_freqs: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        div = 1 << (len(cfg.channel_mult) - 1)
        h, w = x_in.shape[-3], x_in.shape[-2]
        if h % div or w % div:
            raise ValueError(f"UNet input H,W=({h},{w}) must be divisible by {div} "
                             f"(2^(levels-1), {len(cfg.channel_mult)} levels)")
        with span("dd.model.forward"):
            x, emb, c_skip, c_out = self.precondition(x_in, sigma, embeddings, x_ref, training,
                                                      x_perturbed, ln_freqs)
            x, _ = self.run_ops(x, emb, [], training=training,
                                dropout_generator=dropout_generator)
            return c_skip * x_in.float() + c_out * x.float()


class UNet(nn.Module):
    """MP-UNet with its label-embedding heads (JAX unet.py:641-709)."""

    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.core = UNetCore(cfg, device=device)
        cblock = [cfg.model_channels * m for m in cfg.channel_mult]
        cemb = (cfg.model_channels * cfg.channel_mult_emb if cfg.channel_mult_emb
                else max(cblock)) * cfg.mlp_multiplier
        if cfg.in_channels_emb > 0:
            self.emb_label = MPConv(cfg.in_channels_emb, cemb, (), device=device)
            self.emb_label_unconditional = MPConv(1, cemb, (), device=device)
        self.logvar_fourier = MPFourier(cfg.logvar_channels, device=device)
        self.logvar_linear = MPConv(cfg.logvar_channels, 1, (), disable_weight_norm=True,
                                    zero_init=True, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UNet":
        """Random init from ``generator``, as the JAX package initializes:
        N(0, 1) MP weights, zero gains."""
        for m in self.modules():
            if isinstance(m, MPConv):
                m.init_weights(generator)
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith(("emb_gain", "out_gain")):
                p.zero_()
        return self

    def forward(self, x_in: torch.Tensor, sigma: torch.Tensor,
                embeddings: Optional[torch.Tensor] = None,
                x_ref: Optional[torch.Tensor] = None, training: bool = False,
                x_perturbed: Optional[torch.Tensor] = None,
                ln_freqs: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """D(x) of (B, H, W, C), or (B, Z, H, W, C) under ``use_3d``, fp32.
        ``ln_freqs``: the ln-freq channel's (H,) log frequencies;
        ``dropout_generator``: the dropout masks' draws (training)."""
        return self.core(x_in, sigma, embeddings, x_ref, training, x_perturbed, ln_freqs,
                         dropout_generator)

    def get_embeddings(self, emb_in: torch.Tensor, conditioning_mask: torch.Tensor,
                       training: bool = False) -> Optional[torch.Tensor]:
        """CFG label embedding: mp_sum(unconditional, conditional, t=mask)."""
        if self.cfg.in_channels_emb <= 0:
            return None
        u = self.emb_label_unconditional(torch.ones((1, 1), dtype=emb_in.dtype,
                                                    device=emb_in.device), training=training)
        c = self.emb_label(normalize(emb_in, dim=-1), training=training)
        return mp_sum(u, c, t=conditioning_mask[:, None])

    def get_sigma_loss_logvar(self, sigma: torch.Tensor,
                              training: bool = False) -> torch.Tensor:
        """Learned per-sigma uncertainty (B,) -> (B, 1, 1, 1) fp32
        (JAX unet.py:696-701)."""
        f = self.logvar_fourier(torch.log(sigma.reshape(-1)) / 4.0)
        lv = self.logvar_linear(f, training=training)
        return lv.reshape(-1, 1, 1, 1).float()

    def get_latent_shape(self, latent_shape: Sequence[int]) -> Tuple[int, ...]:
        """``latent_shape`` (B, H, W, C) or (B, Z, H, W, C) with H and W cut
        down to multiples of 2^(levels - 1) (JAX unet.py:703-709)."""
        ds = 2 ** (len(self.cfg.channel_mult) - 1)
        if len(latent_shape) == 4:
            return (latent_shape[0], latent_shape[1] // ds * ds,
                    latent_shape[2] // ds * ds, latent_shape[3])
        return (latent_shape[0], latent_shape[1], latent_shape[2] // ds * ds,
                latent_shape[3] // ds * ds, latent_shape[4])
