# Frozen copy of the math of dualdiffusion_tpu_torch/models/{mp,layers,attention,unet,dae}.py
# (2-D inference: no kernels, no parallelism, no rematerialization, no 3-D path).
"""The plain reference's models: the EDM2 magnitude-preserving UNet (the
latent UNet and the DDEC) and the DAE's decoder, channel last, with every
matrix product in plain PyTorch. Module and parameter names are the
port's, so one name-keyed set of weights loads into either.

A ``Precision`` says in which type activations are kept and how a product's
inputs are rounded: float32 throughout for the reference, bfloat16 with
float8 operands for the control.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import Precision

SILU_STD = 0.596


def normalize(x: torch.Tensor, dim=None, eps: float = 1e-4) -> torch.Tensor:
    if dim is None:
        dim = tuple(range(1, x.dim()))
    xf = x.float()
    return (xf / (eps + xf.square().mean(dim=dim, keepdim=True).sqrt())).to(x.dtype)


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) / SILU_STD


def mp_sum(a: torch.Tensor, b: torch.Tensor, t=0.5) -> torch.Tensor:
    return ((a + (b - a) * t) / ((1.0 - t) ** 2 + t ** 2) ** 0.5).to(a.dtype)


def mp_cat(a: torch.Tensor, b: torch.Tensor, t: float = 0.5) -> torch.Tensor:
    na, nb = a.shape[-1], b.shape[-1]
    c = ((na + nb) / ((1.0 - t) ** 2 + t ** 2)) ** 0.5
    return torch.cat([c / na ** 0.5 * (1.0 - t) * a, c / nb ** 0.5 * t * b], dim=-1)


def resample_2d(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "keep":
        return x
    if mode == "down":
        b, h, w, c = x.shape
        return x[:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class MPConv(nn.Module):
    """Magnitude-preserving linear (kernel ()) or 2-D conv on NHWC input,
    its weight scaled by 1/sqrt(fan-in) and a gain (no re-normalization:
    inference)."""

    def __init__(self, cin: int, cout: int, kernel=(), groups: int = 1,
                 raw: bool = False, bias: bool = False):
        super().__init__()
        self.kernel, self.groups = tuple(kernel), groups
        self.weight_name = "w_raw" if raw else "w_mp"
        self.register_parameter(self.weight_name,
                                nn.Parameter(torch.empty((cout, cin // groups) + self.kernel)))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor, prec: Precision, gain=1.0) -> torch.Tensor:
        w = getattr(self, self.weight_name)
        w = w / np.sqrt(float(np.prod(w.shape[1:]))) * gain
        xq, wq = prec.operand(x), prec.operand(w)
        if not self.kernel:
            if self.groups > 1:
                g = self.groups
                xg = xq.reshape(xq.shape[:-1] + (g, -1))
                out = torch.einsum("...gi,goi->...go", xg, wq.reshape(g, -1, xg.shape[-1]))
                out = out.reshape(x.shape[:-1] + (-1,))
            else:
                out = xq @ wq.t()
        else:
            kh, kw = self.kernel
            out = F.conv2d(xq.permute(0, 3, 1, 2), wq, padding=(kh // 2, kw // 2),
                           groups=self.groups).permute(0, 2, 3, 1)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


class MPFourier(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        lin = torch.as_tensor(np.linspace(0, 1 - eps, channels), dtype=torch.float64)
        self.register_buffer("freqs", (np.pi * torch.special.erfinv(lin)).float(),
                             persistent=False)
        self.register_buffer("phases", torch.as_tensor(
            np.pi / 2 * (np.arange(channels) % 2 == 0), dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cos(x.float()[:, None] * self.freqs[None] + self.phases) * np.sqrt(2.0)


def unet_schedule(cfg: dict):
    """(name, kind, level, cin, cout) of each op in execution order."""
    cblock = [cfg["model_channels"] * m for m in cfg["channel_mult"]]
    cout = cfg["in_channels"]
    if cfg.get("in_psd_freqs", 0) > 0:
        cout += cfg["in_psd_freqs"] // cfg["in_num_freqs"] * cfg["in_channels"]
    cout += int(cfg.get("add_constant_channel", False))
    ops, skips = [], []
    for level, ch in enumerate(cblock):
        if level == 0:
            ops.append(("enc_conv_in", "enc_in", 0, cout, ch))
            cout = ch
        else:
            ops.append((f"enc_b{level}_down", "enc_down", level, cout, cout))
        skips.append(cout)
        for i in range(cfg["num_layers_per_block"]):
            ops.append((f"enc_b{level}_l{i}", "enc_layer", level, cout, ch))
            cout = ch
            skips.append(cout)
    for level, ch in reversed(list(enumerate(cblock))):
        if level == len(cblock) - 1:
            ops.append((f"dec_b{level}_in0", "dec_mid", level, cout, cout))
        else:
            ops.append((f"dec_b{level}_up", "dec_up", level, cout, cout))
        for i in range(cfg["num_layers_per_block"] + 1):
            sc = skips.pop()
            ops.append((f"dec_b{level}_l{i}", "dec_layer", level, cout + sc, ch))
            cout = ch
    ops.append(("conv_out", "conv_out", 0, cout, cfg["out_channels"]))
    return ops


UNET_DEFAULTS = dict(in_channels_emb=0, in_psd_freqs=0, sigma_max=200.0, sigma_min=0.03,
                     sigma_data=1.0, channel_mult_noise=None, channel_mult_emb=None,
                     attn_levels=(), attn_axis="freq", channels_per_head=64,
                     label_balance=0.5, concat_balance=0.5, res_balance=0.3, attn_balance=0.3,
                     clip_act=256.0, mlp_multiplier=1, mlp_groups=1, emb_linear_groups=1,
                     logvar_channels=128, add_constant_channel=False)


class UNetBlock(nn.Module):
    def __init__(self, cfg: dict, cin: int, cout: int, cemb: int, flavor: str, resample: str,
                 attention: bool):
        super().__init__()
        self.cfg, self.cout, self.flavor, self.resample = cfg, cout, flavor, resample
        self.attention = attention
        c_mid = cout * cfg["mlp_multiplier"]
        self.conv_skip = MPConv(cin, cout, (1, 1)) if cin != cout else None
        self.conv_res0 = MPConv(cout if flavor == "enc" else cin, c_mid, (3, 3),
                                cfg["mlp_groups"])
        self.conv_res1 = MPConv(c_mid, cout, (3, 3), cfg["mlp_groups"])
        self.emb_gain = nn.Parameter(torch.empty(()))
        self.emb_linear = MPConv(cemb, c_mid, (), cfg["emb_linear_groups"])
        if attention:
            self.attn_qk = MPConv(cout, cout * 2, (1, 1))
            self.attn_v = MPConv(cout, cout, (1, 1))
            self.attn_proj = MPConv(cout, cout, (1, 1))
            self.emb_gain_qk = nn.Parameter(torch.empty(()))
            self.emb_linear_qk = MPConv(cemb, cout, ())
            self.emb_gain_v = nn.Parameter(torch.empty(()))
            self.emb_linear_v = MPConv(cemb, cout, ())

    def _mod(self, name: str, emb, x, prec):
        lin, gain = getattr(self, f"emb_linear{name}"), getattr(self, f"emb_gain{name}")
        return (lin(emb, prec, gain) + 1.0)[:, None, None, :].to(x.dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, prec: Precision) -> torch.Tensor:
        cfg = self.cfg
        x = resample_2d(x, self.resample)
        if self.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x, prec)
            x = normalize(x, dim=-1)
        y = self.conv_res0(mp_silu(x), prec)
        y = mp_silu(y * self._mod("", emb, y, prec))
        y = self.conv_res1(y, prec)
        if self.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x, prec)
        x = mp_sum(x, y, cfg["res_balance"])
        if self.attention:
            x = self._attend(x, emb, prec)
        return x.clamp(-cfg["clip_act"], cfg["clip_act"])

    def _attend(self, x: torch.Tensor, emb: torch.Tensor, prec: Precision) -> torch.Tensor:
        cfg, ch = self.cfg, self.cout
        heads = max(ch // cfg["channels_per_head"], 1)
        hd = ch // heads
        qk = self.attn_qk(x * self._mod("_qk", emb, x, prec), prec)
        v = self.attn_v(x, prec)
        b, h, w, _ = x.shape
        if cfg["attn_axis"] == "freq":        # sequences along H, one per (b, w)
            seq = lambda t: t.permute(0, 2, 1, 3).reshape(b * w, h, t.shape[-1])
        elif cfg["attn_axis"] == "time":
            seq = lambda t: t.reshape(b * h, w, t.shape[-1])
        else:
            seq = lambda t: t.reshape(b, h * w, t.shape[-1])
        qk_s, v_s = seq(qk), seq(v)
        bs, n = qk_s.shape[:2]
        qk_h = qk_s.reshape(bs, n, heads, 2, hd)
        q = normalize(qk_h[..., 0, :], dim=-1).transpose(1, 2)
        k = normalize(qk_h[..., 1, :], dim=-1).transpose(1, 2)
        vh = normalize(v_s.reshape(bs, n, heads, hd), dim=-1).transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", prec.operand(q), prec.operand(k)) / np.sqrt(hd)
        attn = torch.softmax(logits.float(), dim=-1)
        y = torch.einsum("bhqk,bhkd->bhqd", prec.operand(attn), prec.operand(vh))
        y = y.transpose(1, 2).to(x.dtype).reshape(bs, n, ch)
        if cfg["attn_axis"] == "freq":
            y = y.reshape(b, w, h, ch).permute(0, 2, 1, 3)
        else:
            y = y.reshape(b, h, w, ch)
        y = self.attn_proj(mp_silu(y * self._mod("_v", emb, x, prec)), prec)
        return mp_sum(x, y, cfg["attn_balance"])


class UNet(nn.Module):
    """D(x; sigma, embedding[, PSD]) of (B, H, W, C), float32 out."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = dict(UNET_DEFAULTS, **config)
        self.cfg = cfg
        cblock = [cfg["model_channels"] * m for m in cfg["channel_mult"]]
        cemb = (cfg["model_channels"] * cfg["channel_mult_emb"] if cfg["channel_mult_emb"]
                else max(cblock)) * cfg["mlp_multiplier"]
        cnoise = (cfg["model_channels"] * cfg["channel_mult_noise"]
                  if cfg["channel_mult_noise"] else max(cblock))
        self.schedule = unet_schedule(cfg)
        core = nn.Module()
        core.emb_fourier = MPFourier(cnoise)
        core.emb_noise = MPConv(cnoise, cemb, ())
        for name, kind, level, cin, cout in self.schedule:
            if kind == "enc_in":
                mod = MPConv(cin, cout, (3, 3), bias=True)
            elif kind == "conv_out":
                mod = MPConv(cin, cout, (3, 3))
            else:
                attn = kind != "dec_mid" and level in cfg["attn_levels"]
                mod = UNetBlock(cfg, cin, cout, cemb, "enc" if kind.startswith("enc") else "dec",
                                {"enc_down": "down", "dec_up": "up"}.get(kind, "keep"), attn)
            core.add_module(name, mod)
        core.out_gain = nn.Parameter(torch.empty(()))
        self.core = core
        if cfg["in_channels_emb"] > 0:
            self.emb_label = MPConv(cfg["in_channels_emb"], cemb, ())
            self.emb_label_unconditional = MPConv(1, cemb, ())
        self.logvar_linear = MPConv(cfg["logvar_channels"], 1, (), raw=True)

    def label_embeddings(self, emb_in: torch.Tensor, mask: torch.Tensor,
                         prec: Precision) -> torch.Tensor:
        """mp_sum(unconditional, conditional, t=mask) of (B, emb) inputs."""
        u = self.emb_label_unconditional(torch.ones((1, 1), device=emb_in.device), prec)
        c = self.emb_label(normalize(emb_in.float(), dim=-1), prec)
        return mp_sum(u, c, mask[:, None])

    def forward(self, x_in: torch.Tensor, sigma: torch.Tensor, emb_label: Optional[torch.Tensor],
                prec: Precision, x_ref: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, core = self.cfg, self.core
        sigma = sigma.reshape(-1, 1, 1, 1).float()
        sd = cfg["sigma_data"]
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        c_out = sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)
        c_in = 1.0 / torch.sqrt(sd ** 2 + sigma ** 2)
        x = (c_in * x_in.float()).to(prec.act)
        if x_ref is not None:
            b, pbins, w, c = x_ref.shape
            per = cfg["in_psd_freqs"] // cfg["in_num_freqs"]
            r = x_ref.reshape(b, pbins // per, per, w, c).permute(0, 1, 3, 2, 4)
            x = mp_cat(x, r.reshape(b, pbins // per, w, per * c).to(prec.act), cfg["label_balance"])
        if cfg["add_constant_channel"]:
            x = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], -1)
        emb = core.emb_noise(core.emb_fourier(torch.log(sigma.reshape(-1)) / 4.0), prec)
        if emb_label is not None:
            emb = mp_silu(mp_sum(emb, emb_label.to(emb.dtype), cfg["label_balance"]))
        emb = emb.to(prec.act)
        skips = []
        for name, kind, _, _, _ in self.schedule:
            mod = getattr(core, name)
            if kind == "enc_in":
                x = mod(x, prec)
                skips.append(x)
            elif kind in ("enc_down", "enc_layer"):
                x = mod(x, emb, prec)
                skips.append(x)
            elif kind in ("dec_mid", "dec_up"):
                x = mod(x, emb, prec)
            elif kind == "dec_layer":
                x = mod(mp_cat(x, skips.pop(), cfg["concat_balance"]), emb, prec)
            else:
                x = mod(x, prec, core.out_gain)
        return c_skip * x_in.float() + c_out * x.float()


DAE_DEFAULTS = dict(in_channels=2, out_channels=2, in_channels_emb=0, latent_channels=8,
                    model_channels=64, channel_mult_enc=(1, 2, 4, 8),
                    channel_mult_dec=(1, 2, 4, 8), num_enc_layers_per_block=3,
                    num_dec_layers_per_block=3, res_balance=0.3, clip_act=256.0,
                    mlp_multiplier=2, mlp_groups=1, add_pixel_norm=False)


class DAEBlock(nn.Module):
    def __init__(self, cfg: dict, cin: int, cout: int, flavor: str, resample: str = "keep"):
        super().__init__()
        self.cfg, self.flavor, self.resample = cfg, flavor, resample
        c_mid = cout * cfg["mlp_multiplier"]
        self.conv_skip = MPConv(cin, cout, (1, 1)) if cin != cout else None
        self.conv_res0 = MPConv(cout if flavor == "enc" else cin, c_mid, (3, 3), cfg["mlp_groups"])
        self.conv_res1 = MPConv(c_mid, cout, (3, 3), cfg["mlp_groups"])

    def forward(self, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        cfg = self.cfg
        x = resample_2d(x, self.resample)
        y = self.conv_res0(x, prec)
        g = cfg["mlp_groups"]
        yn = normalize(y.reshape(y.shape[:-1] + (g, -1)), dim=-1).reshape(y.shape)
        y = self.conv_res1(mp_silu(yn), prec)
        if self.conv_skip is not None:
            x = self.conv_skip(x, prec)
        return mp_sum(x, y, cfg["res_balance"]).clamp(-cfg["clip_act"], cfg["clip_act"])


class DAE(nn.Module):
    """The DAE's parameters, as the port names them; ``decode`` alone runs."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = dict(DAE_DEFAULTS, **config)
        self.cfg = cfg
        enc = [cfg["model_channels"] * m for m in cfg["channel_mult_enc"]]
        dec = [cfg["model_channels"] * m for m in cfg["channel_mult_dec"]]
        self.conv_in = MPConv(cfg["in_channels"], enc[0], (5, 5), bias=True)
        blocks, cin = [], enc[0]
        for level, cout in enumerate(enc):
            if level > 0:
                blocks.append(DAEBlock(cfg, cin, cout, "enc", "down"))
            blocks += [DAEBlock(cfg, cout, cout, "enc") for _ in range(cfg["num_enc_layers_per_block"])]
            cin = cout
        self.enc = nn.ModuleList(blocks)
        self.conv_latents_out = MPConv(enc[-1], cfg["latent_channels"], (3, 3))
        self.conv_latents_in = MPConv(cfg["latent_channels"], dec[-1], (3, 3), bias=True)
        blocks, cin = [], dec[-1]
        for level in reversed(range(len(dec))):
            cout = dec[level]
            blocks.append(DAEBlock(cfg, cin, cout, "dec", "keep" if level == len(dec) - 1 else "up"))
            blocks += [DAEBlock(cfg, cout, cout, "dec") for _ in range(cfg["num_dec_layers_per_block"])]
            cin = cout
        self.dec = nn.ModuleList(blocks)
        self.conv_out = MPConv(dec[0], cfg["out_channels"], (5, 5))
        self.out_gain = nn.Parameter(torch.empty(()))
        self.recon_loss_logvar = nn.Parameter(torch.empty(()))

    @property
    def downsample_ratio(self) -> int:
        return 2 ** (len(self.cfg["channel_mult_dec"]) - 1)

    def decode(self, latents: torch.Tensor, prec: Precision) -> torch.Tensor:
        x = self.conv_latents_in(latents.to(prec.act), prec)
        for block in self.dec:
            x = block(x, prec)
        return self.conv_out(x, prec, self.out_gain).float()


def load(module: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """Every parameter of ``module`` from ``weights`` (name -> tensor), which
    must hold exactly the module's parameters."""
    own = dict(module.named_parameters())
    if set(own) != set(weights):
        raise KeyError(f"weights and module differ: {sorted(set(own) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in own.items():
            p.data = weights[name].detach().clone().float()
    return module


def parameter_shapes(module: nn.Module) -> Dict[str, Sequence[int]]:
    return {name: tuple(p.shape) for name, p in module.named_parameters()}
