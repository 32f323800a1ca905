# unet_fwd_flops copied from dualdiffusion_tpu_torch/utils/perf.py, over the frozen
# schedule of benchmark/reference/model.py; the K1 shape walk and byte count from
# chip_smoke.py (grouped_conv_shapes, kernel_phase_conv); the K2/K3 counts from
# chip_smoke.py (kernel_phase_fgla, kernel_phase_ola). dae_decode_flops is new.
"""The work of each layer, counted from the shapes of its calls: the
operations and bytes the algorithm needs, never what a kernel does. A
kernel that replaces another reads against the same counts."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from benchmark.reference.model import DAE_DEFAULTS, UNET_DEFAULTS, unet_schedule


def unet_fwd_flops(config: dict, batch: int, h: int, w: int) -> float:
    """Algorithmic FLOPs of one UNet forward at (batch, h, w): 2*M*N*K of
    every conv and attention product at its level's grid (per-sample MLPs,
    normalizations and elementwise work left out)."""
    cfg = dict(UNET_DEFAULTS, **config)
    g = max(cfg["mlp_groups"], 1)
    mm = cfg["mlp_multiplier"]

    def attn_flops(b, hh, ww, ch):
        proj = 2.0 * b * hh * ww * ch * (2 * ch + ch + ch)
        if cfg["attn_axis"] == "freq":
            bs, seq = b * ww, hh
        elif cfg["attn_axis"] == "time":
            bs, seq = b * hh, ww
        else:
            bs, seq = b, hh * ww
        return proj + 4.0 * bs * seq * seq * ch

    total = 0.0
    for _, kind, level, cin, cout in unet_schedule(cfg):
        hl, wl = h >> level, w >> level
        if kind in ("enc_in", "conv_out"):
            total += 2.0 * batch * hl * wl * cin * cout * 9
            continue
        c_mid = cout * mm
        c_in_res0 = cout if kind.startswith("enc") else cin
        total += 2.0 * batch * hl * wl * 9 * c_in_res0 * c_mid / g
        total += 2.0 * batch * hl * wl * 9 * c_mid * cout / g
        if cin != cout:
            total += 2.0 * batch * hl * wl * cin * cout
        if kind != "dec_mid" and level in cfg["attn_levels"]:
            total += attn_flops(batch, hl, wl, cout)
    return total


def grouped_conv_shapes(config: dict, batch: int, h: int, w: int) -> List[Tuple[int, ...]]:
    """(B, H, W, cin, cout) of every grouped 3x3 conv of one UNet forward:
    the convs K1 takes (none where ``mlp_groups`` is 1)."""
    cfg = dict(UNET_DEFAULTS, **config)
    if cfg["mlp_groups"] <= 1:
        return []
    shapes = []
    for _, kind, level, cin, cout in unet_schedule(cfg):
        if kind in ("enc_in", "conv_out"):
            continue
        c_mid = cout * cfg["mlp_multiplier"]
        c_in_res0 = cout if kind.startswith("enc") else cin
        hl, wl = h >> level, w >> level
        shapes += [(batch, hl, wl, c_in_res0, c_mid), (batch, hl, wl, c_mid, cout)]
    return shapes


def k1_work(config: dict, batch: int, h: int, w: int) -> Dict[str, float]:
    """Operations and bytes (bf16 in and out, each read or written once) of
    one UNet forward's grouped convs."""
    g = dict(UNET_DEFAULTS, **config)["mlp_groups"]
    flops = nbytes = 0.0
    for b, hh, ww, cin, cout in grouped_conv_shapes(config, batch, h, w):
        flops += 2.0 * 9 * cin * cout // g * b * hh * ww
        nbytes += 2.0 * (b * hh * ww * (cin + cout) + 9 * cin // g * cout)
    return {"flops": flops, "bytes": nbytes}


def k2_work(rows: int, frames: int, n_fft: int, item: int) -> Dict[str, float]:
    """One Griffin-Lim frame pass (K2) over ``rows`` (B*C) signals: a real
    n-point DFT each way per frame (2.5 n log2 n each as an FFT) and ~20
    flops per bin; frames, previous spectrum, magnitudes and merged
    magnitudes in, spectrum and frames out."""
    bins = n_fft // 2 + 1
    n = rows * frames
    return {"flops": n * (5 * n_fft * math.log2(n_fft) + 20 * bins),
            "bytes": n * item * (2 * n_fft + 6 * bins)}


def k3_work(rows: int, frames: int, n_fft: int, hop: int, item: int) -> Dict[str, float]:
    """One overlap-add and re-framing (K3): n/hop multiply-adds per signal
    sample and a window product per frame sample; frames in and out, the
    window and the envelope in."""
    sig = (frames - 1) * hop + n_fft
    return {"flops": rows * (sig * 2 * n_fft / hop + frames * n_fft),
            "bytes": rows * frames * n_fft * 2 * item + 4 * (n_fft + sig)}


def dae_decode_flops(config: dict, batch: int, h: int, w: int) -> float:
    """Algorithmic FLOPs of one DAE decode to a (batch, h, w) sample: every
    conv at its level's grid, 2*M*N*K."""
    cfg = dict(DAE_DEFAULTS, **config)
    dec = [cfg["model_channels"] * m for m in cfg["channel_mult_dec"]]
    levels = len(dec)
    total, cin = 0.0, dec[-1]

    def conv(level, ci, co, k):
        return 2.0 * batch * (h >> level) * (w >> level) * ci * co * k * k

    total += conv(levels - 1, cfg["latent_channels"], dec[-1], 3)
    for level in reversed(range(levels)):
        cout = dec[level]
        for i in range(cfg["num_dec_layers_per_block"] + 1):
            ci = cin if i == 0 else cout
            c_mid = cout * cfg["mlp_multiplier"]
            total += conv(level, ci, c_mid, 3) / cfg["mlp_groups"]
            total += conv(level, c_mid, cout, 3) / cfg["mlp_groups"]
            if ci != cout:
                total += conv(level, ci, cout, 1)
        cin = cout
    return total + conv(0, dec[0], cfg["out_channels"], 5)
