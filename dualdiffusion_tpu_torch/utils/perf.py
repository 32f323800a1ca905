# Copied from dualdiffusion_tpu/utils/perf.py (unet_fwd_flops) over the port's UNet schedule.
"""Analytic FLOP counts, the denominators of achieved-rate and bound
figures."""

from __future__ import annotations


def unet_fwd_flops(cfg, batch: int, h: int, w: int) -> float:
    """Analytic algorithmic FLOPs of ONE UNetCore forward pass.

    Walks the model's own op schedule (models/unet.py ``build_schedule``,
    the same list the forward executes) and sums 2*M*N*K for every
    conv/attention matmul at that op's grid resolution. Per-sample emb
    MLPs, normalizations, resamplers and other O(B*H*W*C) elementwise work
    are excluded (<<1% of a conv UNet).

    2D grids only (H, W halve per level). Counts per block:
      conv_res0/res1: 2*B*h*w*9*cin*cout/groups
      conv_skip (1x1, when present): 2*B*h*w*cin*cout
      attention (when on): qk/v/proj 1x1 convs + 4*B'*seq^2*ch SDPA
    """
    from ..models.unet import build_schedule

    ops = build_schedule(cfg)
    g = max(cfg.mlp_groups, 1)
    mm = cfg.mlp_multiplier

    def attn_flops(b, hh, ww, ch):
        proj = 2.0 * b * hh * ww * ch * (2 * ch + ch + ch)  # qk + v + proj
        if cfg.attn_axis == "freq":
            bs, seq = b * ww, hh
        elif cfg.attn_axis == "time":
            bs, seq = b * hh, ww
        else:  # full
            bs, seq = b, hh * ww
        return proj + 4.0 * bs * seq * seq * ch

    total = 0.0
    for _name, kind, level, cin, cout in ops:
        hl, wl = h >> level, w >> level
        if kind == "enc_in":
            kh, kw = (cfg.input_kernel if len(cfg.input_kernel) == 2
                      else (3, 3))
            total += 2.0 * batch * hl * wl * cin * cout * kh * kw
            continue
        if kind == "conv_out":
            total += 2.0 * batch * hl * wl * cin * cout * 9
            continue
        flavor = "enc" if kind.startswith("enc") else "dec"
        c_mid = cout * mm
        c_in_res0 = cout if flavor == "enc" else cin
        total += 2.0 * batch * hl * wl * 9 * c_in_res0 * c_mid / g
        total += 2.0 * batch * hl * wl * 9 * c_mid * cout / g
        if cfg.always_skip or cin != cout:
            total += 2.0 * batch * hl * wl * cin * cout  # 1x1 skip
        attn = (cfg.midblock_attn if kind == "dec_mid"
                else level in cfg.attn_levels)
        if attn:
            total += attn_flops(batch, hl, wl, cout)
    return total
