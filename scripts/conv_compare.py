#!/usr/bin/env python3
"""The grouped 3x3 conv's two CUDA designs side by side on one card.

    python3 scripts/conv_compare.py [check] [time]

Run from the root of a checkout on a machine with one CUDA card. Builds
the port's kernels, then in a child process each (with a time limit, so a
kernel that hangs cannot hold the card):

- ``check``: K1 forward, dgrad (K1 on ``dgrad_weights``) and K4 against
  their plain versions (2**-7 of max, bf16 out) at every distinct
  grouped-conv shape of the reference UNet at batch 2 and at a few odd
  shapes, K4 twice bit for bit, with the kernel each shape takes;
- ``time``: per distinct shape of the reference UNet, the Hopper kernels
  (``csrc/grouped_conv3x3_hopper.cu``, ``csrc/grouped_conv3x3_wgrad_hopper.cu``)
  against the WMMA kernels of the earlier design (``csrc/grouped_conv3x3.cu``,
  ``csrc/grouped_conv3x3_wgrad.cu``) and cuDNN's bf16 fprop, dgrad and
  wgrad: K1 per UNet forward at batch 2, dgrad and K4 per backward at batch
  8 (CUDA-event means of 10 calls after a warm-up), and K1's host µs per
  call on both routes in turns.

With no argument it runs both.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parent(modes) -> int:
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    lib = library()
    print(f"kernel build: {lib.build_seconds:.2f} s", flush=True)
    rc = 0
    for mode in modes:
        try:
            r = subprocess.run([sys.executable, __file__, "--child", mode],
                               timeout=300 if mode == "check" else 600)
            print(f"{mode}: exit {r.returncode}", flush=True)
            rc = rc or r.returncode
        except subprocess.TimeoutExpired:
            print(f"{mode}: timed out", flush=True)
            rc = 1
    return rc


def child(mode: str) -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dualdiffusion_tpu_torch.models import UNet
    from dualdiffusion_tpu_torch.ops.kernels import (dgrad_weights, grouped_conv3x3,
                                                     grouped_conv3x3_plain, grouped_conv3x3_wgrad,
                                                     grouped_conv3x3_wgrad_plain, prepare_weights)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ucfg = cs.ref_scale_configs()[0]
    unet = UNet(ucfg, device="meta")
    lat_h, lat_w, groups = 32, 688, ucfg.mlp_groups

    if mode == "check":
        shapes = [(1, 3, 5, 2, 8, 8), (2, 3, 9, 1, 40, 72), (2, 4, 70, 4, 16, 8),
                  (2, 4, 70, 4, 12, 20), (2, 5, 130, 2, 32, 32)]
        shapes += [(b, h, w, groups, cin // groups, cout // groups)
                   for b, h, w, cin, cout in sorted(set(cs.grouped_conv_shapes(unet, 2, lat_h,
                                                                                lat_w)))]
        bad = 0
        for b, h, w, g, cig, cog in shapes:
            x = torch.randn((b, h, w, g * cig), generator=gen, device="cuda").bfloat16()
            wt = prepare_weights(torch.randn((g * cog, cig, 3, 3), generator=gen, device="cuda")
                                 / (9 * cig) ** 0.5, g)
            gy = torch.randn((b, h, w, g * cog), generator=gen, device="cuda").bfloat16()
            wd = dgrad_weights(wt)
            errs = []
            for got, want in ((grouped_conv3x3(x, wt, g), grouped_conv3x3_plain(x, wt, g)),
                              (grouped_conv3x3(gy, wd, g), grouped_conv3x3_plain(gy, wd, g)),
                              (grouped_conv3x3_wgrad(x, gy, g),
                               grouped_conv3x3_wgrad_plain(x, gy, g))):
                torch.cuda.synchronize()
                errs.append(((got.float() - want.float()).abs().max()
                             / want.float().abs().max()).item())
            same = torch.equal(grouped_conv3x3_wgrad(x, gy, g), grouped_conv3x3_wgrad(x, gy, g))
            ok = max(errs) <= 2 ** -7 and same
            bad += not ok
            print(f"{(b, h, w, g, cig, cog)} [{cs.conv_route(cig, cog, x, wt)}] fwd {errs[0]:.3g} "
                  f"dgrad {errs[1]:.3g} wgrad {errs[2]:.3g} bit-equal {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
        return 1 if bad else 0

    tot = {}
    for batch in (2, cs.TRAIN_BATCH):
        shapes = cs.grouped_conv_shapes(unet, batch, lat_h, lat_w)
        for (b, h, w, cin, cout), n in {s: shapes.count(s) for s in dict.fromkeys(shapes)}.items():
            cig, cog = cin // groups, cout // groups
            x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
            wgt = torch.randn((cout, cig, 3, 3), generator=gen, device="cuda") / (9 * cig) ** 0.5
            wt = prepare_weights(wgt, groups)
            gy = torch.randn((b, h, w, cout), generator=gen, device="cuda").bfloat16()
            wd = dgrad_weights(wt)
            xc, gyc, wc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2), wgt.bfloat16()
            row = {}
            for name in ("hopper", "wmma"):
                with cs.forced_route(name):
                    if batch == 2:
                        row[f"fwd_{name}"] = cs.time_ms(lambda: grouped_conv3x3(x, wt, groups))
                    else:
                        row[f"dgrad_{name}"] = cs.time_ms(lambda: grouped_conv3x3(gy, wd, groups))
                        row[f"wgrad_{name}"] = cs.time_ms(
                            lambda: grouped_conv3x3_wgrad(x, gy, groups))
            if batch == 2:
                row["fwd_cudnn"] = cs.time_ms(lambda: F.conv2d(xc, wc, padding=1, groups=groups))
            else:
                row["dgrad_cudnn"] = cs.time_ms(lambda: torch.nn.grad.conv2d_input(
                    xc.shape, wc, gyc, padding=1, groups=groups))
                row["wgrad_cudnn"] = cs.time_ms(lambda: torch.nn.grad.conv2d_weight(
                    xc, wc.shape, gyc, padding=1, groups=groups))
            for k, v in row.items():
                tot[k] = tot.get(k, 0.0) + n * v
            print(f"b{b} h{h} w{w} {cig}->{cog} x{n}: "
                  + " ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print("per UNet forward (fwd, batch 2) / backward (dgrad, wgrad, batch 8), ms: "
          + " ".join(f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
    x = torch.randn((1, 2, 16, 64), generator=gen, device="cuda").bfloat16()
    wt = prepare_weights(torch.randn((64, 8, 3, 3), generator=gen, device="cuda"), 8)
    us = cs.k1_host_us(x, wt, 8)
    print("K1 host us per call: " + "; ".join(
        f"{k} {', '.join(f'{u:.1f}' for u in v)}" for k, v in us.items()), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    rc = parent(sys.argv[1:] or ["check", "time"])
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
