#!/usr/bin/env python3
"""K2 (fgla_frame) on one NVIDIA GPU: both routes against the plain version
in float64, and their times beside cuFFT's transforms.

    python3 scripts/fgla_compare.py

Run from the root of a checkout. Builds the kernels, prints the compiled
Hopper plans beside ``fgla_plan``'s and the Hopper kernels' registers and
spills, then at (n_fft, frames) = (6400, 5504) (the serving path's
Griffin-Lim iteration, B=1, C=2), (4096, 128) and (6400, 7) (a ragged last
block), in fp32 and bf16, at seeds 0-2: the relative max errors of the
spectrum r and the frames y of the Hopper route, the Stockham route and
the plain fp32 version against the float64 plain version, the frames'
relative L2 error and the seed call's (spectrum in). Prints "TIME" lines:
CUDA-event means over 20 calls after a warm-up of each route and of
``torch.fft.rfft`` + ``irfft`` on the same frames in fp32 (a reference
only). Checks nothing itself: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the tolerances. To compare two trees,
run it in each within one call.
"""

import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dualdiffusion_tpu_torch.ops.kernels import (build, dft_twiddles, fgla_frame,  # noqa: E402
                                                 fgla_frame_plain, fgla_plan,
                                                 stockham_everywhere)


def route(name):
    return stockham_everywhere() if name == "stockham" else contextlib.nullcontext()


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def rel_max(got, want):
    return (got.double() - want.double()).abs().max().item() / want.double().abs().max().item()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib = build.library()
    print("build", lib.build_seconds)
    log = lib.log.splitlines()
    for i, line in enumerate(log):
        if "fgla_frame_hopper_kernel" in line and "Compiling" in line:
            print(line[-80:])
            print("\n".join(log[i + 1:i + 4]))
    for n in (6400, 4096):
        out = (ctypes.c_int * 6)()
        ok = lib.lib.dd_fgla_frame_hopper_plan(n, out)
        print("plan", n, ok, list(out), fgla_plan(n))
    for n, f in ((6400, 5504), (4096, 128), (6400, 7)):
        bins = n // 2 + 1
        for wd in (torch.float32, torch.bfloat16):
            for seed in (0, 1, 2):
                g = torch.Generator(device="cuda").manual_seed(seed)
                spec = torch.rand((1, 2, f, bins), generator=g, device="cuda").to(wd)
                merged = spec.float().mean(1, keepdim=True).expand_as(spec).to(wd).contiguous()
                frames = torch.randn((1, 2, f, n), generator=g, device="cuda").mul(0.05).to(wd)
                prev = torch.randn((1, 2, f, bins, 2), generator=g, device="cuda").to(wd)
                tw = dft_twiddles(n, "cuda")
                rr, yr = fgla_frame_plain(frames, prev, spec, merged, 0.3, 0.4975,
                                          compute=torch.float64)
                _, yp = fgla_frame_plain(frames, prev, spec, merged, 0.3, 0.4975)
                ang = torch.randn((1, 2, f, bins, 2), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(9)).to(wd)
                _, ysp = fgla_frame_plain(ang, None, spec, merged, 0.1, 0.4975, spectral_in=True,
                                          compute=torch.float64)
                res = {}
                for name in ("hopper", "stockham"):
                    with route(name):
                        r, y = fgla_frame(frames, prev, spec, merged, 0.3, 0.4975, tw)
                        _, ys = fgla_frame(ang, None, spec, merged, 0.1, 0.4975, tw,
                                           spectral_in=True)
                    torch.cuda.synchronize()
                    l2 = ((y.double() - yr.double()).norm() / yr.double().norm()).item()
                    res[name] = (rel_max(r, rr), rel_max(y, yr), l2, rel_max(ys, ysp))
                print(f"n {n} F {f} {wd} seed {seed}: plain fp32 y err {rel_max(yp, yr):.3g}; "
                      + "; ".join(f"{k}: r {v[0]:.3g} y {v[1]:.3g} l2 {v[2]:.3g} seed-call "
                                  f"{v[3]:.3g}" for k, v in res.items()), flush=True)
            if f == 5504 or n == 4096:
                ts = {}
                for name in ("hopper", "stockham"):
                    with route(name):
                        ts[name] = time_ms(
                            lambda: fgla_frame(frames, prev, spec, merged, 0.3, 0.4975, tw))
                x32 = frames.float()
                ts["cufft"] = time_ms(
                    lambda: torch.fft.irfft(torch.fft.rfft(x32, dim=-1), n=n, dim=-1))
                print(f"TIME n {n} F {f} {wd}: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in ts.items()), flush=True)


if __name__ == "__main__":
    main()
