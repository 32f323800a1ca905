#!/usr/bin/env python3
"""Where K5 and K6 (csrc/mss2d.cu) spend their device time, on one NVIDIA GPU.

    python3 scripts/mss2d_parts.py

Run from the root of a checkout. At the DAE training microbatch's shapes
(16 mid/side-stacked images of 256 x 680, reflect-padded by bw/2, widths 32
and 64, stride bw/8), profiles 20 calls each of K5, K6 without dTarget (as
the trainer calls it) and K6 with dTarget, after a warm-up, and prints the
device milliseconds per call of every kernel they launch (torch.profiler):
the main kernel, K5's per-image sum of the blocks' partial sums, K6b. Also
prints the card's name and power limit. Checks nothing: ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the kernels to their plain versions.
"""

import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dualdiffusion_tpu_torch.ops.kernels import (mss2d_block_loss,  # noqa: E402
                                                 mss2d_block_loss_grad)
from dualdiffusion_tpu_torch.training.losses import _window_2d, product_weights  # noqa: E402

CALLS = 20


def label(name: str) -> str:
    """'mss2d_kernel<64, false>' from a profiler kernel name."""
    m = re.search(r"(\w+_kernel)(<[^>]*>)?", name)
    return m.group(0) if m else name[:60]


def main() -> int:
    if not torch.cuda.is_available():
        print("mss2d_parts: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = [torch.randn((16, 256, 680), generator=gen, device="cuda") for _ in range(2)]
    g = torch.rand((16,), generator=gen, device="cuda") + 0.5
    for bw in (32, 64):
        stride, pad = bw // 8, bw // 2
        s, t = (F.pad(v[:, None], (pad,) * 4, mode="reflect")[:, 0] for v in x)
        win, wgt = _window_2d("flat_top", bw), product_weights(bw) / bw
        calls = {
            "K5": lambda: mss2d_block_loss(s, t, bw, stride, win, wgt),
            "K6 (no dTarget)": lambda: mss2d_block_loss_grad(s, t, g, bw, stride, win, wgt,
                                                             need_target=False),
            "K6 (with dTarget)": lambda: mss2d_block_loss_grad(s, t, g, bw, stride, win, wgt),
        }
        for what, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / 1e3 / CALLS)
                    for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            total = sum(ms for _, ms in rows)
            parts = "; ".join(f"{label(name)} {ms:.4f}"
                              for name, ms in sorted(rows, key=lambda r: -r[1]))
            print(f"bw {bw} {what}: {total:.4f} ms a call of device time: {parts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
