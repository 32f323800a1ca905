#!/usr/bin/env python3
"""Where K7's time goes: the flash-attention kernel against copies of itself
with one phase taken out, on one NVIDIA GPU.

    python3 scripts/k7_ablation.py

Builds ``dualdiffusion_tpu_torch/csrc/flash_attention.cu`` as it is and in
variants made by text edits of that source:

- ``no_s_product``: S = Q K^T is not computed (the scores keep stale values);
- ``no_pv_product``: O += P V is not computed;
- ``no_exp``: the softmax's exponentials are replaced by their arguments;
- ``one_block_bk128``: at Dp <= 64, one block per SM with 128-key tiles in
  place of two blocks with 64-key tiles.

Each is timed in a child process of its own (CUDA events, mean of 20 calls
after a warm-up) at the full-attention model's level-1 shape (B 2, L 5504,
D 64, bf16, 4, 8 and 12 heads), beside ``F.scaled_dot_product_attention``.
Only the unmodified kernel's output is checked. If taking a phase out saves
its whole time, nothing overlaps it. Prints one JSON line per variant and
the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "dualdiffusion_tpu_torch" / "csrc" / "flash_attention.cu"
HEADS = (4, 8, 12)
B, L, D = 2, 5504, 64

VARIANTS = {
    "kernel": [],
    "no_s_product": [(
        "        wgmma_ss(s, make_desc<SW>(qa + a * kBQ * SW + off, 16, 8 * SW),\n"
        "                 make_desc<SW>(tK + a * BK * SW + off, 16, 8 * SW), kk > 0);",
        "        s[kk] += 1e-3f;")],
    "no_pv_product": [(
        "        wgmma_rs(o, pa[kk], make_desc<SW>(tV + kk * 16 * SW, BK * SW, 8 * SW));",
        "        o[kk] += __uint_as_float(pa[kk][0] & 1);")],
    "no_exp": [(
        "const float pv = exp2_ftz(fmaf(s[i], scale, -m_use[(i >> 1) & 1]));",
        "const float pv = fmaf(s[i], scale, -m_use[(i >> 1) & 1]);")],
    "one_block_bk128": [
        ("static constexpr int BK = DP <= 64 ? 64 : DP <= 128 ? 128 : 64;",
         "static constexpr int BK = DP <= 128 ? 128 : 64;"),
        ("static constexpr int BLOCKS = DP <= 64 ? 2 : 1;", "static constexpr int BLOCKS = 1;")],
}


def build(work: Path) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    sys.path.insert(0, str(REPO))
    from dualdiffusion_tpu_torch.ops.kernels.build import NVCC_FLAGS, _nvcc
    base = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        cu = work / f"{name}.cu"
        cu.write_text(src)
        lib = work / f"lib{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(SOURCE.parent), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-2000:]}")
        libs[name] = lib
    return libs


def run_one(name: str, lib_path: str) -> None:
    """Child: time one variant through the port's wrapper."""
    import ctypes

    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(REPO))
    from dualdiffusion_tpu_torch.ops.kernels import build as kbuild
    from dualdiffusion_tpu_torch.ops.kernels import flash_attention, flash_attention_plain

    class Lib:
        def __init__(self, path):
            self.lib = ctypes.CDLL(path)
            fn = self.lib.dd_flash_attention
            fn.argtypes, fn.restype = kbuild.SIGNATURES["dd_flash_attention"], ctypes.c_int

        def check(self, err, what):
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")

    def time_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kbuild._LIB = Lib(lib_path)
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"variant": name}
    for h in HEADS:
        q, k, v = (torch.randn((B, L, h, D), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for _ in range(3))
        if name == "kernel":
            got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
            err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            if not err <= 2e-2:
                raise AssertionError(f"kernel disagrees with its plain version: {err}")
            row[f"library_ms_h{h}"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        row[f"ms_h{h}"] = time_ms(lambda: flash_attention(q, k, v))
    print(json.dumps(row), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k7_ablation: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="k7_ablation_") as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp))
        print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, lib in libs.items():
            # a child per variant: a variant that faults or hangs takes only itself down
            proc = subprocess.run([sys.executable, __file__, "--run", name, str(lib)],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode:
                print(proc.stdout + proc.stderr[-2000:], flush=True)
                return 1
            print(proc.stdout.strip(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        run_one(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
