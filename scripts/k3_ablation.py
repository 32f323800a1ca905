#!/usr/bin/env python3
"""Where K3's time goes: the Hopper overlap-add kernel against copies of
itself with one part taken out or changed, on one NVIDIA GPU.

    python3 scripts/k3_ablation.py

Builds ``dualdiffusion_tpu_torch/csrc/ola_reframe_hopper.cu`` as it is and in
variants made by text edits of that source, each into a shared library of
its own (all nvcc processes at once):

- ``loads_only``: the main warps compute their signal chunks but store
  nothing (a store behind a condition that never holds);
- ``stores_only``: the main warps store a value made from their indices and
  load no frame (the edge blocks run as they are);
- ``no_edge_blocks``: the edge blocks return at once;
- ``batch16``: 16 input chunks a lane in flight instead of 8;
- ``plain_stores``: bf16's 16-byte stores without the kernel's evict-first
  mark (``__stcs``);
- ``streaming_stores``: fp32's stores marked evict-first too;
- ``stcg_stores``: the 16-byte stores cached in L2 only (``__stcg``);
- ``ldg_loads``, ``ldcg_loads``: the frame loads through the read-only
  path (``__ldg``) or cached in L2 only (``__ldcg``) instead of ``__ldcs``;
- ``warps4``, ``warps16``: 4 or 16 warps a block instead of 8.

Each is timed in turns with the unmodified kernel in one process (CUDA
events, mean of 20 calls after a warm-up, three rounds, the least kept) at
the serving shape (B*C 2, F 5504, n_fft 6400, hop 256) in bf16 and fp32,
beside ``Tensor.copy_`` of the same frames (the same bytes read and
written, a yardstick only). Only the unmodified kernel's output is checked,
against the plain version (2**-6 of max in bf16, 1e-5 in fp32). Prints one
line per variant and dtype, and the card's name and power limit. Imports
no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "dualdiffusion_tpu_torch" / "csrc" / "ola_reframe_hopper.cu"
ROWS, FRAMES, N, HOP = 2, 5504, 6400, 256

VARIANTS = {
    "kernel": [],
    "loads_only": [("    Vec8<T>::store(dst - (int64_t)j * step, w);",
                    "    if (w[0] == 1234.5f && w[7] == -1234.5f) "
                    "Vec8<T>::store(dst - (int64_t)j * step, w);")],
    "stores_only": [("  signal_chunk(y + b * row, win, inv_env, k, frames, n, r, tau, acc);",
                     "  for (int e = 0; e < 8; ++e) acc[e] = 1e-3f * (k + tau + e);")],
    "no_edge_blocks": [("    edge_row(y + blockIdx.x * row, out + blockIdx.x * row, win, inv_env, "
                        "frames, n, r,\n", "    if (0) edge_row(y, out, win, inv_env, frames, n, r,\n")],
    "batch16": [("constexpr int kBatch = 8;", "constexpr int kBatch = 16;")],
    "plain_stores": [
        ("    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));",
         "    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);")],
    "streaming_stores": [
        ("    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);\n"
         "    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);",
         "    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));\n"
         "    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));")],
    "stcg_stores": [
        ("    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));",
         "    __stcg(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));"),
        ("    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);\n"
         "    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);",
         "    __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));\n"
         "    __stcg(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));")],
    "ldg_loads": [("__ldcs(reinterpret_cast<const", "__ldg(reinterpret_cast<const")],
    "ldcg_loads": [("__ldcs(reinterpret_cast<const", "__ldcg(reinterpret_cast<const")],
    "warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "warps16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
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
        regs = [line.strip() for line in out.splitlines() if "registers" in line]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        fn = ctypes.CDLL(str(lib)).dd_ola_reframe_hopper
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def time_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from dualdiffusion_tpu_torch.ops.kernels import ola_plan, ola_reframe_plain
    with tempfile.TemporaryDirectory(prefix="k3_ablation_") as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp))
        print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        win = torch.rand(N, generator=gen, device="cuda") + 0.1
        inv_env = torch.rand((FRAMES - 1) * HOP + N, generator=gen, device="cuda") + 0.5
        stream = torch.cuda.current_stream().cuda_stream
        for wd, tol in ((torch.bfloat16, 2 ** -6), (torch.float32, 1e-5)):
            y = torch.randn((ROWS, FRAMES, N), generator=gen, device="cuda").to(wd)
            out = torch.empty_like(y)
            scratch = torch.empty((ROWS, ola_plan(N, HOP).scratch_floats), device="cuda")
            nbytes = 2 * y.numel() * y.element_size()

            def call(fn):
                err = fn(y.data_ptr(), out.data_ptr(), win.data_ptr(), inv_env.data_ptr(),
                         scratch.data_ptr(), ROWS, FRAMES, N, int(wd == torch.bfloat16), stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            call(libs["kernel"])
            torch.cuda.synchronize()
            want = ola_reframe_plain(y, win, inv_env, HOP)
            err = ((out.float() - want.float()).abs().max() / want.float().abs().max()).item()
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with its plain version: {err}")
            times = {name: [] for name in [*libs, "copy_"]}
            for _ in range(3):
                for name, fn in libs.items():
                    times[name].append(time_ms(lambda: call(fn)))
                times["copy_"].append(time_ms(lambda: out.copy_(y)))
            for name, ts in times.items():
                ms = min(ts)
                print(f"{wd} {name}: {ms:.4f} ms (rounds {', '.join(f'{t:.4f}' for t in ts)}); "
                      f"{nbytes / ms / 1e6:.1f} GB/s of frames in and out", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
