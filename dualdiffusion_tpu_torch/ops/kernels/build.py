"""Build the port's CUDA kernels from ``dualdiffusion_tpu_torch/csrc`` and load
them with ctypes.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds): one
``nvcc -c`` per source, all started together, then one link. The library is
built at first use into ``csrc/build/``, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every exported C function
SIGNATURES = {
    "dd_grouped_conv3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dd_grouped_conv3x3_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dd_grouped_conv3x3_hopper": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dd_grouped_conv3x3_wgrad_hopper": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dd_fgla_frame": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_I), _I,
                      _LL, _I, _F, _F, _I, _P],
    "dd_fgla_frame_hopper": [_P] * 8 + [_LL, _I, _F, _F, _I, _P],
    "dd_fgla_frame_hopper_plan": [_I, ctypes.POINTER(_I)],
    "dd_ola_reframe": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "dd_ola_reframe_hopper": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "dd_ola_reframe_hopper_plan": [_I, _I, ctypes.POINTER(_I)],
    "dd_mss2d_fwd": [_P, _P] + [_I] * 7 + [_P] * 6,
    "dd_mss2d_bwd": [_P, _P, _P] + [_I] * 8 + [_P] * 7,
    "dd_mss2d_plan": [_I, ctypes.POINTER(_I)],
    "dd_mss2d_dft_fwd": [_P, _P] + [_I] * 7 + [_P] * 6,
    "dd_mss2d_dft_bwd": [_P, _P, _P] + [_I] * 9 + [_P] * 7,
    "dd_flash_attention": [_P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I, _F, _I, _I, _I,
                           _P],
    "dd_flash_attention_wide": [_P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I, _F, _I, _I,
                                _I, _P],
}


class KernelLibrary:
    """The loaded library plus what its build printed and took."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.dd_error_string.argtypes = [ctypes.c_int]
        self.lib.dd_error_string.restype = ctypes.c_char_p

    def check(self, err: int, what: str) -> None:
        """Raise if a launcher returned a CUDA error."""
        if err != 0:
            msg = self.lib.dd_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> KernelLibrary:
    """Compile (if needed) and load the kernel library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libdd_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return KernelLibrary(lib_path, 0.0, "(cached)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    outs, seconds = {}, {}

    def wait(cmd, proc):
        outs[cmd[-1]] = proc.communicate()[0]
        seconds[Path(cmd[-1]).name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=cp) for cp in procs]
    for th in waiters:
        th.start()
    for th in waiters:
        th.join()
    log = ""
    failed = []
    for cmd, proc in procs:
        out = outs[cmd[-1]]
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    log += "nvcc seconds per source: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])) + "\n"
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return KernelLibrary(lib_path, time.perf_counter() - t0, log)


_LOCK = threading.Lock()
_LIB: Optional[KernelLibrary] = None


def library() -> KernelLibrary:
    """The process's kernel library, built on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = build()
        return _LIB
