"""The port's hand-written CUDA kernels, one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises (never a silent fallback).
``<wrapper>.launches`` counts kernel launches only.
"""

from .fgla_frame import dft_twiddles, fgla_frame, fgla_frame_plain
from .grouped_conv import (grouped_conv3x3, grouped_conv3x3_plain,
                           prepare_weights)
from .ola_reframe import ola_reframe, ola_reframe_plain

#: every wrapper on the serving path, with the TPU kernel it replaces
KERNELS = {
    "grouped_conv3x3": grouped_conv3x3,
    "fgla_frame": fgla_frame,
    "ola_reframe": ola_reframe,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
