"""The port's hand-written CUDA kernels, one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises (never a silent fallback).
``<wrapper>.launches`` counts kernel launches only. A wrapper with more
than one route on the card chooses it from the call's shape before any
launch and counts the card's calls per route in ``<wrapper>.routes``.
"""

from .fgla_frame import (FglaPlan, dft_twiddles, fgla_frame, fgla_frame_plain, fgla_plan,
                         stockham_everywhere)
from .flash_attention import flash_attention, flash_attention_plain
from .grouped_conv import (GroupedConv3x3Fn, dgrad_weights, grouped_conv3x3, hopper_takes,
                           grouped_conv3x3_plain, grouped_conv3x3_wgrad,
                           grouped_conv3x3_wgrad_plain, prepare_weights)
from .mss2d import (MSS2D_PLANS, Mss2dBlockLossFn, mss2d_block_loss, mss2d_block_loss_grad,
                    mss2d_block_loss_grad_plain, mss2d_block_loss_plain, mss2d_loss_fused,
                    mss2d_route)
from .ola_reframe import OlaPlan, gather_everywhere, ola_plan, ola_reframe, ola_reframe_plain

#: every kernel wrapper of the serving and training paths
KERNELS = {
    "grouped_conv3x3": grouped_conv3x3,
    "grouped_conv3x3_wgrad": grouped_conv3x3_wgrad,
    "fgla_frame": fgla_frame,
    "ola_reframe": ola_reframe,
    "mss2d_block_loss": mss2d_block_loss,
    "mss2d_block_loss_grad": mss2d_block_loss_grad,
    "flash_attention": flash_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """{wrapper: {route: calls on the card}} for the wrappers with routes."""
    return {name: dict(fn.routes) for name, fn in KERNELS.items() if hasattr(fn, "routes")}


def reset_launch_counts() -> None:
    """Sets every launch count and every route count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0
