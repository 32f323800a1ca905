"""The precisions the plain reference runs in.

``REFERENCE`` computes in float32 with TF32 off: the yardstick. ``STATED``
rounds as the configurations state (bfloat16 activations and operands,
float32 sums), to scale a stage's gap by what that rounding alone makes.
``CONTROL``
is the precision below the one the configurations state: the port keeps
its activations and its Griffin-Lim state in bfloat16, so the control
stores activations in bfloat16 and rounds every matrix product's inputs,
and the Griffin-Lim state, to float8 (e4m3, one scale per tensor). The
control has to come out not correct; that is what shows the comparison can
see a step down in precision.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, returned in
    float32."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale


def _as_float(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@dataclass(frozen=True)
class Precision:
    name: str
    act: torch.dtype                                   # activations between layers
    operand: Callable[[torch.Tensor], torch.Tensor]    # a matrix product's inputs
    gl_state: Callable[[torch.Tensor], torch.Tensor]   # Griffin-Lim's iterated state


REFERENCE = Precision("float32", torch.float32, _as_float, _as_float)
#: the precision the configurations state: the yardstick of how far its
#: rounding alone takes a stage's output from float32's
STATED = Precision("bfloat16", torch.bfloat16, bf16_round, bf16_round)
CONTROL = Precision("float8_e4m3", torch.bfloat16, fp8_round, fp8_round)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn
