"""Format base class + registry (JAX: dualdiffusion_tpu/models/formats/format.py).

A Format converts raw audio (B, C, T) float32 to and from the 2-D sample
the diffusion models operate on, channel last (B, F, T', C). Formats are
parameter-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Type

_FORMAT_REGISTRY: Dict[str, Tuple[type, type]] = {}


def register_format(name: str):
    def deco(cls):
        _FORMAT_REGISTRY[name] = (cls, cls.config_class)
        cls.format_name = name
        return cls
    return deco


def get_format_class(name: str) -> Tuple[type, type]:
    """(format class, config class) registered under ``name`` (JAX format.py:30)."""
    if name not in _FORMAT_REGISTRY:
        raise KeyError(f"unknown format '{name}'; known: {sorted(_FORMAT_REGISTRY)}")
    return _FORMAT_REGISTRY[name]


@dataclass
class FormatConfig:
    sample_rate: int = 32000
    num_raw_channels: int = 2
    default_raw_length: int = 1408768


class Format:
    """Abstract format. Subclasses implement raw <-> sample transforms."""

    config_class: Type[FormatConfig] = FormatConfig
    format_name: str = "abstract"

    def __init__(self, config: FormatConfig) -> None:
        self.config = config

    def get_raw_crop_width(self, raw_length: Optional[int] = None) -> int:
        raise NotImplementedError

    def get_sample_shape(self, bsz: int = 1, raw_length: Optional[int] = None) -> Tuple[int, ...]:
        raise NotImplementedError

    def raw_to_sample(self, raw):
        raise NotImplementedError

    def sample_to_raw(self, sample, **kwargs):
        raise NotImplementedError
