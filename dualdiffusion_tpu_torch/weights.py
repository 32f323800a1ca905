"""The weight bridge between the JAX package's flat parameter dicts and the
port's ``state_dict``s.

The JAX package stores a module's variables flattened to '/'-joined flax
paths (``params/core/enc_b0_l0/conv_res0/w_mp``), with 0-d leaves stored as
shape (1,) under a ``#0d`` suffix (dualdiffusion_tpu/pipelines/
pipeline.py:81-107). The port names its modules and parameters after the
flax paths, so the whole map is the table below.
"""

from __future__ import annotations

import re
from typing import AbstractSet, Dict

import numpy as np
import torch
import torch.nn as nn

#: flax collection of a torch state_dict entry, by its last name; the rest
#: live in "params"
COLLECTIONS = {
    "latents_mean": "stats",
    "latents_var": "stats",
    "latents_global_mean": "stats",
    "latents_global_var": "stats",
}

#: (torch pattern, flax replacement) renames, applied in order to a torch
#: key whose '.' separators already became '/'
TORCH_TO_FLAX = [
    # block lists: the DAE's and VAE's enc.3 <-> enc_3, the discriminator's blocks.3 <-> blocks_3
    (r"^(enc|dec|blocks)/(\d+)/", r"\1_\2/"),
]

SCALAR_SUFFIX = "#0d"


def flax_key(torch_key: str, scalar: bool) -> str:
    path = torch_key.replace(".", "/")
    for pat, rep in TORCH_TO_FLAX:
        path = re.sub(pat, rep, path)
    collection = COLLECTIONS.get(path.rsplit("/", 1)[-1], "params")
    return f"{collection}/{path}" + (SCALAR_SUFFIX if scalar else "")


def state_to_flat(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict (or an EMA profile) as the JAX package's flat dict:
    fp32 numpy, fp64 kept as fp64."""
    out = {}
    for k, v in state.items():
        v = v.detach().cpu()
        a = (v.double() if v.dtype == torch.float64 else v.float()).numpy()
        out[flax_key(k, a.ndim == 0)] = a.reshape(1) if a.ndim == 0 else a
    return out


def flat_to_state(like: Dict[str, torch.Tensor], flat: Dict[str, np.ndarray],
                  optional: AbstractSet[str] = frozenset()) -> Dict[str, torch.Tensor]:
    """The entries of a JAX-package flat dict under the names and shapes of
    ``like`` (CPU tensors); every key must match, but the keys of ``like``
    named in ``optional`` may be absent from ``flat`` (and from the result)."""
    want = {flax_key(k, v.dim() == 0): k for k, v in like.items()
            if k not in optional or flax_key(k, v.dim() == 0) in flat}
    missing = sorted(set(want) - set(flat))
    unexpected = sorted(set(flat) - set(want))
    if missing or unexpected:
        raise KeyError(f"weight keys differ: missing {missing[:8]}, unexpected {unexpected[:8]}")
    out = {}
    for fk, tk in want.items():
        a = np.asarray(flat[fk])
        if a.dtype != np.float64:
            a = a.astype(np.float32)
        shape = tuple(like[tk].shape)
        if a.shape != (shape or (1,)):
            raise ValueError(f"{fk}: shape {a.shape} does not fit {shape}")
        out[tk] = torch.from_numpy(a.copy()).reshape(shape)
    return out


def to_flat(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's state as the JAX package's flat dict (fp32 numpy)."""
    return state_to_flat({k: v.float() for k, v in module.state_dict().items()})


def load_flat(module: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Load a JAX-package flat dict into ``module``; every key must match.
    A label-conditioned DAE whose flat dict has no label-conditioning
    weights at all (JAX's init creates them only when it runs them) gets a
    fresh, seeded label conditioning that leaves its blocks as they are."""
    state = module.state_dict()
    optional = module.label_embedding_keys() if hasattr(module, "label_embedding_keys") else set()
    loaded = flat_to_state(state, flat, optional)
    absent = set(state) - set(loaded)
    if absent and absent != optional:
        raise KeyError(f"weight keys differ: missing {sorted(absent)[:8]}")
    if absent:
        device = next(iter(state.values())).device
        module.init_label_embedding(torch.Generator(device=device).manual_seed(0))
    module.load_state_dict(loaded, strict=not absent)
