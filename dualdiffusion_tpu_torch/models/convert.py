"""Model surgery on model directories: the inpainting conversion of a UNet and
weight blending between two directories (JAX: dualdiffusion_tpu/models/
convert.py:23-83; reference: src/modules/utils/convert_unet_to_inpainting.py:22-53,
combine_models.py), and the converters of the reference's own torch
checkpoints (JAX convert.py:85-247).

The first two work on the JAX package's flat weights through the port's
modules, so a directory written by either package converts to the same
files. The converters map the reference's state-dict names onto the flax
paths the JAX package gives them, and those onto the port's ``state_dict``
names through ``weights.flax_key``; the weight layouts are the same.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..utils import load_json, save_json
from ..weights import flax_key, load_flat, to_flat

logger = logging.getLogger(__name__)

#: the flat keys of the UNet's input conv
ENC_CONV_IN = "params/core/enc_conv_in/"


def convert_unet_to_inpainting(model_path: Union[str, Path], module_name: str = "unet",
                               output_name: str = "unet_inpainting") -> Path:
    """Save ``module_name`` as ``output_name`` with ``out_channels + 1`` more
    input channels (the inpainting reference and its mask), their input-conv
    weights zero, and register it in ``model_index.json``. With a zero
    reference the converted UNet computes what the original does, so it can
    be fine-tuned from the original's weights."""
    from ..pipelines.pipeline import get_module_class, load_module, save_module
    module_type, config, module = load_module(model_path, module_name, "cpu")
    extra = config.out_channels + 1
    flat = to_flat(module)
    # the conv's weight leaf, (out, in, kh, kw): the one named w*, as JAX finds it
    key = next(k for k in flat if k.startswith(ENC_CONV_IN) and
               k[len(ENC_CONV_IN):].startswith("w"))
    w = flat[key]
    pad = np.zeros((w.shape[0], extra) + w.shape[2:], w.dtype)
    flat[key] = np.concatenate([w, pad], axis=1)
    new_config = dataclasses.replace(config, in_channels=config.in_channels + extra)
    factory, _ = get_module_class(module_type)
    new_module = factory(new_config, "cpu")
    load_flat(new_module, flat)
    save_module(model_path, output_name, module_type, new_config, new_module)
    index_path = Path(model_path) / "model_index.json"
    index = load_json(index_path)
    index["modules"][output_name] = module_type
    save_json(index, index_path)
    out = Path(model_path) / output_name
    logger.info("wrote inpainting module to %s", out)
    return out


def combine_models(model_path_a: Union[str, Path], model_path_b: Union[str, Path],
                   module_name: str, t: float, output_path: Union[str, Path]) -> None:
    """Write ``(1 - t) * A + t * B`` of ``module_name``'s weights, with A's
    config, to ``output_path/module_name``."""
    from ..pipelines.pipeline import load_module, save_module
    type_a, config, module_a = load_module(model_path_a, module_name, "cpu")
    type_b, _, module_b = load_module(model_path_b, module_name, "cpu")
    if type_a != type_b:
        raise ValueError(f"module type mismatch: {type_a} vs {type_b}")
    fa, fb = to_flat(module_a), to_flat(module_b)
    load_flat(module_a, {k: fa[k] * (1.0 - t) + fb[k] * t for k in fa})
    save_module(output_path, module_name, type_a, config, module_a)
    logger.info("wrote blended module (t=%.3f) to %s", t, output_path)


# ---------------------------------------------------------------------------
# the reference's (torch) UNet and DAE checkpoints -> the port's state dicts
# ---------------------------------------------------------------------------

# the grammar copied from dualdiffusion_tpu/models/convert.py
def _torch_key_to_flax_path(key: str) -> Tuple[str, ...]:
    """The flax param path of one reference UNet state-dict key (reference:
    src/modules/unets/unet_edm2_q4_ddec.py:224-305 and unet_edm2_d1.py:224-330):
    enc.conv_in / enc.block{l}_down / enc.block{l}_layer{i} /
    dec.block{l}_in0|in1 / dec.block{l}_up / dec.block{l}_layer{i}, each
    with conv_res0/conv_res1/conv_skip/emb_gain/emb_linear (and
    attn_qk/attn_v/attn_proj with their emb gains), plus the top-level
    emb_noise/emb_label/emb_label_unconditional/logvar_linear/conv_out/
    out_gain."""
    parts = key.split(".")

    def leaf(mod_parts):
        tail = mod_parts[-1]
        if tail == "weight":
            return mod_parts[:-1], "w_mp"
        if tail == "bias":
            return mod_parts[:-1], "bias"
        return mod_parts, None  # scalar params (emb_gain, out_gain)

    def path(prefix, mod_parts):
        mods, l = leaf(mod_parts)
        return tuple(prefix) + tuple(mods) + ((l,) if l else ())

    if parts[0] in ("enc", "dec"):
        block = parts[1]
        if block == "conv_in":
            return path(("core", "enc_conv_in"), parts[2:])
        m = re.fullmatch(r"block(\d+)_(down|up|in0|in1)", block)
        if m:
            name = f"{parts[0]}_b{m.group(1)}_{m.group(2)}"
        else:
            m = re.fullmatch(r"block(\d+)_layer(\d+)", block)
            if not m:
                raise KeyError(f"unrecognized block key: {key}")
            name = f"{parts[0]}_b{m.group(1)}_l{m.group(2)}"
        rest = parts[2:]
        if rest in (["emb_gain"], ["emb_gain_qk"], ["emb_gain_v"]):
            return ("core", name, rest[0])
        return path(("core", name), rest)
    if parts == ["out_gain"]:
        return ("core", "out_gain")
    if parts[0] in ("conv_out", "emb_noise"):
        return path(("core",), parts)
    if parts[0] in ("emb_label", "emb_label_unconditional"):
        return path((), parts)
    if parts[0] == "logvar_linear":
        mods, l = leaf(parts)
        # weight norm disabled: the raw weight's name
        return tuple(mods) + (("w_raw",) if l == "w_mp" else (l,))
    raise KeyError(f"unrecognized reference UNet key: {key}")


def _template_params(template: nn.Module) -> Dict[Tuple[str, ...], str]:
    """The template's "params" leaves: flax path -> its ``state_dict`` key."""
    out = {}
    for k in template.state_dict():
        collection, path = flax_key(k, False).split("/", 1)
        if collection == "params":
            out[tuple(path.split("/"))] = k
    return out


def _convert(state_dict: Mapping, template: nn.Module, path_of, skip) -> Dict[str, torch.Tensor]:
    params = _template_params(template)
    out = {k: v.detach().clone() for k, v in template.state_dict().items()}
    used = set()
    for key, val in state_dict.items():
        if skip(key):
            continue
        path = path_of(key)
        if path not in params:
            raise KeyError(f"{key} -> {path} not in template tree; "
                           f"have e.g. {sorted(params)[:6]}")
        tk = params[path]
        out[tk] = torch.from_numpy(np.array(np.asarray(val, np.float32))).reshape(out[tk].shape)
        used.add(path)
    missing = set(params) - used
    if missing:
        raise KeyError(f"template params not covered by state dict: {sorted(missing)[:8]}")
    return out


def torch_unet_state_to_state(state_dict: Mapping, template: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference torch UNet state dict (numpy- or tensor-valued) as the
    port's ``state_dict`` of ``template`` (a UNet of the matching config):
    every reference key must name a template parameter, and every template
    parameter must be named. The MPFourier buffers carry no information (both
    compute them) and are skipped."""
    return _convert(state_dict, template, _torch_key_to_flax_path,
                    lambda key: key.endswith(("freqs", "phases")))


def torch_dae_state_to_state(state_dict: Mapping, template: nn.Module, num_levels: int,
                             num_enc_layers: int, num_dec_layers: int
                             ) -> Dict[str, torch.Tensor]:
    """A reference torch DAE (q4) state dict as the port's ``state_dict`` of
    ``template`` (reference: src/modules/daes/dae_edm2_q4.py:205-300). The
    reference's enc/dec ModuleDicts are ordered as the port's ``enc``/``dec``
    lists, so names map by position: the encoder [block{l}_down (l > 0)] +
    its layers per level, the decoder [block{L-1}_in0 | block{l}_up] + its
    layers, levels reversed. The latent stats tracker's running stats are
    skipped: the template's stay."""
    enc_names, dec_names = [], []
    for level in range(num_levels):
        if level > 0:
            enc_names.append(f"block{level}_down")
        enc_names += [f"block{level}_layer{i}" for i in range(num_enc_layers)]
    for level in reversed(range(num_levels)):
        dec_names.append(f"block{level}_in0" if level == num_levels - 1 else f"block{level}_up")
        dec_names += [f"block{level}_layer{i}" for i in range(num_dec_layers)]
    enc_idx = {n: i for i, n in enumerate(enc_names)}
    dec_idx = {n: i for i, n in enumerate(dec_names)}

    def path_of(key: str) -> Tuple[str, ...]:
        parts = key.split(".")
        leaf = {"weight": "w_mp", "bias": "bias"}.get(parts[-1])
        tail = (leaf,) if leaf else (parts[-1],)
        if parts[0] == "enc":
            if parts[1] == "conv_in":
                return ("conv_in", leaf)
            return (f"enc_{enc_idx[parts[1]]}",) + tuple(parts[2:-1]) + tail
        if parts[0] == "dec":
            return (f"dec_{dec_idx[parts[1]]}",) + tuple(parts[2:-1]) + tail
        if parts[0] in ("conv_latents_out", "conv_latents_in", "conv_out"):
            return (parts[0], leaf)
        if parts in (["out_gain"], ["recon_loss_logvar"]):
            return (parts[0],)
        raise KeyError(f"unrecognized reference DAE key: {key}")

    return _convert(state_dict, template, path_of,
                    lambda key: key.startswith("latents_stats_tracker"))
