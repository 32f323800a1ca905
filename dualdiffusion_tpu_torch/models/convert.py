"""Model surgery on model directories: the inpainting conversion of a UNet and
weight blending between two directories (JAX: dualdiffusion_tpu/models/
convert.py:23-83; reference: src/modules/utils/convert_unet_to_inpainting.py:22-53,
combine_models.py).

Both work on the JAX package's flat weights through the port's modules, so a
directory written by either package converts to the same files.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Union

import numpy as np

from ..utils import load_json, save_json
from ..weights import load_flat, to_flat

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
