"""Model factory entry point of the port (JAX: create_new_model.py at the
repository root; reference: src/create_new_model.py:64-154).

    python -m dualdiffusion_tpu_torch.create_new_model --name <name> \
        [--config_path configs/models] [--output_path <dir>] [--seed 42] \
        [--device cuda|cpu]

Reads the model config directory ``<config_path>/<name>/``:
``model_index.json`` ({"modules": {name: type}}) and one ``<name>.json`` per
module. Builds every module on ``--device`` (the card unless ``cpu`` is
asked for) with weights drawn from a ``torch.Generator`` seeded by
``--seed``, normalizes the MP weights, logs each module's parameter counts,
writes the model directory ``<output_path or $MODELS_PATH or models>/<name>``
(refusing one that exists), and a ``train_<module>.sh`` for every module that
is not a format, each running ``python -m dualdiffusion_tpu_torch.train``.
"""

from __future__ import annotations

import argparse
import logging
import stat
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

logger = logging.getLogger("create_new_model")

REPO_ROOT = Path(__file__).resolve().parents[1]


def init_module(module_type: str, config, generator: torch.Generator, device):
    """A registered module built on ``device``, its weights drawn from
    ``generator`` and its MP weights normalized; formats as they are."""
    from .pipelines.pipeline import get_module_class
    from .training.optim import normalize_mp_weights
    factory, _ = get_module_class(module_type)
    module = factory(config, device)
    if module_type.startswith("format:"):
        return module
    if not hasattr(module, "init_weights"):
        raise ValueError(f"don't know how to init module type '{module_type}'")
    module.init_weights(generator)
    normalize_mp_weights(module)
    return module


def module_param_counts(module) -> Optional[Dict[str, int]]:
    """{"total", "emb"} over the module's saved leaves, under the JAX
    package's names: "emb" counts the leaves with "emb" in a path element.
    None for a module without weights."""
    if not isinstance(module, torch.nn.Module):
        return None
    from .weights import flax_key
    total = emb = 0
    for k, v in module.state_dict().items():
        n = v.numel()
        total += n
        if any("emb" in part for part in flax_key(k, v.dim() == 0).split("/")):
            emb += n
    return {"total": total, "emb": emb}


def print_module_info(name: str, module) -> int:
    counts = module_param_counts(module)
    if counts is None:
        logger.info("  %s: (no parameters)", name)
        return 0
    logger.info("  %s: %.2fM params (%.2fM emb)", name, counts["total"] / 1e6,
                counts["emb"] / 1e6)
    return counts["total"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dualdiffusion_tpu_torch.create_new_model")
    ap.add_argument("--name", required=True, help="model name (config dir)")
    ap.add_argument("--config_path", default="configs/models")
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = parse_args(argv)
    from .pipelines.pipeline import ModuleHandle, Pipeline, get_module_class
    from .utils import MODELS_PATH, config_from_dict, load_json

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to create the model on the CPU")
    cfg_dir = Path(args.config_path) / args.name
    index = load_json(cfg_dir / "model_index.json")
    out_dir = Path(args.output_path or MODELS_PATH or "models") / args.name
    if out_dir.exists():
        logger.error("output dir %s already exists; refusing to overwrite", out_dir)
        sys.exit(1)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    modules = {}
    logger.info("creating model '%s' on %s:", args.name, device)
    total = 0
    for mod_name, mod_type in index["modules"].items():
        _, cfg_cls = get_module_class(mod_type)
        config = config_from_dict(cfg_cls, load_json(cfg_dir / f"{mod_name}.json"))
        module = init_module(mod_type, config, generator, device)
        total += print_module_info(mod_name, module)
        modules[mod_name] = ModuleHandle(mod_name, mod_type, config, module)
    logger.info("total: %.2fM params", total / 1e6)

    Pipeline(modules).save_pretrained(out_dir)
    logger.info("saved to %s", out_dir)

    # per-module train scripts (reference :128-154)
    for mod_name, mod_type in index["modules"].items():
        if mod_type.startswith("format:"):
            continue
        train_cfg = cfg_dir / f"{mod_name}_train.json"
        script = out_dir / f"train_{mod_name}.sh"
        script.write_text(
            "#!/bin/sh\n"
            f"PYTHONPATH=\"{REPO_ROOT}${{PYTHONPATH:+:$PYTHONPATH}}\" \\\n"
            "python -m dualdiffusion_tpu_torch.train \\\n"
            f"  --model_path {out_dir.resolve()} \\\n"
            f"  --train_config_path {train_cfg.resolve()} \"$@\"\n")
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        logger.info("wrote %s", script)
    return out_dir


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
