"""Tiny cells for the CPU tests: a copy of the benchmark's folder under a
temporary root, with a ``BENCHMARK.json`` whose configurations are cut to
a size the CPU runs in seconds (every cut is of a size, none of a path)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.common import HERE, load_json

TINY_UNET = dict(model_channels=16, channel_mult=[1, 2], channel_mult_noise=None,
                 channel_mult_emb=None, in_channels_emb=16, num_layers_per_block=1,
                 attn_levels=[1], channels_per_head=8, logvar_channels=8)
TINY_DAE = dict(model_channels=8, channel_mult_enc=[1, 2], channel_mult_dec=[1, 2],
                num_enc_layers_per_block=1, num_dec_layers_per_block=1)
TINY_DDEC = dict(model_channels=8, channel_mult=[1, 2], num_layers_per_block=1,
                 logvar_channels=8)
TINY_TRAFFIC = dict(steps=3)
#: the largest batch of a tiny cell: enough to leave half of it out
TINY_BATCH = 4


def tiny_traffic(traffic: dict) -> dict:
    """``traffic`` at a tiny size: fewer steps, a batch of at most ``TINY_BATCH``."""
    return dict(traffic, **TINY_TRAFFIC, batch=min(traffic["batch"], TINY_BATCH))


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(load_json(HERE / "configs" / f"{name}.json"))
    cfg["unet"].update(TINY_UNET)
    cfg["unet"]["mlp_groups"] = min(cfg["unet"]["mlp_groups"], 2)
    cfg["dae"].update(TINY_DAE)
    if "ddec" in cfg:
        cfg["ddec"].update(TINY_DDEC)
    # 32,000 samples: 64 mel frames (spectrogram), 128 (MS-MDCT dual)
    cfg["format"]["default_raw_length"] = 32768
    if "num_fgla_iters" in cfg["format"]:
        cfg["format"]["num_fgla_iters"] = 3
    return cfg


def tiny_root(tmp: Path) -> Path:
    """A root holding ``BENCHMARK.json`` and ``benchmark/`` with every cell
    of the benchmark at a tiny size."""
    root = Path(tmp)
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = load_json(HERE.parent / "BENCHMARK.json")
    for c in spec["configs"]:
        (root / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    for w in spec["workloads"]:
        path = root / "benchmark" / "traffic" / f"{w['traffic']}.json"
        path.write_text(json.dumps(tiny_traffic(load_json(path))))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
