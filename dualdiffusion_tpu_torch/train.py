"""Training entry point of the port (JAX: train.py at the repository root).

    python -m dualdiffusion_tpu_torch.train --model_path <dir> \
        --train_config_path <json> [--dataset_path <dir>] [--resume] \
        [--max_steps N] [--device cuda|cpu]

The train config is a TrainerConfig JSON; the model directory is a pipeline
model directory (``Pipeline.save_pretrained``); the dataset is a directory
with ``train.jsonl`` and the files it names: pre-encoded latents
(safetensors) for the UNet trainer, WAV audio for the DAE trainer (the
dataloader's ``load_datatypes``, see ``dataset/dataloader.py``).
``--device`` defaults to ``cuda`` and never falls
back: without a GPU, training on the CPU takes ``--device cpu``. The JAX
entry's mesh flags (``--model_axis``, ``--num_dcn_slices``) have no
counterpart: the port trains on one device.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

logger = logging.getLogger("dualdiffusion_tpu_torch.train")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dualdiffusion_tpu_torch.train")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--train_config_path", required=True)
    ap.add_argument("--dataset_path", default=None,
                    help="dataset directory (default: $DATASET_PATH)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace):
    """The Trainer of ``args``' model, config and dataset, resumed from the
    latest checkpoint with ``--resume``."""
    import numpy as np
    import torch

    from .dataset import DatasetConfig, DualDiffusionDataset
    from .pipelines.pipeline import Pipeline
    from .training import builders  # noqa: F401 (registers the module trainers)
    from .training.trainer import Trainer, TrainerConfig, get_module_trainer
    from .utils import DATASET_PATH, load_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU")
    tconf = load_config(TrainerConfig, args.train_config_path)
    tconf.model_path = args.model_path
    if tconf.parallel.model_axis != 1 or tconf.parallel.fsdp or tconf.parallel.num_dcn_slices != 1:
        raise NotImplementedError("model-parallel, FSDP and multi-slice training are not ported")

    pipeline = Pipeline.from_pretrained(args.model_path, device=device, load_checkpoints=False)
    generator = torch.Generator(device=device).manual_seed(tconf.seed)
    builder = get_module_trainer(tconf.module_trainer)
    step, state, export_fn, ema_bank, batch_adapter = builder(pipeline, tconf, generator)

    data_dir = args.dataset_path or DATASET_PATH
    if not data_dir:
        raise ValueError("set --dataset_path or DATASET_PATH")
    dl = tconf.dataloader
    ds = DualDiffusionDataset(
        DatasetConfig(data_dir=data_dir, load_datatypes=tuple(dl.load_datatypes),
                      raw_crop_width=dl.raw_crop_width, latents_crop_width=dl.latents_crop_width,
                      filter_unnormalized_samples=dl.filter_unnormalized_samples),
        rng=np.random.default_rng(tconf.seed))
    logger.info("dataset: %d samples (%s filtered)", len(ds), ds.num_filtered_samples)
    local_batch = tconf.device_batch_size * tconf.gradient_accumulation_steps

    class EpochLoader:
        """Per-epoch shuffle seed and mid-epoch fast-forward on resume."""

        def epoch_iter(self, epoch: int, skip_batches: int = 0):
            for batch in ds.iter_batches("train", local_batch, seed=tconf.seed + epoch,
                                         prefetch=dl.prefetch_batches,
                                         skip_batches=skip_batches):
                paths = batch.pop("paths", None)
                out = batch_adapter(batch)
                if paths is not None:
                    out["paths"] = paths
                yield out

    trainer = Trainer(tconf, step, state, EpochLoader(), ema_bank=ema_bank,
                      export_module_fn=export_fn)
    if args.resume:
        trainer.load_checkpoint()
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    trainer = build_trainer(args)
    trainer.train(max_steps=args.max_steps)
    logger.info("training done at step %d", trainer.state.global_step)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
