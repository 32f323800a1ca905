"""Training entry point of the port (JAX: train.py at the repository root).

    python -m dualdiffusion_tpu_torch.train --model_path <dir> \
        --train_config_path <json> [--dataset_path <dir>] [--resume] \
        [--max_steps N] [--device cuda|cpu] [--model_axis N] [--num_dcn_slices N]

    python -m torch.distributed.run --nproc_per_node N \
        -m dualdiffusion_tpu_torch.train ...       (N processes, one per card)

The train config is a TrainerConfig JSON; the model directory is a pipeline
model directory (``Pipeline.save_pretrained``); the dataset is a directory
with ``train.jsonl`` and the files it names: pre-encoded latents
(safetensors) for the UNet trainer, WAV audio for the DAE trainer (the
dataloader's ``load_datatypes``, see ``dataset/dataloader.py``).
``--device`` defaults to ``cuda`` and never falls
back: without a GPU, training on the CPU takes ``--device cpu``.

Under a launcher (``torch.distributed.run``, or the JAX package's
``DD_COORDINATOR_ADDRESS`` / ``DD_NUM_PROCESSES`` / ``DD_PROCESS_ID``) each
process trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``), on a ("data", "model") mesh of all ranks: data parallelism, FSDP
with the config's ``parallel.fsdp``, tensor parallelism with
``parallel.model_axis`` > 1 (``--model_axis`` and ``--num_dcn_slices``
override the config's ``parallel``). The global batch is device batch x
accumulation x data-axis width; each data rank loads its share of the
dataset, and rank 0 writes every file (``training/trainer.py``). On one
process FSDP is the plain trainer, as JAX's sharding over one device moves
nothing; a model axis asked of one process raises the mesh's error.
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
    ap.add_argument("--model_axis", type=int, default=None,
                    help="tensor-parallel width (overrides the config's parallel.model_axis)")
    ap.add_argument("--num_dcn_slices", type=int, default=None,
                    help="nodes of the data axis's outer blocks (overrides the config's "
                         "parallel.num_dcn_slices)")
    return ap.parse_args(argv)


def trained_modules(tconf) -> list:
    """The pipeline modules a config trains: its module, and the DAE beside
    the DDEC of the joint trainer."""
    return [tconf.module_name] + (["dae"] if tconf.module_trainer == "dae_ddec" else [])


def build_trainer(args: argparse.Namespace):
    """The Trainer of ``args``' model, config and dataset, resumed from the
    latest checkpoint with ``--resume``."""
    import itertools
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from .dataset import DatasetConfig, DualDiffusionDataset
    from .parallel import (MeshConfig, ParallelState, local_device, make_mesh,
                           maybe_initialize_distributed)
    from .pipelines.pipeline import Pipeline
    from .training import builders  # noqa: F401 (registers the module trainers)
    from .training.trainer import Trainer, TrainerConfig, get_module_trainer
    from .utils import DATASET_PATH, load_config

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU")
    tconf = load_config(TrainerConfig, args.train_config_path)
    tconf.model_path = args.model_path
    pconf = tconf.parallel
    if args.model_axis is not None:
        pconf.model_axis = args.model_axis
    if args.num_dcn_slices is not None:
        pconf.num_dcn_slices = args.num_dcn_slices
    # the process group first, before anything is built on a device
    launched = "WORLD_SIZE" in os.environ or "DD_NUM_PROCESSES" in os.environ
    parallel = None
    if maybe_initialize_distributed(device=args.device,
                                    always=launched or pconf.model_axis > 1):
        parallel = ParallelState(make_mesh(MeshConfig(model_axis=pconf.model_axis,
                                                      num_dcn_slices=pconf.num_dcn_slices)),
                                 fsdp=pconf.fsdp)
        logger.info("rank %d/%d: mesh %s, fsdp %s", dist.get_rank(), dist.get_world_size(),
                    dict(zip(parallel.mesh.mesh_dim_names, parallel.mesh.shape)), pconf.fsdp)
    device = local_device(args.device)

    pipeline = Pipeline.from_pretrained(args.model_path, device=device, load_checkpoints=False)
    if parallel is not None:
        for name in trained_modules(tconf):
            parallel.prepare(pipeline.modules[name].module)
    generator = torch.Generator(device=device).manual_seed(tconf.seed)
    builder = get_module_trainer(tconf.module_trainer)
    step, state, export_fn, ema_bank, batch_adapter = builder(pipeline, tconf, generator,
                                                              parallel=parallel)

    data_dir = args.dataset_path or DATASET_PATH
    if not data_dir:
        raise ValueError("set --dataset_path or DATASET_PATH")
    dl = tconf.dataloader
    data = parallel.data if parallel is not None else None
    ds = DualDiffusionDataset(
        DatasetConfig(data_dir=data_dir, load_datatypes=tuple(dl.load_datatypes),
                      raw_crop_width=dl.raw_crop_width, latents_crop_width=dl.latents_crop_width,
                      filter_unnormalized_samples=dl.filter_unnormalized_samples),
        rng=np.random.default_rng(tconf.seed),
        process_index=data.rank if data else 0, process_count=data.size if data else 1)
    logger.info("dataset: %d samples (%s filtered)", len(ds), ds.num_filtered_samples)
    local_batch = tconf.device_batch_size * tconf.gradient_accumulation_steps
    # every data rank takes as many batches an epoch as the one with the fewest
    n_batches = torch.tensor(len(ds.splits.get("train", [])) // local_batch, device=device)
    if data is not None and data.size > 1:
        dist.all_reduce(n_batches, dist.ReduceOp.MIN, group=data.group)
    n_batches = int(n_batches)

    class EpochLoader:
        """Per-epoch shuffle seed and mid-epoch fast-forward on resume."""

        def epoch_iter(self, epoch: int, skip_batches: int = 0):
            batches = ds.iter_batches("train", local_batch, seed=tconf.seed + epoch,
                                      prefetch=dl.prefetch_batches, skip_batches=skip_batches)
            for batch in itertools.islice(batches, max(n_batches - skip_batches, 0)):
                paths = batch.pop("paths", None)
                out = batch_adapter(batch)
                if paths is not None:
                    out["paths"] = paths
                yield out

    trainer = Trainer(tconf, step, state, EpochLoader(), ema_bank=ema_bank,
                      export_module_fn=export_fn, parallel=parallel)
    if args.resume:
        trainer.load_checkpoint()
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    from .parallel import shutdown
    args = parse_args(argv)
    try:
        trainer = build_trainer(args)
        trainer.train(max_steps=args.max_steps)
        logger.info("training done at step %d", trainer.state.global_step)
    finally:
        shutdown()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
