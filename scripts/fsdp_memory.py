#!/usr/bin/env python3
"""Device memory and step seconds of the reference-scale UNet's train step
under data parallelism and under FSDP, one rank per NVIDIA GPU.

    python3 scripts/fsdp_memory.py                      # one rank per visible card
    python3 scripts/fsdp_memory.py --device cpu --nproc 4   # gloo, a tiny UNet

Run from the root of a checkout. It builds the kernels, then starts itself
under ``python -m torch.distributed.run`` (NCCL, one rank per card). Each
rank builds the reference-scale UNet of ``chip_smoke.py`` (356M parameters,
seeded random weights, the same on every rank), AdamW and one EMA profile,
and runs ``STEPS + 1`` train steps of a device batch of 8 x accumulation 2
(the UNet training path's) on seeded 45 s latents, the first with its
weights whole (data parallelism), then with them sharded over the ranks by
``parallel.fsdp``. For each mode rank 0 prints one JSON line: the bytes of
weights, optimizer moments and EMA a rank holds, the most memory allocated
on any rank before a step and during one (``torch.cuda.max_memory_allocated``
after a reset), and the median seconds of the steps after the first; then
the card's name and power limit. Checks that both modes' first losses agree
to 1e-5 relative (the same forward on the same weights) and every loss is
finite. ``--device cpu`` runs the same on gloo ranks with a tiny UNet, to
try the script without a card; it prints no memory.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

STEPS = 4                 # timed steps a mode, after the first
BATCH, ACCUM = 8, 2       # the UNet training path's device batch and accumulation
LATENT_HWC = (32, 688, 4)  # 45 s of reference-scale latents


def configs(tiny: bool):
    """(UNet config, latent (H, W, C), device batch)."""
    from dualdiffusion_tpu_torch.models import UNetConfig
    if tiny:
        return (UNetConfig(in_channels=4, out_channels=4, in_channels_emb=16,
                           model_channels=16, channel_mult=(1, 2), num_layers_per_block=1,
                           channels_per_head=16, mlp_multiplier=2, mlp_groups=2,
                           attn_levels=(1,)), (8, 16, 4), 2)
    from chip_smoke import ref_scale_configs
    return ref_scale_configs()[0], LATENT_HWC, BATCH


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t.dim() > 0)


def rank_main(device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from dualdiffusion_tpu_torch.models import UNet
    from dualdiffusion_tpu_torch.parallel import (MeshConfig, ParallelState, local_device,
                                                  make_mesh, maybe_initialize_distributed,
                                                  shard_batch, shutdown)
    from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSampler,
                                                  UNetTrainConfig, build_optimizer,
                                                  init_train_state, make_unet_train_step)
    from dualdiffusion_tpu_torch.training.train_state import draw_unet_step

    cpu = device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    maybe_initialize_distributed(device=device, always=True)
    dev = local_device(device)
    cfg, hwc, batch = configs(cpu)
    mesh = make_mesh(MeshConfig())
    world = dist.get_world_size()
    n = batch * ACCUM * world
    tc = UNetTrainConfig(grad_accum_steps=ACCUM)

    def most(x: float) -> float:
        t = torch.tensor(x, dtype=torch.float64, device=dev)
        dist.all_reduce(t, dist.ReduceOp.MAX)
        return float(t)

    first = {}
    try:
        for mode in ("dp", "fsdp"):
            model = UNet(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
            parallel = ParallelState(mesh, fsdp=mode == "fsdp")
            parallel.prepare(model)
            opt = build_optimizer("adamw", model.parameters(), 3e-3)
            opt.axis = parallel.data
            bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
            step = make_unet_train_step(opt, bank, tc, n, data=parallel.data)
            state = init_train_state(model, opt, bank, tc.sigma, torch.Generator(device=dev))
            gen = torch.Generator().manual_seed(11)
            losses, seconds, before, during = [], [], [], []
            for _ in range(STEPS + 1):
                glob = {"samples": torch.randn((n,) + hwc, generator=gen),
                        "embeddings": torch.randn((n, cfg.in_channels_emb), generator=gen)}
                draws = draw_unet_step(gen, SigmaSampler(tc.sigma), tc, n,
                                       (n // ACCUM,) + hwc, True, 0)
                local = shard_batch(mesh, glob, ACCUM, device=dev)
                draws = draws.to(dev)
                if not cpu:
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    before.append(torch.cuda.memory_allocated(dev))
                dist.barrier()
                t0 = time.perf_counter()
                losses.append(float(step(state, local, draws)["loss"]))
                if not cpu:
                    torch.cuda.synchronize(dev)
                    during.append(torch.cuda.max_memory_allocated(dev))
                seconds.append(most(time.perf_counter() - t0))
            held = {"weights": nbytes(model.parameters()),
                    "moments": nbytes(v for s in opt.adamw.state.values() for v in s.values()),
                    "ema": nbytes(v for p in state.ema_state.values() for v in p.values())}
            res = {"mode": mode, "ranks": world, "losses": losses,
                   "step_s_median": float(np.median(seconds[1:])), "step_s": seconds,
                   "held_gib": {k: v / 2 ** 30 for k, v in held.items()}}
            if not cpu:
                res["before_step_gib"] = most(max(before)) / 2 ** 30
                res["peak_step_gib"] = most(max(during)) / 2 ** 30
            first[mode] = losses[0]
            if dist.get_rank() == 0:
                print(json.dumps(res), flush=True)
            if not all(np.isfinite(losses)):
                raise AssertionError(f"{mode}: non-finite loss {losses}")
            del model, opt, bank, step, state
            if not cpu:
                torch.cuda.empty_cache()
        rel = abs(first["fsdp"] - first["dp"]) / abs(first["dp"])
        if rel > 1e-5:
            raise AssertionError(f"first losses differ: {first} (relative {rel:.3g})")
    finally:
        shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: every visible card; 2 on the CPU)")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        rank_main(args.device)
        return 0
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("needs an NVIDIA GPU (or --device cpu)", file=sys.stderr)
            return 1
        from dualdiffusion_tpu_torch.ops.kernels.build import library
        lib = library()
        print(f"kernels built in {lib.build_seconds:.1f} s", flush=True)
    nproc = args.nproc or (torch.cuda.device_count() if args.device == "cuda" else 2)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(nproc), __file__, "--rank",
                           "--device", args.device], env=env, timeout=1500)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
