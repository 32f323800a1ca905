#!/usr/bin/env python3
"""Device memory and seconds of the reference-scale UNet's pipelined denoise,
one pipeline stage per NVIDIA GPU, against the whole model on one card.

    python3 scripts/pipeline_memory.py                      # one rank per visible card
    python3 scripts/pipeline_memory.py --device cpu --nproc 4   # gloo, a tiny UNet

Run from the root of a checkout. It builds the kernels, then starts itself
under ``python -m torch.distributed.run`` (NCCL, one rank per card). Each
rank builds the reference-scale UNet of ``chip_smoke.py`` (356M parameters,
seeded random weights, the same on every rank) on the host, keeps its own
stage of the FLOP-balanced plan (``parallel.keep_stage``) and moves it to its
card. For batches of 2 (the sampler's CFG batch) and 8, as microbatches of
1, it times ``pipelined_denoise`` on 45 s latents (the median of ``REPEATS``
calls after a warm-up, the slowest rank's). Rank 0 then builds the whole
model on its card and times the plain forward of the same batches. Rank 0
prints one JSON line per batch: the plan, the parameters and bytes each rank
holds, each rank's peak memory during the pipelined calls
(``torch.cuda.max_memory_allocated`` after a reset), the seconds, the whole
model's seconds and peak memory, and the pipelined output's largest
difference from the whole model's trunk run microbatch by microbatch (0:
the same kernels on the same inputs) and from its forward of the batch;
then the card's name and power limit. ``--device cpu`` runs the same on
gloo ranks with a tiny UNet; it prints no memory.
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

REPEATS = 5               # timed calls a batch, after a warm-up
BATCHES = (2, 8)          # the CFG batch of the sampler, and 8; microbatches of 1
LATENT_HWC = (32, 688, 4)  # 45 s of reference-scale latents
SIGMA = 10.0


def configs(tiny: bool):
    """(UNet config, latent (H, W, C))."""
    from dualdiffusion_tpu_torch.models import UNetConfig
    if tiny:
        return (UNetConfig(in_channels=4, out_channels=4, in_channels_emb=16,
                           model_channels=16, channel_mult=(1, 2, 3), num_layers_per_block=1,
                           channels_per_head=16, mlp_multiplier=2, mlp_groups=2,
                           attn_levels=(2,)), (8, 32, 4))
    from chip_smoke import ref_scale_configs
    return ref_scale_configs()[0], LATENT_HWC


def build_unet(cfg):
    """The seeded UNet on the host, out_gain 1 (zero mutes the trunk)."""
    import torch
    from dualdiffusion_tpu_torch.models import UNet
    unet = UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    return unet


def inputs(unet, batch: int, hwc, dev):
    """Seeded latents at ``SIGMA`` and prompt embeddings, on ``dev``."""
    import torch
    g = torch.Generator().manual_seed(batch)
    x = SIGMA * torch.randn((batch,) + tuple(hwc), generator=g)
    prompt = torch.randn((batch, unet.cfg.in_channels_emb), generator=g)
    with torch.no_grad():
        emb = unet.get_embeddings(prompt.to(dev), torch.ones(batch, device=dev))
    return x.to(dev), torch.full((batch,), SIGMA, device=dev), emb


def rank_main(device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from dualdiffusion_tpu_torch.parallel import (Axis, MeshConfig, build_stage_plan,
                                                  keep_stage, local_device, make_mesh,
                                                  maybe_initialize_distributed,
                                                  pipelined_denoise, shutdown)

    cpu = device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    maybe_initialize_distributed(device=device, always=True)
    dev = local_device(device)
    cfg, hwc = configs(cpu)
    world = dist.get_world_size()
    axis = Axis.of(make_mesh(MeshConfig(model_axis=world)), "model")
    rank = axis.rank

    def sync():
        if not cpu:
            torch.cuda.synchronize(dev)

    def most(x: float) -> float:
        t = torch.tensor(x, dtype=torch.float64, device=dev)
        dist.all_reduce(t, dist.ReduceOp.MAX)
        return float(t)

    def every(obj):
        out = [None] * world
        dist.all_gather_object(out, obj)
        return out

    try:
        unet = build_unet(cfg)
        plan = build_stage_plan(cfg, (1,) + tuple(hwc), world)
        keep_stage(unet.core, plan, rank)
        unet.to(dev)
        held = every({"params": sum(p.numel() for p in unet.parameters()),
                      "stage_params": sum(p.numel() for n, p in unet.core.named_parameters()
                                          if not n.startswith("emb_noise.")),
                      "gib": sum(p.numel() * p.element_size() for p in unet.parameters())
                      / 2 ** 30})
        results = []
        for batch in BATCHES:
            x, sigma, emb = inputs(unet, batch, hwc, dev)
            with torch.no_grad():
                pipelined_denoise(unet.core, x, sigma, emb, axis, batch, plan=plan)
                sync()
                if not cpu:
                    torch.cuda.reset_peak_memory_stats(dev)
                seconds = []
                for _ in range(REPEATS):
                    dist.barrier()
                    t0 = time.perf_counter()
                    y = pipelined_denoise(unet.core, x, sigma, emb, axis, batch, plan=plan)
                    sync()
                    seconds.append(most(time.perf_counter() - t0))
            res = {"batch": batch, "microbatches": batch, "ranks": world,
                   "boundaries": plan.boundaries, "stage_params": plan.stage_param_sizes,
                   "payload_mb": plan.payload_len * 2 / 1e6, "held": held,
                   "pipelined_s_median": float(np.median(seconds)), "pipelined_s": seconds}
            if not cpu:
                res["peak_gib"] = every(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            results.append((res, y.cpu(), x, sigma, emb))
        del unet
        if not cpu:
            torch.cuda.empty_cache()
        if rank == 0:
            whole = build_unet(cfg).to(dev)
            for res, y, x, sigma, emb in results:
                with torch.no_grad():
                    plain = whole(x, sigma, emb)
                    h, e, c_skip, c_out = whole.core.precondition(x, sigma, emb)
                    trunk = torch.cat([whole.core.run_ops(a, b, [])[0]
                                       for a, b in zip(h.chunk(len(h)), e.chunk(len(e)))])
                    seq = c_skip * x.float() + c_out * trunk.float()
                    if not cpu:
                        torch.cuda.reset_peak_memory_stats(dev)
                    seconds = []
                    for _ in range(REPEATS):
                        sync()
                        t0 = time.perf_counter()
                        whole(x, sigma, emb)
                        sync()
                        seconds.append(time.perf_counter() - t0)
                scale = float(seq.abs().max())
                res.update(one_card_s_median=float(np.median(seconds)), one_card_s=seconds,
                           one_card_params=sum(p.numel() for p in whole.parameters()),
                           max_diff_vs_microbatched=float((y - seq.cpu()).abs().max()) / scale,
                           max_diff_vs_batch_forward=float((y - plain.cpu()).abs().max())
                           / scale)
                if not cpu:
                    res["one_card_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                print(json.dumps(res), flush=True)
                if not bool(torch.isfinite(y).all()) or res["max_diff_vs_microbatched"] > 2 ** -8:
                    raise AssertionError(f"batch {res['batch']}: the pipelined output is not "
                                         f"the whole model's: {res['max_diff_vs_microbatched']}")
            bad = [(r, h["stage_params"], plan.stage_param_sizes[r])
                   for r, h in enumerate(held) if h["stage_params"] != plan.stage_param_sizes[r]]
            if bad:
                raise AssertionError(f"ranks hold other than their stages: {bad}")
        dist.barrier()
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
