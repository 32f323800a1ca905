"""Sampling entry point of the port (JAX: sample.py at the repository root).

    python -m dualdiffusion_tpu_torch.sample --model_path <dir> \
        [--prompt label:1.0 ...] [--steps 100] [--seed N] [--load_ema NAME] \
        [--img2img AUDIO [--img2img_strength S] [--inpaint START:END]] \
        [--seamless_loop] [--decode_mode auto|fgla|ddec] [--output out.wav] \
        [--device cuda|cpu] [--tp N] [--interactive [--port 8080]]

Generates one batch of audio and writes it, normalized to -20 LUFS, to
``--output`` (``out_<i>.wav`` for each clip of a batch). ``--load_ema``
takes an EMA name or ``phema_<std>``; ``--img2img`` an input WAV (or FLAC,
with a ``flac``/``ffmpeg`` binary) at the model's sample rate;
``--inpaint`` regenerates that range of seconds of it and keeps the rest.
``--device`` defaults to ``cuda`` and never falls back: without a GPU,
sampling on the CPU takes ``--device cpu``. ``--interactive`` starts the
model-server process on ``--device`` and serves the web UI at
http://127.0.0.1 on ``--port`` (8080 by default) instead.

``--tp N`` samples with every module's weights sharded over N ranks
(``Pipeline.shard``), one per card (gloo ranks on the CPU with ``--device
cpu``); each rank computes the same clip and rank 0 writes it. Under a
launcher (``python -m torch.distributed.run --nproc_per_node N``) the
launched ranks are those; started bare, the command spawns N ranks itself,
and it raises when fewer than N cards are visible.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger("dualdiffusion_tpu_torch.sample")


def parse_prompt(items: Optional[Sequence[str]]) -> Dict[str, float]:
    """``label:weight`` entries (weight 1 without one) as a prompt dict."""
    prompt = {}
    for it in items or []:
        if ":" in it:
            name, _, w = it.rpartition(":")
            prompt[name] = float(w)
        else:
            prompt[it] = 1.0
    return prompt


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dualdiffusion_tpu_torch.sample")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--port", type=int, default=8080, help="the web UI's port (--interactive)")
    ap.add_argument("--prompt", nargs="*", default=None, help="label:weight entries")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cfg_scale", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--length", type=int, default=None)
    ap.add_argument("--num_fgla_iters", type=int, default=100)
    ap.add_argument("--fgla_phase_init", default="spsi", choices=["spsi", "flat"])
    ap.add_argument("--seamless_loop", action="store_true")
    ap.add_argument("--use_heun", action="store_true", default=True)
    ap.add_argument("--decode_mode", default="auto", choices=["auto", "fgla", "ddec"])
    ap.add_argument("--load_ema", default=None,
                    help="EMA name to load for the unet (e.g. std0.05, phema_0.05)")
    ap.add_argument("--img2img", default=None, metavar="AUDIO",
                    help="input audio file for img2img generation")
    ap.add_argument("--img2img_strength", type=float, default=0.5,
                    help="0 = return input, 1 = full generation")
    ap.add_argument("--inpaint", default=None, metavar="START:END",
                    help="regenerate only this time range (seconds) of the --img2img input")
    ap.add_argument("--output", default="output.wav")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel width: the ranks the weights are sharded over")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def inpainting_mask(pipeline, start_s: float, end_s: float, sample_rate: int,
                    length: Optional[int] = None) -> np.ndarray:
    """The latent-space time mask of ``--inpaint START:END`` (JAX sample.py:
    107-120): (1, 1, latent W, 1), 1 over the columns of [start_s, end_s)
    (regenerate), 0 elsewhere (keep)."""
    fmt = pipeline.format
    mel_shape = fmt.get_sample_shape(1, length)
    ds = (pipeline.modules["dae"].module.downsample_ratio
          if "dae" in pipeline.modules else 1)
    lat_w = mel_shape[2] // ds * ds // ds if ds > 1 else mel_shape[2]
    hop_s = getattr(fmt.config, "ms_hop_length", getattr(fmt.config, "hop_length", 256)) * ds
    mask = np.zeros((1, 1, lat_w, 1), np.float32)
    c0 = int(float(start_s) * sample_rate / hop_s)
    c1 = int(float(end_s) * sample_rate / hop_s)
    mask[:, :, max(c0, 0):min(c1, lat_w)] = 1.0
    return mask


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.interactive:
        from .serving.webui import run_app
        run_app(args.model_path, port=args.port, device=args.device)
        return
    if args.tp > 1 and not ("WORLD_SIZE" in os.environ or "DD_NUM_PROCESSES" in os.environ):
        spawn_tp_ranks(args)
    else:
        sample(args)


def spawn_tp_ranks(args: argparse.Namespace) -> None:
    """``--tp N`` started bare: N spawned ranks, over NCCL one per visible
    card, or over gloo with ``--device cpu``; a rank that fails fails the
    command."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    if torch.device(args.device).type == "cuda" and torch.cuda.device_count() < args.tp:
        raise RuntimeError(f"--tp {args.tp} needs {args.tp} cards; "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_tp_rank, args=(args, f"file://{tmp}/rendezvous"), nprocs=args.tp,
                           join=True, start_method="spawn")


def _tp_rank(rank: int, args: argparse.Namespace, rendezvous: str) -> None:
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank{rank} %(name)s %(levelname)s %(message)s")
    from .parallel import maybe_initialize_distributed
    maybe_initialize_distributed(rendezvous, args.tp, rank, [rank], device=args.device)
    sample(args)


def sample(args: argparse.Namespace) -> None:
    """One batch of audio to ``--output``; with ``--tp``, on this rank of
    the process group (started here when a launcher set it up)."""
    import torch
    import torch.distributed as dist

    from .parallel import is_main_process, local_device, maybe_initialize_distributed, shutdown

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to sample on the CPU")
    try:
        if args.tp > 1:
            maybe_initialize_distributed(device=args.device)
            if dist.get_world_size() != args.tp:
                raise ValueError(f"--tp {args.tp} under a launcher of "
                                 f"{dist.get_world_size()} processes")
        _sample(args, local_device(args.device), is_main_process())
    finally:
        shutdown()


def _sample(args: argparse.Namespace, device, write: bool) -> None:
    import torch
    import torch.distributed as dist

    from .pipelines.pipeline import Pipeline
    from .sampling import SampleParams
    from .utils import load_audio, save_audio

    load_emas = {"unet": args.load_ema} if args.load_ema else None
    pipeline = Pipeline.from_pretrained(args.model_path, device=device, load_emas=load_emas)
    seed = args.seed if args.seed is not None else int(np.random.randint(100000, 999999))
    if args.tp > 1:
        pipeline.shard(args.tp)
        seed_t = torch.tensor(seed, device=device)
        dist.broadcast(seed_t, 0)      # every rank samples rank 0's seed
        seed = int(seed_t)
    params = SampleParams(steps=args.steps, cfg_scale=args.cfg_scale, seed=seed,
                          batch_size=args.batch_size, length=args.length,
                          use_heun=args.use_heun, seamless_loop=args.seamless_loop,
                          num_fgla_iters=args.num_fgla_iters,
                          fgla_phase_init=args.fgla_phase_init,
                          img2img_strength=args.img2img_strength,
                          prompt=parse_prompt(args.prompt))
    emb = pipeline.get_prompt_embedding(params.prompt)
    sr = pipeline.format.config.sample_rate

    input_audio = mask = None
    if args.img2img:
        input_audio, in_sr = load_audio(args.img2img, return_sample_rate=True)
        if in_sr != sr:
            raise ValueError(f"input sample rate {in_sr} != model rate {sr}")
        if args.inpaint:
            start_s, _, end_s = args.inpaint.partition(":")
            mask = inpainting_mask(pipeline, float(start_s), float(end_s), sr, params.length)

    logger.info("sampling %d steps (seed %d, cfg %.2f, prompt %s) on %s", params.steps, seed,
                params.cfg_scale, params.prompt, device)
    out = pipeline.generate(params, torch.Generator(device=device).manual_seed(seed),
                            prompt_embedding=emb, decode_mode=args.decode_mode,
                            input_audio=input_audio, inpainting_mask=mask)
    if not write:
        return
    raw = out["raw"].float().cpu().numpy()
    for i in range(raw.shape[0]):
        path = args.output if raw.shape[0] == 1 else args.output.replace(".", f"_{i}.", 1)
        save_audio(raw[i], sr, path, target_lufs=-20.0)
        logger.info("wrote %s (%.1fs audio)", path, raw.shape[-1] / sr)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
