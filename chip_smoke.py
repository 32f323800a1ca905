#!/usr/bin/env python3
"""Smoke test of dualdiffusion_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, with no arguments, on one CUDA card:

1. prints the card's name and power limit;
2. builds the port's CUDA kernels from ``dualdiffusion_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version at the main paths'
   shapes and times both, beside the card's least time for the same work
   (the bound) and, where one PyTorch call computes the same function, that
   call's time: the reference-scale UNet's grouped convs forward at batch 2
   (K1), their backward at the training batch 8 (K1 on rotated weights for
   dgrad, K4 for wgrad), one 45 s stereo Griffin-Lim iteration (K3, and K2
   on both its routes, the Hopper kernel and the Stockham one, against the
   plain version in float64 at three seeds, beside cuFFT's transforms
   alone) and a 5-iteration Griffin-Lim run, K3 on both its routes (the
   Hopper kernel and the gather one, in turns) at n_fft 6400 and 4096, fp32
   and bf16, F 5504 and the smallest F whose reflect zones nearly meet,
   the fused 2-D multi-scale spectral loss
   of the DAE training microbatch, forward (K5) and gradient (K6), with the
   shapes the FFT kernels do not take (bw 16 and 128, a window that is not
   separable, stride > bw) checked and timed on the direct-DFT kernels, and the
   flash attention (K7) at the full-attention model's level-1 shapes (B 2,
   L 5504, D 64, 4/8/12 heads, plus a band, a causal and a ragged case, and
   head widths 8, 24 and 192), with K7 against the einsum route from L 86
   to 5504 (the crossover);
4. holds a tiny model's generate slice, the same on the MS-MDCT dual
   format (its FGLA decode: K2/K3 at n_fft 4096, hop 256), the DDEC decode
   of a tiny model with a "ddec" module (``decode_mode="auto"``: K1 in the
   latent UNet, the DDEC's dense convs on cuDNN, no K2/K3/K7), its UNet
   train steps, a tiny DAE's train steps, the DDEC, joint DAE + DDEC and
   label-conditioned DAE train steps on a tiny supersampled DAE (no kernel
   launched) and a tiny full-attention model's generate slice (level-1 L
   2048, through K7) on the card against the same models on the CPU;
5. drives the serving path: builds the reference-scale pipeline (356M-param
   UNet, 64-ch DAE, 256-bin mel format) from a seed, saves it, loads it with
   ``Pipeline.from_pretrained`` and calls ``generate`` twice (45 s, batch 1,
   CFG 1.5, Heun, SPSI + 100 Griffin-Lim iterations), checking the audio and
   that K1, K2 and K3 were launched (every K3 call on its Hopper route) and
   K7 was not (its "freq" attention
   sees L <= 32); then the same at 50 steps for ``ref_scale_full_attn`` (the
   same model with "full" attention at levels 1, 3 and 4), where K7 must be
   launched at level 1 (L 5504); then DDEC serving: the same UNet and DAE on the
   edm2_default MS-MDCT dual format with the DDEC of
   configs/models/edm2_ddec_mclt_b1a, ``generate(decode_mode="auto")``
   twice at 50 steps (the DDEC samples (1, 256, 5504, 2) MDCT coefficients
   with the same 50 Heun steps, conditioned on the mel's 2048-row linear PSD; no
   CFG), printing each stage's seconds and peak memory and checking the
   audio and that K1 was launched and K2, K3 and K7 were not; then one
   full-width DDEC forward (ms, analytic GFLOP, TFLOP/s, bf16 bound);
6. drives the options of ``generate`` that ``sample.py`` and the model
   server use, on a fourth copy of the reference-scale pipeline: img2img
   from the first serving clip at strength 0.5 (K1 for 25 of 50 steps)
   and 0, inpainting 10-20 s on ``convert_unet_to_inpainting``'s UNet (all
   50 steps, and one full-width forward with a zero reference against the
   original), the seamless loop under Griffin-Lim and under the DDEC
   (shifts that change from step to step, the crossfaded length), a
   chunked preview aborted after 3 chunks of 10 steps, and
   ``python -m dualdiffusion_tpu_torch.sample`` with every option on a
   post-hoc EMA (three bf16 archives) and dataset prompt embeddings, whose
   WAV must read -20 LUFS; K1 is also held against its plain version at the
   seamless width W 752, and the tiny slices take img2img, inpainting and
   the seamless loop on the card against the CPU;
7. drives the web UI's user flow on the DDEC serving model:
   ``python -m dualdiffusion_tpu_torch.create_new_model`` writes it from a
   seed on the card; ``serving.launch(device="cuda")`` spawns the model
   server, which loads it and warms up (``compile_model``); the UI's handlers
   behind a local HTTP server take a plain request (45 s, 50 Heun steps, CFG
   1.5, the DDEC decode; its preview, WAV and spectrogram), an editor inpaint
   of 10-20 s, an editor append, a request aborted after its first preview,
   and a rating and a save, each timed against the same clip in-process;
   ``python -m dualdiffusion_tpu_torch.sample --interactive`` then answers on
   its own port; one request through an in-process ``ModelServer`` under
   ``decode_mode="fgla"`` must launch K1 exactly 68 x 2 x 100 times, K2 and
   K3 (on their Hopper routes), and no K7;
8. drives the UNet training path: writes a synthetic latent dataset and runs
   ``python -m dualdiffusion_tpu_torch.train``'s entry in-process on that
   model directory for 4 steps, then ``--resume`` for 1 more (device batch
   8, gradient accumulation 2, AdamW, one EMA), checking the losses, that
   params and EMA moved, that the checkpoint round-trips and that K1 and K4
   were launched;
9. drives the DAE training path the same way: the edm2_default DAE
   (configs/models/edm2_default) on the MS-MDCT dual format, its trainer
   config with the fused MSS2D loss, 32 synthetic stereo WAVs, 5.5 s crops,
   device batch 8 x accumulation 2, 4 steps then 1 after ``--resume``,
   checking that K5 and K6 were launched and no call went to the plain
   version; then the rest of training at the same cut: the m1 DAE on its
   MDCT (the fused loss's K5/K6 on MDCT images and no other kernel, the
   prime-width 1-D MSS, NorMuon, a host-memory EMA profile held against a
   device one of the same std, a profiler trace of step 1, the host-EMA
   hand-over's ms and the step with and without it), the p1 DAE (the
   randomized-prime MSS, the equivariance loss, Muon; no kernel; a Muon
   update against AdamW's), and the default VAE and discriminator saved,
   loaded and run on a 45 s mel (no kernel; 1 s of it against the CPU);
10. drives DDEC training: ``python -m dualdiffusion_tpu_torch.create_new_model``
   writes configs/models/edm2_ddec_mclt_b1a from a seed on the card (the
   d3-series supersampled, label-conditioned DAE and the 14.49M-parameter
   DDEC), 32 synthetic stereo WAVs get embedding files, and the training
   entry runs b1a's ddec_train.json (device batch 8 x accumulation 2, 5.5 s
   crops, both EMAs with archives) for 4 steps then 1 after ``--resume``,
   checking that the teacher DAE is bit for bit unchanged and that no kernel
   of K1-K7 launched; one DDEC training microbatch at the full 45 s length;
   then the joint DAE + DDEC trainer the same way on a fresh copy of that
   directory (its ``dae`` section from edm2_dae_d3a's dae_train.json),
   checking that both modules and the DAE's stats moved and that the
   checkpoint's modules load with ``from_pretrained``;
11. drives the dataset factory: ``create_new_model`` writes edm2_default;
   ``python -m dualdiffusion_tpu_torch.dataset_process`` normalizes four
   seeded songs (two of 45 s, two of 180 s, two of one file name in two
   folders), encodes them with its DAE in a spawned worker on the card (8
   variations; the 180 s songs in 4 chunks), checks them, and after seeded
   CLAP-like embeddings are added builds the splits and the prompt table;
   the UNet trains 4 + 1 steps on those latents with edm2_default's
   unet_train.json and generates a clip from the table; every latents
   file's shape, the sidecars, train.jsonl, the chunk count, tiled against
   untiled and no kernel launch in the worker are held, and a tiny encode
   through the CLI on the card against the CPU;
12. holds K7 against its plain version at the stereo-folded 3-D UNet's
   level 1 (B 2, 8 heads, L 11,008, D 64), then drives that UNet at full
   width: the reference scale with the d1 options (``use_3d``, stereo-wrapped
   io convs without bias, W reflect padding, a skip conv in every block, the
   constant and ln-freq channels, a double midblock with attention, "full"
   attention at levels 1, 3 and 4) through ``edm_sample`` for 50 Heun
   steps at CFG 1.5 on a (1, 2, 32, 688, 4) sample (K7 exactly 7 times a
   forward, K1 never: its convs are 5-D, on cuDNN), then its train step on
   5-D latents ("freq" attention at levels 3-4, dropout 0.1, device batch 8
   x accumulation 2) for 5 steps;
13. takes every registered format at its default config through its round
   trip on a seeded 45 s song (the spectrogram's Griffin-Lim through K2/K3),
   1 s of it on the card against the CPU, and loads a model_index.json
   naming ``format:ms_mdct_dual_v1``;
14. runs the component harnesses as subprocesses on the card
   (``python -m dualdiffusion_tpu_torch.scripts.<name>``: ``unet_test`` on
   edm2_default with configs/tests/unet_test.json, ``format_test`` with
   configs/tests/format_test.json, ``dae_test`` on edm2_default and on the
   spectrogram-format edm2_dae_d3a, ``sigma_sampler_test``), checking the
   files each writes, and the dataset factory's encode with edm2_dae_d3a on
   two seeded 45 s songs;
15. the parallel phase, in processes started by ``python -m
   torch.distributed.run``: (a) the UNet training path's run under a process
   group of one over NCCL, with ``parallel.fsdp`` (over one rank the
   weights stay whole) and then plain data parallelism (4 steps, then 1
   after ``--resume`` under FSDP), its first step against the plain
   trainer's, its K1 and K4 launches those of the UNet training path's
   steps, the FSDP checkpoint loaded by a single-device pipeline; (b) two
   data-parallel ranks on the one card over gloo, each with half of a global
   batch of 16, whose averaged gradient must equal one process's over the
   same batch; (c) K1 at the tensor-parallel shard's shapes (4 of the 8
   groups, half the channels) against its plain version; (d) img2img at
   strength 0.5 from 5 s of seeded audio (25 steps) on the reference-scale
   pipeline with the DAE moved to the CPU by ``Pipeline.to``: the encode and
   the decode on the CPU, the sampler on the card.

``python3 chip_smoke.py --profile`` instead builds the kernels and profiles
one full-width DAE train step (step 9's model, data and config). The
arguments ``--parallel-train`` and ``--parallel-gloo`` run one rank of
step 15 (a) and (b); step 15 starts them.

Any failure raises, so the exit code is not 0. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
The script imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SAMPLER_STEPS = 100
SEEDS = (1, 2)
#: steps of the generation options' and the 3-D UNet's samplers: half the
#: serving path's, to keep the whole script within its time limit
OPTIONS_STEPS = 50
#: steps of the full-attention and DDEC serving paths and of the web UI's
#: requests: half the reference-scale serving path's, for the same reason
CUT_SERVING_STEPS = 50
TRAIN_BATCH = 8          # device batch of the training path
TRAIN_ACCUM = 2          # gradient accumulation steps
TRAIN_STEPS = 4          # then one more after --resume
TRAIN_SAMPLES = 32       # synthetic latents / WAVs in the datasets
DAE_RAW_CROP = 176128    # 5.5 s: a (8, 256, 680, 2) mel after crop and alignment
JOINT_BATCH = 8          # device batch of the joint DAE + DDEC path (predicted under 70 GiB)
#: the card's published peaks (H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

#: (name, route, source, TPU kernel it replaces)
KERNEL_INFO = [
    ("grouped_conv3x3", "cuda", "dualdiffusion_tpu_torch/csrc/grouped_conv3x3_hopper.cu",
     "dualdiffusion_tpu/ops/pallas/grouped_conv.py:120"),
    ("grouped_conv3x3_wgrad", "cuda",
     "dualdiffusion_tpu_torch/csrc/grouped_conv3x3_wgrad_hopper.cu",
     "dualdiffusion_tpu/ops/pallas/grouped_conv.py:342"),
    ("fgla_frame", "cuda", "dualdiffusion_tpu_torch/csrc/fgla_frame_hopper.cu",
     "dualdiffusion_tpu/ops/pallas/fgla_iter.py:75"),
    ("ola_reframe", "cuda", "dualdiffusion_tpu_torch/csrc/ola_reframe_hopper.cu",
     "dualdiffusion_tpu/ops/pallas/ola_reframe.py:68"),
    ("mss2d_block_loss", "cuda", "dualdiffusion_tpu_torch/csrc/mss2d.cu",
     "dualdiffusion_tpu/ops/pallas/mss2d.py:66"),
    ("mss2d_block_loss_grad", "cuda", "dualdiffusion_tpu_torch/csrc/mss2d.cu",
     "dualdiffusion_tpu/ops/pallas/mss2d.py:222"),
    ("flash_attention", "cuda", "dualdiffusion_tpu_torch/csrc/flash_attention.cu",
     "dualdiffusion_tpu/ops/pallas/flash_attention.py:43"),
]
#: K7 at the full-attention model's level 1: batch 2 (CFG), L = 16 x 344
#: positions of 45 s latents, D = 64; (heads, attention blocks per UNet
#: forward): enc_b1_down 4 heads, enc_b1_l0/l1 and dec_b1_l0..l2 8, dec_b1_up 12
FLASH_B, FLASH_L, FLASH_D = 2, 5504, 64
FLASH_HEADS = ((4, 1), (8, 5), (12, 1))


def ref_scale_configs():
    """The reference's default model scale (bench.py ref_scale)."""
    from dualdiffusion_tpu_torch.models import DAEConfig, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import SpectrogramFormatConfig
    dae = DAEConfig(model_channels=64, channel_mult_enc=(1, 2, 4, 8),
                    channel_mult_dec=(1, 2, 4, 8), num_enc_layers_per_block=2,
                    num_dec_layers_per_block=2, latent_channels=4)
    unet = UNetConfig(in_channels=4, out_channels=4, in_channels_emb=1024,
                      model_channels=256, channel_mult=(1, 2, 3, 4, 5),
                      channel_mult_noise=1, channel_mult_emb=3, channels_per_head=64,
                      num_layers_per_block=2, attn_levels=(3, 4), attn_axis="freq",
                      mlp_multiplier=2, mlp_groups=8, logvar_channels=128)
    fmt = SpectrogramFormatConfig(num_fgla_iters=100, fgla_work_dtype="bfloat16",
                                  fgla_phase_init="spsi")
    return unet, dae, fmt


def full_attention_config():
    """The UNet of ``ref_scale_full_attn``: the reference scale with "full"
    attention at its own levels (3, 4) plus level 1, whose 16 x 344
    positions of a 45 s clip take K7; levels 3 and 4 (L 344 and 86) stay on
    the einsum route. Its DAE and format are the reference scale's."""
    import dataclasses
    return dataclasses.replace(ref_scale_configs()[0], attn_axis="full", attn_levels=(1, 3, 4))


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call over ``reps`` calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, kind: str):
    """(least ms the card could take, "operations" or "bytes"): the larger of
    the operations over the peak rate of their type and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def result(err, ms, plain_ms, flops, nbytes, kind, library_ms=None) -> dict:
    bound_ms, by = bound(flops, nbytes, kind)
    print(f"  bound {bound_ms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP {kind}, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def expect(what: str, ok: bool, text: str) -> None:
    """Print ``text`` with ok or FAIL; raise on FAIL."""
    print(f"  {what}: {text} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{what}: {text}")


def check_close(name: str, got, want, rel_tol: float) -> float:
    """max |got - want| must be <= rel_tol * max |want|; returns the error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= rel_tol * scale
    print(f"  {name}: max_abs_err {err:.6g} (max |ref| {scale:.6g}, tol {rel_tol:g} x max) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def ptxas_usage(log: str, pattern: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each entry
    function whose mangled name contains ``pattern``, from ``nvcc -Xptxas -v``."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            spills = (0, 0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((kernel_label(name), int(m.group(1)), *spills))
            name = None
    return out


def kernel_label(mangled: str) -> str:
    """'mss2d_kernel<64, 1>' from a mangled kernel name: the identifier
    ending in 'kernel' whose length the digits before it spell, and the
    template's integer arguments."""
    import re
    end = mangled.find("kernel") + len("kernel")
    for start in range(end - len("kernel"), 0, -1):
        digits = re.search(r"\d+$", mangled[:start])
        if digits and digits.group().endswith(str(end - start)):
            args = re.findall(r"L[ib](\d+)E", mangled[end:].split("EE")[0] + "E")
            return mangled[start:end] + (f"<{', '.join(args)}>" if args else "")
    return mangled


def grouped_conv_shapes(unet, batch: int, lat_h: int, lat_w: int):
    """(B, H, W, cin, cout) of every grouped conv of one UNet forward."""
    shapes = []
    for name, kind, level, _, _ in unet.core.schedule:
        if kind in ("enc_in", "conv_out"):
            continue
        block = getattr(unet.core, name)
        h, w = lat_h >> level, lat_w >> level
        for conv in (block.conv_res0, block.conv_res1):
            shapes.append((batch, h, w, conv.in_channels, conv.out_channels))
    return shapes


def conv_level(lat_h: int, h: int) -> int:
    """The UNet level of a conv at height h (the latents' height >> level)."""
    return (lat_h // h).bit_length() - 1


def conv_route(cig: int, cog: int, *tensors) -> str:
    """Which K1/K4 kernel a shape takes: "hopper" (wgmma + TMA) or "wmma"."""
    from dualdiffusion_tpu_torch.ops.kernels import hopper_takes
    return "hopper" if hopper_takes(cig, cog, *(t.data_ptr() for t in tensors)) else "wmma"


def forced_route(route: str):
    """A context in which K1 and K4 take `route`'s kernels: "wmma" (the
    design before the Hopper one, for comparisons) or "hopper" (as chosen)."""
    import contextlib
    from unittest import mock
    import dualdiffusion_tpu_torch.ops.kernels.grouped_conv as gc
    if route == "wmma":
        return mock.patch.object(gc, "hopper_takes", lambda *a: False)
    return contextlib.nullcontext()


def k1_host_us(x, wt, groups: int, rounds: int = 6) -> dict:
    """Host microseconds per K1 call at a tiny shape: rounds of 1,000 calls
    without synchronising (the wrapper, the tensor maps and the launch), on
    the WMMA route and the Hopper route in turns, so the host's load falls
    on both alike: {route: [us, ...]}."""
    import torch
    import dualdiffusion_tpu_torch.ops.kernels.grouped_conv as gc
    out = {"wmma": [], "hopper": []}
    for i in range(rounds):
        for key in (("wmma", "hopper") if i % 2 == 0 else ("hopper", "wmma")):
            with forced_route(key):
                for _ in range(20):
                    gc.grouped_conv3x3(x, wt, groups)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    gc.grouped_conv3x3(x, wt, groups)
                out[key].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
    return out


def print_levels(what: str, levels: dict) -> None:
    """One line per UNet level: the summed ms of each column."""
    for level, cols in sorted(levels.items()):
        print(f"  {what} level {level}: " + ", ".join(f"{k} {v:.3f}" for k, v in cols.items())
              + " ms", flush=True)


def kernel_phase_conv(unet, groups: int, lat_h: int, lat_w: int, gen):
    import torch
    import torch.nn.functional as F
    from dualdiffusion_tpu_torch.ops.kernels import (grouped_conv3x3, grouped_conv3x3_plain,
                                                     prepare_weights)
    shapes = grouped_conv_shapes(unet, 2, lat_h, lat_w)
    counts = {s: shapes.count(s) for s in dict.fromkeys(shapes)}
    print(f"K1 grouped_conv3x3: {len(counts)} distinct shapes, {len(shapes)} convs per "
          f"UNet forward (batch 2, groups {groups}); bf16 in/out, fp32 accumulation",
          flush=True)
    worst, ms, plain_ms, cudnn_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    levels = {}
    for (b, h, w, cin, cout), n in counts.items():
        x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
        wgt = torch.randn((cout, cin // groups, 3, 3), generator=gen, device="cuda")
        wt = prepare_weights(wgt / (9 * cin // groups) ** 0.5, groups)
        got = grouped_conv3x3(x, wt, groups)
        torch.cuda.synchronize()
        want = grouped_conv3x3_plain(x, wt, groups)
        route = conv_route(cin // groups, cout // groups, x, wt, got)
        # bf16 output: one rounding of an fp32 sum taken in another order
        err = check_close(f"({b},{h},{w},{cin}->{cout}) x{n} [{route}]", got, want, 2 ** -7)
        worst = max(worst, err)
        xc = x.permute(0, 3, 1, 2)
        wc = (wgt / (9 * cin // groups) ** 0.5).bfloat16()
        t = (n * time_ms(lambda: grouped_conv3x3(x, wt, groups)),
             n * time_ms(lambda: F.conv2d(xc, wc, padding=1, groups=groups)))
        ms += t[0]
        cudnn_ms += t[1]
        lv = levels.setdefault(conv_level(lat_h, h), {"K1": 0.0, "cuDNN fprop": 0.0})
        lv["K1"] += t[0]
        lv["cuDNN fprop"] += t[1]
        plain_ms += n * time_ms(lambda: grouped_conv3x3_plain(x, wt, groups))
        flops += n * 2 * 9 * cin * cout // groups * b * h * w
        nbytes += n * 2 * (b * h * w * (cin + cout) + 9 * cin // groups * cout)
    print_levels("per UNet forward,", levels)
    print(f"  per UNet forward: kernel {ms:.3f} ms, plain fp32 {plain_ms:.3f} ms, "
          f"cuDNN bf16 {cudnn_ms:.3f} ms", flush=True)
    # inputs from a generator of their own, so the later phases' draws stay as they were
    own = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, 2, 16, 64), generator=own, device="cuda").bfloat16()
    wt = prepare_weights(torch.randn((64, 8, 3, 3), generator=own, device="cuda"), 8)
    us = k1_host_us(x, wt, 8)
    print("  K1 host us per call (rounds of 1,000 calls of (1, 2, 16, 64) -> 64, 8 groups, no "
          "sync, routes in turns): " + "; ".join(
              f"{k} route min {min(v):.2f} median {sorted(v)[len(v) // 2]:.2f} "
              f"({', '.join(f'{u:.1f}' for u in v)})" for k, v in us.items()), flush=True)
    return result(worst, ms, plain_ms, flops, nbytes, "bf16", cudnn_ms)


def kernel_phase_conv_backward(unet, groups: int, lat_h: int, lat_w: int, gen):
    """K1 dgrad (K1 on ``dgrad_weights``) and K4 wgrad against their plain
    versions at every distinct grouped-conv shape of one training microbatch,
    with cuDNN's dgrad (``conv2d_input``) and wgrad (``conv2d_weight``) in
    bf16 beside them. Both return bf16: one rounding of an fp32 sum taken in
    another order, so they agree to one bf16 ulp of the max (2**-7)."""
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import (dgrad_weights, grouped_conv3x3,
                                                     grouped_conv3x3_plain, grouped_conv3x3_wgrad,
                                                     grouped_conv3x3_wgrad_plain, prepare_weights)
    shapes = grouped_conv_shapes(unet, TRAIN_BATCH, lat_h, lat_w)
    counts = {s: shapes.count(s) for s in dict.fromkeys(shapes)}
    print(f"K1 dgrad / K4 grouped_conv3x3_wgrad: {len(counts)} distinct shapes, {len(shapes)} "
          f"convs per UNet backward (batch {TRAIN_BATCH}, groups {groups}); bf16 in/out, fp32 "
          f"accumulation", flush=True)
    res = {"dgrad": [0.0, 0.0, 0.0], "wgrad": [0.0, 0.0, 0.0]}
    cudnn = {"dgrad": 0.0, "wgrad": 0.0}
    flops, nbytes = 0.0, 0.0
    levels = {}
    for (b, h, w, cin, cout), n in counts.items():
        cig, cog = cin // groups, cout // groups
        x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
        gy = torch.randn((b, h, w, cout), generator=gen, device="cuda").bfloat16()
        wgt = torch.randn((cout, cig, 3, 3), generator=gen, device="cuda")
        wd = dgrad_weights(prepare_weights(wgt / (9 * cig) ** 0.5, groups))
        xc, gyc, wc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2), wgt.bfloat16()
        lv = levels.setdefault(conv_level(lat_h, h), {"dgrad": 0.0, "cuDNN dgrad": 0.0,
                                                      "K4 wgrad": 0.0, "cuDNN wgrad": 0.0})
        for key, fn, plain, lib, route in (
                ("dgrad", lambda: grouped_conv3x3(gy, wd, groups),
                 lambda: grouped_conv3x3_plain(gy, wd, groups),
                 lambda: torch.nn.grad.conv2d_input(xc.shape, wc, gyc, padding=1, groups=groups),
                 conv_route(cog, cig, gy, wd, x)),
                ("wgrad", lambda: grouped_conv3x3_wgrad(x, gy, groups),
                 lambda: grouped_conv3x3_wgrad_plain(x, gy, groups),
                 lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, gyc, padding=1, groups=groups),
                 conv_route(cig, cog, x, gy))):
            got = fn()
            torch.cuda.synchronize()
            r = res[key]
            tag = f"{key} ({b},{h},{w},{cin}->{cout}) x{n} [{route}]"
            r[0] = max(r[0], check_close(tag, got, plain(), 2 ** -7))
            t = (n * time_ms(fn), n * time_ms(lib))
            r[1] += t[0]
            cudnn[key] += t[1]
            lv["dgrad" if key == "dgrad" else "K4 wgrad"] += t[0]
            lv[f"cuDNN {key}"] += t[1]
            r[2] += n * time_ms(plain, 3)
        flops += n * 2 * 9 * cin * cout // groups * b * h * w
        nbytes += n * 2 * (b * h * w * (cin + cout) + 9 * cin // groups * cout)
    print_levels("per UNet backward,", levels)
    for key, (_, ms, plain_ms) in res.items():
        print(f"  {key} per UNet backward: kernel {ms:.3f} ms, plain fp32 {plain_ms:.3f} ms, "
              f"cuDNN bf16 {cudnn[key]:.3f} ms", flush=True)
    print("  dgrad and wgrad each do the work below", flush=True)
    err, ms, plain_ms = res["wgrad"]
    return result(err, ms, plain_ms, flops, nbytes, "bf16", cudnn["wgrad"])


def fgla_inputs(fmt, gen):
    """Production-shaped Griffin-Lim magnitudes: a 45 s stereo test signal
    through the format's mel scale and its pseudoinverse."""
    import math
    import torch
    cfg = fmt.config
    n = cfg.default_raw_length
    t = torch.arange(n, device="cuda", dtype=torch.float64) / cfg.sample_rate
    sig = sum(0.2 * torch.sin(2 * math.pi * f * t * (1 + 0.001 * torch.sin(2 * math.pi * t)))
              for f in (110.0, 220.0, 330.0, 440.0, 880.0, 1760.0))
    sig = sig + 0.1 * torch.sin(2 * math.pi * (200 + 40 * t) * t)
    sig = sig.float() + 0.02 * torch.randn(n, generator=gen, device="cuda")
    audio = torch.stack([sig, 0.8 * sig])[None]
    mel = fmt.raw_to_sample(audio) / cfg.raw_to_sample_scale + cfg.sample_mean
    mel = mel.permute(0, 3, 1, 2).clamp_min(0.0)
    mag = fmt.freq_scale.unscale(mel ** (1.0 / cfg.abs_exponent)).transpose(-1, -2)
    return mag.contiguous()


def fgla_route(n: int) -> str:
    """The K2 kernel ``fgla_frame`` takes at n_fft ``n``: "hopper" or "stockham"."""
    from dualdiffusion_tpu_torch.ops.kernels import fgla_plan
    return fgla_plan(n).route


def forced_fgla_route(route: str):
    """A context in which K2 takes `route`: "stockham" (the PR 1 kernel, at
    every size, for comparisons) or "hopper" (as ``fgla_plan`` chooses)."""
    import contextlib
    from dualdiffusion_tpu_torch.ops.kernels import stockham_everywhere
    return stockham_everywhere() if route == "stockham" else contextlib.nullcontext()


def ola_route(n: int, hop: int) -> str:
    """The K3 kernel ``ola_reframe`` takes at n_fft ``n``: "hopper" or "gather"."""
    from dualdiffusion_tpu_torch.ops.kernels import ola_plan
    return ola_plan(n, hop).route


def forced_ola_route(route: str):
    """A context in which K3 takes `route`: "gather" (csrc/ola_reframe.cu, at
    every shape, for comparisons) or "hopper" (as ``ola_plan`` chooses)."""
    import contextlib
    from dualdiffusion_tpu_torch.ops.kernels import gather_everywhere
    return gather_everywhere() if route == "gather" else contextlib.nullcontext()


def kernel_phase_ola(fmt, gen) -> dict:
    """K3 on both routes, the Hopper kernel (``ola_plan``'s choice at hop 256)
    and the gather kernel (csrc/ola_reframe.cu), in turns, at the serving paths' n_fft:
    6400 (the spectrogram format's window and envelope) and 4096 (the
    MS-MDCT dual format's periodic Hann), hop 256, B*C 2, fp32 and bf16.
    Each route against the plain version at F 5504 and at the smallest F
    whose reflect zones nearly meet (14 at 6400, 10 at 4096): fp32 to 1e-5
    of max (sums in another order), bf16 to 2**-6 (one rounding of the
    stored result). At F 5504: CUDA-event ms of each route (two rounds,
    in turns) and of the plain version, GB/s and the share of the bound,
    and the Hopper kernel's registers and spills."""
    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import ola_reframe, ola_reframe_plain
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    from dualdiffusion_tpu_torch.ops.stft import envelope, pad_center
    from dualdiffusion_tpu_torch.ops.windows import get_window
    for name, regs, st, ld in ptxas_usage(library().log, "ola_reframe"):
        print(f"  ptxas {name}: {regs} registers, spills {st} B stored / {ld} B loaded",
              flush=True)
    hop, rows, f_serv = 256, 2, 5504
    windows = {fmt.config.padded_length: pad_center(np.asarray(fmt.window),
                                                    fmt.config.padded_length),
               4096: get_window("hann", 4096, periodic=True)}
    print(f"K3 ola_reframe, both routes: B*C {rows}, hop {hop}, n_fft {tuple(windows)}, "
          f"F {f_serv} and the smallest F; routes: "
          + ", ".join(f"{n} {ola_route(n, hop)}" for n in windows), flush=True)
    out = None
    for n, window in windows.items():
        if ola_route(n, hop) != "hopper":
            raise AssertionError(f"K3 does not take its Hopper route at n_fft {n}")
        win = torch.as_tensor(window, dtype=torch.float32, device="cuda")
        for f in (f_serv, 14 if n == 6400 else 10):
            inv_env = torch.as_tensor((1.0 / envelope(window, n, hop, f)).astype(np.float32),
                                      device="cuda")
            for wd, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
                y = torch.randn((rows, f, n), generator=gen, device="cuda").mul(0.05).to(wd)
                want = ola_reframe_plain(y, win, inv_env, hop)
                errs = {}
                for rt in ("hopper", "gather", "gather", "hopper"):
                    before = ola_reframe.routes[rt]
                    with forced_ola_route(rt):
                        got = ola_reframe(y, win, inv_env, hop)
                    torch.cuda.synchronize()
                    if ola_reframe.routes[rt] != before + 1:
                        raise AssertionError(f"K3 did not take its {rt} route")
                    errs[rt] = check_close(f"K3 [{rt}] n_fft {n} F {f} {wd}", got, want, tol)
                if f != f_serv:
                    continue
                times = {}
                for rt in ("hopper", "gather", "gather", "hopper"):
                    with forced_ola_route(rt):
                        times.setdefault(rt, []).append(time_ms(
                            lambda: ola_reframe(y, win, inv_env, hop), 20))
                plain = time_ms(lambda: ola_reframe_plain(y, win, inv_env, hop), 3)
                sig_len = (f - 1) * hop + n
                # per signal sample n/hop multiply-adds of the overlap-add and
                # one window product per output sample; frames in and out,
                # window and envelope in
                flops = rows * (sig_len * 2 * n / hop + f * n)
                nbytes = rows * f * n * 2 * y.element_size() + 4 * (n + sig_len)
                bound_ms, by = bound(flops, nbytes, "fp32")
                print(f"  K3 n_fft {n} F {f} {wd}: " + "; ".join(
                    f"{rt} {min(v):.4f} ms (rounds {', '.join(f'{t:.4f}' for t in v)}), "
                    f"{nbytes / min(v) / 1e6:.1f} GB/s, {bound_ms / min(v):.1%} of the bound"
                    for rt, v in times.items())
                    + f"; plain {plain:.3f} ms; bound {bound_ms:.4f} ms ({by}, "
                    f"{nbytes / 1e6:.1f} MB)", flush=True)
                serving = getattr(torch, fmt.config.fgla_work_dtype)
                if n == fmt.config.padded_length and wd == serving:
                    out = result(errs["hopper"], min(times["hopper"]), plain, flops, nbytes, "fp32")
    return {"ola_reframe": out}


def check_fgla_frame(name: str, got, want64, want32, wd) -> float:
    """K2's (r, y) against the plain version in float64 (want64); want32 is
    the plain version in fp32, whose own error against float64 sets the
    frames' bound. r: 1e-5 of max (fp32: rounding in another order), 2**-6
    (bf16: one rounding of the stored result). y in fp32: relative L2 <=
    1e-5 and max error <= 2 x the plain fp32 version's + 1e-6 of max (a
    fixed bound on the max error passed or failed with the draw, PR 7 run
    D); y in bf16: 2**-6 of max. Returns the largest absolute error."""
    import torch
    fp32 = wd == torch.float32
    r, r64 = got[0].double(), want64[0].double()
    err_r, scale_r = (r - r64).abs().max().item(), r64.abs().max().item()
    ok = err_r <= (1e-5 if fp32 else 2 ** -6) * scale_r
    y, y64 = got[1].double(), want64[1].double()
    err, scale = (y - y64).abs().max().item(), y64.abs().max().item()
    line = (f"  {name}: spectrum max_abs_err {err_r:.4g} (max |ref| {scale_r:.4g}, tol "
            f"{'1e-5' if fp32 else '2**-6'} x max); frames max_abs_err {err:.4g} "
            f"(max |ref| {scale:.4g}")
    if fp32:
        plain_err = (want32[1].double() - y64).abs().max().item()
        rel = ((y - y64).norm() / y64.norm()).item()
        ok = ok and rel <= 1e-5 and err <= 2 * plain_err + 1e-6 * scale
        line += f", tol 2 x plain fp32's {plain_err:.4g} + 1e-6 x max), rel L2 {rel:.3g} (tol 1e-5)"
    else:
        ok = ok and err <= 2 ** -6 * scale
        line += ", tol 2**-6 x max)"
    print(line + (" ok" if ok else " FAIL"), flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its float64 plain version")
    return max(err_r, err)


def kernel_phase_fgla(fmt, gen):
    import math

    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.ops import griffinlim, griffinlim_reference
    from dualdiffusion_tpu_torch.ops.kernels import (dft_twiddles, fgla_frame,
                                                     fgla_frame_plain, ola_reframe,
                                                     ola_reframe_plain)
    from dualdiffusion_tpu_torch.ops.stft import envelope, pad_center, stft
    cfg = fmt.config
    n, hop = cfg.padded_length, cfg.hop_length
    mag = fgla_inputs(fmt, gen)
    b, c, f, bins = mag.shape
    win = torch.as_tensor(pad_center(np.asarray(fmt.window), n), dtype=torch.float32,
                          device="cuda")
    inv_env = torch.as_tensor((1.0 / envelope(fmt.window, n, hop, f)).astype(np.float32),
                              device="cuda")
    tw = dft_twiddles(n, "cuda")
    results = {}
    route = fgla_route(n)
    print(f"K2 fgla_frame / K3 ola_reframe: B={b} C={c} F={f} n_fft={n} hop={hop}; "
          f"fgla_frame() takes the {route} route; both routes checked against the plain "
          f"version in float64 at seeds 0-2", flush=True)
    for wd, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        # K3 tolerances: fp32 -> rounding in another order; bf16 -> one
        # rounding of the stored result (bf16 keeps 8 bits)
        spec = mag.to(wd).contiguous()
        merged = mag.mean(1, keepdim=True).expand_as(mag).to(wd).contiguous()
        y = torch.randn((b, c, f, n), generator=gen, device="cuda").mul(0.05).to(wd)
        r_prev = torch.randn((b, c, f, bins, 2), generator=gen, device="cuda").to(wd)
        check_close(f"K3 {wd} [{ola_route(n, hop)}]", ola_reframe(y, win, inv_env, hop),
                    ola_reframe_plain(y, win, inv_env, hop), tol)
        e2 = 0.0
        for seed in range(3):
            if seed:   # seeds 1, 2 from their own generators: later phases' draws stay
                own = torch.Generator(device="cuda").manual_seed(seed)
                y = torch.randn((b, c, f, n), generator=own, device="cuda").mul(0.05).to(wd)
                r_prev = torch.randn((b, c, f, bins, 2), generator=own, device="cuda").to(wd)
            frames = ola_reframe_plain(y, win, inv_env, hop)
            args = (frames, r_prev, spec, merged, 0.25, 0.4975)
            want64 = fgla_frame_plain(*args, compute=torch.float64)
            want32 = fgla_frame_plain(*args)
            for rt in ("hopper", "stockham"):
                with forced_fgla_route(rt):
                    got = fgla_frame(*args, tw)
                err = check_fgla_frame(f"K2 [{rt}] {wd} seed {seed}", got, want64, want32, wd)
                if rt == route:
                    e2 = max(e2, err)
        if wd == getattr(torch, cfg.fgla_work_dtype):
            plain2 = time_ms(lambda: fgla_frame_plain(frames, r_prev, spec, merged, 0.25, 0.4975))
            frames32 = frames.float()
            cufft = time_ms(lambda: torch.fft.irfft(torch.fft.rfft(frames32, dim=-1), n=n, dim=-1))
            print(f"  cuFFT transforms alone (torch.fft.rfft + irfft of the fp32 frames, a "
                  f"reference only): {cufft:.4f} ms; fgla_frame plain {plain2:.3f} ms "
                  f"(K3's times: kernel_phase_ola)", flush=True)
        times = {}
        for _ in range(2):   # the routes in turns, twice
            for rt in ("hopper", "stockham"):
                with forced_fgla_route(rt):
                    times.setdefault(rt, []).append(time_ms(
                        lambda: fgla_frame(frames, r_prev, spec, merged, 0.25, 0.4975, tw), 20))
        if wd == getattr(torch, cfg.fgla_work_dtype):
            # where the chosen route's time goes: without the inverse, and
            # the seed call (a spectrum in, no forward transform)
            ang = torch.nn.functional.normalize(r_prev.float(), dim=-1).to(wd)
            fwd = time_ms(lambda: fgla_frame(frames, r_prev, spec, merged, 0.25, 0.4975, tw,
                                             inverse=False), 20)
            inv = time_ms(lambda: fgla_frame(ang, None, spec, merged, 0.25, 0.4975, tw,
                                             spectral_in=True), 20)
            print(f"  fgla_frame {wd}, {route} route in parts: forward + spectral step "
                  f"(inverse=False) {fwd:.4f} ms; spectral step + inverse (the seed call) "
                  f"{inv:.4f} ms", flush=True)
        print(f"  fgla_frame {wd}: " + "; ".join(
            f"{rt} route {min(v):.4f} ms (rounds {', '.join(f'{t:.4f}' for t in v)})"
            for rt, v in times.items()), flush=True)
        if wd == getattr(torch, cfg.fgla_work_dtype):
            ms2 = min(times[route])
            item = y.element_size()
            frames_n = b * c * f
            # K2: a real n-point DFT each way per frame (2.5 n log2 n flops as
            # an FFT) plus ~20 flops per bin; frames, previous spectrum,
            # magnitudes and merged magnitudes in, spectrum and frames out
            results["fgla_frame"] = result(
                e2, ms2, plain2, frames_n * (5 * n * math.log2(n) + 20 * bins),
                frames_n * item * (2 * n + 6 * bins), "fp32")

    kw = dict(n_fft=n, hop_length=hop, n_iter=5, momentum=cfg.fgla_momentum,
              stereo=cfg.stereo, stereo_coherence=cfg.stereo_coherence,
              work_dtype=cfg.fgla_work_dtype, phase_init=cfg.fgla_phase_init)
    got = griffinlim(mag, fmt.window, **kw)
    want = griffinlim_reference(mag, fmt.window, **kw)
    rel = ((got - want).norm() / want.norm()).item()

    def conv_err(audio):
        m2 = stft(audio, fmt.window, n, hop).abs()[:, :, :f]
        return ((m2 - mag).norm() / mag.norm()).item()

    ek, ep = conv_err(got), conv_err(want)
    # the loops round their bf16 state at different points, so samples
    # drift apart slowly; spectral convergence must match closely
    ok = rel < 0.05 and abs(ek - ep) < 0.01 * ep + 1e-3
    print(f"  griffinlim 5 iters ({cfg.fgla_work_dtype}, {cfg.fgla_phase_init}, K2 "
          f"{fgla_route(n)} route): kernels vs "
          f"plain loop rel L2 {rel:.4g} (tol 0.05); spectral convergence {ek:.5f} vs "
          f"{ep:.5f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("Griffin-Lim through the kernels disagrees with the plain loop")
    return results


def slice_phase(kind: str = "freq"):
    """The whole slice on a tiny model (grouped MLP convs, attention at level
    1): the CUDA run (through the kernels) against the CPU run (their plain
    versions and the einsum attention), same weights and noise. ``kind``:
    "freq" attention on a 64-bin spectrogram mel; "full" attention with D =
    64 on a 128-bin, 1024-frame mel, whose (32, 256) latents give level 1 L
    = 16 x 128 = 2048, so the card takes K7 there; "ms_mdct_dual", "freq"
    attention on the MS-MDCT dual format's 64-filter mel (128 frames),
    decoded by its FGLA fallback, so K2 and K3 run at its n_fft 4096 and hop
    256. Both runs take the UNet and DAE in bf16 and round at different
    places (the einsum route also rounds its logits to bf16), so latents and
    mel agree to 5e-2 of max; the audio, whose SPSI phases follow mel peaks,
    is compared through its own mel spectrogram: 0.2 relative L2 (measured
    0.09 on both formats), and 0.3 for the full-attention slice, whose
    1024-frame mel carries the logits' rounding into more phases (measured
    0.18 with the mel at 1.4e-2 of max)."""
    import copy
    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (MSMDCTDualFormat, MSMDCTDualFormatConfig,
                                                        SpectrogramFormat,
                                                        SpectrogramFormatConfig)
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams
    full_attention = kind == "full"
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1,
                      channels_per_head=64 if full_attention else 32, mlp_multiplier=2,
                      mlp_groups=2, attn_levels=(1,),
                      attn_axis="full" if full_attention else "freq")
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    if kind == "ms_mdct_dual":
        # 128 mel frames (the format aligns them to 128), hop 256
        fcfg = MSMDCTDualFormatConfig(ms_num_filters=64, default_raw_length=127 * 256)
        fmt, fmt_type = MSMDCTDualFormat(fcfg), "format:ms_mdct_dual"
    else:
        freqs, frames = (128, 1024) if full_attention else (64, 64)
        fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                       num_frequencies=freqs,
                                       default_raw_length=(frames - 1) * 256)
        fmt, fmt_type = SpectrogramFormat(fcfg), "format:spectrogram"
    gen = torch.Generator().manual_seed(1)
    unet = UNet(ucfg).init_weights(gen)
    dae = DAE(dcfg).init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    params = SampleParams(steps=2, num_fgla_iters=3)
    lat_shape = dae.get_latent_shape(fmt.get_sample_shape(1))
    prompt = torch.randn((1, 1024), generator=gen)
    init = torch.randn(lat_shape, generator=gen)
    noise = [torch.randn(lat_shape, generator=gen) for _ in range(params.steps)]
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = Pipeline({
            "unet": ModuleHandle("unet", "unet", ucfg, copy.deepcopy(unet).to(dev)),
            "dae": ModuleHandle("dae", "dae", dcfg, copy.deepcopy(dae).to(dev)),
            "format": ModuleHandle("format", fmt_type, fcfg, fmt)})
        before = launch_counts()
        out = pipe.generate(params, prompt_embedding=prompt.to(dev), init_noise=init.to(dev),
                            step_noise=[n.to(dev) for n in noise])
        after = launch_counts()
        outs[dev] = {k: v.float().cpu() for k, v in out.items()}
        outs[dev]["audio_mel"] = fmt.raw_to_sample(outs[dev]["raw"])
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        needed = ("flash_attention",) if full_attention else ("fgla_frame", "ola_reframe")
        if dev == "cuda" and not all(launched.get(k) for k in needed):
            raise AssertionError(f"the {kind} slice on the card skipped a kernel of {needed}: "
                                 f"{launched}")
    raw_shape = (1, fcfg.num_raw_channels, fmt.get_raw_crop_width())
    if tuple(outs["cuda"]["raw"].shape) != raw_shape:
        raise AssertionError(f"audio shape {tuple(outs['cuda']['raw'].shape)}, not {raw_shape}")
    n_fft = fcfg.ms_window_length if kind == "ms_mdct_dual" else fcfg.padded_length
    print(f"slice on a tiny model ({kind}: {ucfg.attn_axis} attention, {fmt_type}, latents "
          f"{tuple(lat_shape)}, audio {raw_shape}; FGLA n_fft {n_fft}, K2 {fgla_route(n_fft)} "
          f"route, K3 {ola_route(n_fft, 256)} route), CUDA (kernels: {launched}) vs CPU (plain "
          f"versions):", flush=True)
    for key, tol in (("latents", 5e-2), ("sample", 5e-2)):
        check_close(key, outs["cuda"][key], outs["cpu"][key], tol)
    a, b = outs["cuda"]["audio_mel"], outs["cpu"]["audio_mel"]
    rel = ((a - b).norm() / b.norm()).item()
    tol = 0.3 if full_attention else 0.2
    print(f"  audio's mel spectrogram: rel L2 {rel:.4g} (tol {tol}) {'ok' if rel < tol else 'FAIL'}",
          flush=True)
    if not rel < tol:
        raise AssertionError("the slice on the card disagrees with the CPU run")


def ddec_slice_phase():
    """The DDEC decode on a tiny model: format + DAE + UNet (grouped MLP
    convs, so K1 runs) + DDEC (dense convs, cuDNN) on the MS-MDCT dual
    format of tests/test_torch_ms_mdct_generate.py (a (1, 32, 64, 2) mel,
    a (1, 128, 64, 2) linear PSD and (1, 32, 64, 2) MDCT coefficients),
    ``generate(decode_mode="auto")`` on the card against the CPU, same
    weights and noise. Latents and mel agree to 5e-2 of max (bf16, as the
    other slices); the DDEC's coefficients, each device fed the CPU run's
    mel, to 5e-2 of max; the audio, linear in the coefficients but fed each
    device's own mel, to 0.1 relative L2. K1 must launch; K2, K3 and K7
    must not (no Griffin-Lim on this path, "freq" attention at L 4)."""
    import copy
    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    ddcfg = UNetConfig(in_channels=2, out_channels=2, in_num_freqs=32, in_psd_freqs=128,
                       sigma_max=20.0, sigma_min=3e-5, model_channels=16, channel_mult=(1, 2),
                       num_layers_per_block=1, mlp_multiplier=2, double_midblock=True,
                       add_constant_channel=True)
    fcfg = MSMDCTDualFormatConfig(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
                                  default_raw_length=63 * 32)
    fmt = MSMDCTDualFormat(fcfg)
    gen = torch.Generator().manual_seed(4)
    unet, dae, ddec = (UNet(ucfg).init_weights(gen), DAE(dcfg).init_weights(gen),
                       UNet(ddcfg).init_weights(gen))
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
        ddec.core.out_gain.fill_(1.0)
    params = SampleParams(steps=2)
    lat_shape = dae.get_latent_shape(fmt.get_sample_shape(1))
    mdct_shape = fmt.get_mdct_shape_for_mel_frames(1, fmt.get_sample_shape(1)[2])
    prompt = torch.randn((1, 1024), generator=gen)
    noise = {"init_noise": torch.randn(lat_shape, generator=gen),
             "step_noise": [torch.randn(lat_shape, generator=gen) for _ in range(params.steps)],
             "ddec_init_noise": torch.randn(mdct_shape, generator=gen),
             "ddec_step_noise": [torch.randn(mdct_shape, generator=gen)
                                 for _ in range(params.steps)]}

    def on(dev, v):
        return [n.to(dev) for n in v] if isinstance(v, list) else v.to(dev)
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = Pipeline({
            "unet": ModuleHandle("unet", "unet", ucfg, copy.deepcopy(unet).to(dev)),
            "dae": ModuleHandle("dae", "dae", dcfg, copy.deepcopy(dae).to(dev)),
            "ddec": ModuleHandle("ddec", "ddec", ddcfg, copy.deepcopy(ddec).to(dev)),
            "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg, fmt)})
        before = launch_counts()
        out = pipe.generate(params, prompt_embedding=prompt.to(dev),
                            **{k: on(dev, v) for k, v in noise.items()})
        after = launch_counts()
        outs[dev] = {k: v.float().cpu() for k, v in out.items()}
        outs[dev]["coeffs"] = pipe.diffusion_decode(
            params, mdct_shape, init_noise=noise["ddec_init_noise"].to(dev),
            step_noise=on(dev, noise["ddec_step_noise"]), module_name="ddec",
            x_ref=fmt.mel_spec_to_linear(outs["cpu"]["sample"].to(dev))).float().cpu()
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        if dev == "cuda" and (not launched.get("grouped_conv3x3") or
                              any(launched.get(k) for k in ("fgla_frame", "ola_reframe",
                                                            "flash_attention"))):
            raise AssertionError(f"the DDEC slice on the card launched {launched}: K1 and "
                                 f"nothing of K2, K3, K7 expected")
    raw_shape = (1, fcfg.num_raw_channels, fmt.get_raw_crop_width())
    if tuple(outs["cuda"]["raw"].shape) != raw_shape:
        raise AssertionError(f"audio shape {tuple(outs['cuda']['raw'].shape)}, not {raw_shape}")
    print(f"DDEC slice on a tiny model (latents {tuple(lat_shape)}, MDCT {mdct_shape}, PSD "
          f"{(1, ddcfg.in_psd_freqs) + mdct_shape[2:]}, audio {raw_shape}), CUDA (kernels: "
          f"{launched}) vs CPU (plain versions):", flush=True)
    for key, tol in (("latents", 5e-2), ("sample", 5e-2), ("coeffs", 5e-2)):
        check_close(key, outs["cuda"][key], outs["cpu"][key], tol)
    a, b = outs["cuda"]["raw"], outs["cpu"]["raw"]
    rel = ((a - b).norm() / b.norm()).item()
    print(f"  audio: rel L2 {rel:.4g} (tol 0.1) {'ok' if rel < 0.1 else 'FAIL'}", flush=True)
    if not torch.isfinite(a).all() or not rel < 0.1:
        raise AssertionError("the DDEC slice on the card disagrees with the CPU run")


def options_slice_phase():
    """img2img (from audio, strength 0.5), inpainting (a converted UNet of
    8 + 8 + 1 inputs under a half mask, the whole schedule) and the seamless
    loop (shifts given) on a tiny model of a 128-frame mel: the card against
    the CPU, same weights, noise and shifts. As the other slices: latents
    and mel to 5e-2 of max, the audio through its own mel spectrogram to 0.2
    relative L2; K1 must launch on the card. The seamless loop's audio is
    nearly all crossfade (16,128 of its 16,384 samples), a sum of the clip's
    two ends whose Griffin-Lim phases follow the mel's few-percent bf16
    differences apart (measured 0.44 on its mel), so it is held instead
    against the CPU's decode and crossfade of the card's own mel: 0.05
    relative L2, the bound of the Griffin-Lim kernels against their plain
    loop."""
    import copy
    import dataclasses
    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import SpectrogramFormat, SpectrogramFormatConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline, loop_hop_length
    from dualdiffusion_tpu_torch.sampling import SampleParams, seamless_loop_crossfade
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    icfg = dataclasses.replace(ucfg, in_channels=8 + 8 + 1)
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                   num_frequencies=64, default_raw_length=127 * 256)
    fmt = SpectrogramFormat(fcfg)
    gen = torch.Generator().manual_seed(5)
    modules = {"unet": (ucfg, UNet(ucfg).init_weights(gen)),
               "unet_inpainting": (icfg, UNet(icfg).init_weights(gen)),
               "dae": (dcfg, DAE(dcfg).init_weights(gen))}
    with torch.no_grad():
        for name in ("unet", "unet_inpainting"):
            modules[name][1].core.out_gain.fill_(1.0)
    lat_shape = modules["dae"][1].get_latent_shape(fmt.get_sample_shape(1))
    prompt = torch.randn((1, 1024), generator=gen)
    audio = 0.2 * torch.randn((2, fmt.get_raw_crop_width()), generator=gen)
    mask = torch.zeros((1, 1, lat_shape[2], 1))
    mask[..., : lat_shape[2] // 2, :] = 1.0
    init = torch.randn(lat_shape, generator=gen)
    noise = [torch.randn(lat_shape, generator=gen) for _ in range(2)]
    base = SampleParams(steps=2, num_fgla_iters=3, img2img_strength=0.5)
    cases = {"img2img": (base, dict(input_audio=audio), 1),
             "inpainting": (base, dict(input_audio=audio, inpainting_mask=mask), 2),
             "seamless": (dataclasses.replace(base, seamless_loop=True),
                          dict(step_shifts=[3, 17]), 2)}
    for case, (params, kw, run_steps) in cases.items():
        outs = {}
        for dev in ("cpu", "cuda"):
            pipe = Pipeline({n: ModuleHandle(n, "dae" if n == "dae" else "unet", c,
                                             copy.deepcopy(m).to(dev))
                             for n, (c, m) in modules.items()})
            pipe.modules["format"] = ModuleHandle("format", "format:spectrogram", fcfg, fmt)
            before = launch_counts()["grouped_conv3x3"]
            out = pipe.generate(params, prompt_embedding=prompt.to(dev), init_noise=init.to(dev),
                                step_noise=[n.to(dev) for n in noise[:run_steps]],
                                **{k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                                   for k, v in kw.items()})
            launched = launch_counts()["grouped_conv3x3"] - before
            outs[dev] = {k: v.float().cpu() for k, v in out.items()}
            outs[dev]["audio_mel"] = fmt.raw_to_sample(outs[dev]["raw"])
        if not launched:
            raise AssertionError(f"the {case} slice on the card launched no K1")
        print(f"{case} slice on a tiny model (latents {tuple(lat_shape)}, audio "
              f"{tuple(outs['cuda']['raw'].shape)}, {run_steps} steps run, K1 launches "
              f"{launched}), CUDA vs CPU:", flush=True)
        for key in ("latents", "sample"):
            check_close(key, outs["cuda"][key], outs["cpu"][key], 5e-2)
        if case == "seamless":
            what, tol, a = "audio against the CPU's decode of the card's mel", 0.05, \
                outs["cuda"]["raw"]
            b = seamless_loop_crossfade(
                fmt.sample_to_raw(outs["cuda"]["sample"], n_fgla_iters=params.num_fgla_iters,
                                  phase_init=params.fgla_phase_init), loop_hop_length(fcfg))
        else:
            what, tol = "audio's mel spectrogram", 0.2
            a, b = outs["cuda"]["audio_mel"], outs["cpu"]["audio_mel"]
        rel = ((a - b).norm() / b.norm()).item()
        print(f"  {what}: rel L2 {rel:.4g} (tol {tol}) {'ok' if rel < tol else 'FAIL'}",
              flush=True)
        if not rel < tol:
            raise AssertionError(f"the {case} slice on the card disagrees with the CPU run")


def train_slice_phase():
    """Two train steps (gradient accumulation 2, AdamW, one EMA) of a tiny
    grouped UNet on the card (K1 forward and dgrad, K4 wgrad) against the
    same model on the CPU (their plain versions), with the same draws. Both
    run the trunk in bf16 and round at different places: loss and grad norm
    agree to 2e-2 relative. AdamW's first updates are about +-lr per element
    whatever the gradient's size, so a bf16-level difference on a near-zero
    gradient flips an element's update: params and EMA agree to 6 lr per
    element, and no more than 2% of the elements differ by more than lr/2."""
    import copy
    import torch
    from dualdiffusion_tpu_torch.models import UNet, UNetConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSampler,
                                                  UNetTrainConfig, build_optimizer,
                                                  init_train_state, make_unet_train_step)
    from dualdiffusion_tpu_torch.training.train_state import draw_unet_step
    from dualdiffusion_tpu_torch.weights import state_to_flat, to_flat
    ucfg = UNetConfig(in_channels=4, out_channels=4, in_channels_emb=64, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    tc = UNetTrainConfig(grad_accum_steps=2)
    lr, n, shape = 1e-3, 8, (8, 16, 64, 4)
    gen = torch.Generator().manual_seed(3)
    unet = UNet(ucfg).init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)      # a zero out_gain stops every other gradient
    batches = [{"samples": torch.randn(shape, generator=gen),
                "embeddings": torch.randn((n, 64), generator=gen)} for _ in range(2)]
    sampler = SigmaSampler(tc.sigma)
    draws = [draw_unet_step(gen, sampler, tc, n, (n // 2,) + shape[1:], True,
                            unet.emb_label.out_channels) for _ in batches]
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(unet).to(dev)
        opt = build_optimizer("adamw", model.parameters(), lr)
        bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
        step = make_unet_train_step(opt, bank, tc, n)
        state = init_train_state(model, opt, bank, tc.sigma, torch.Generator(device=dev))
        before = launch_counts()
        logs = [step(state, {k: v.to(dev) for k, v in b.items()}, d.to(dev))
                for b, d in zip(batches, draws)]
        after = launch_counts()
        if dev == "cuda" and not all(after[k] > before[k]
                                     for k in ("grouped_conv3x3", "grouped_conv3x3_wgrad")):
            raise AssertionError(f"the train steps on the card skipped a kernel: {before} {after}")
        out[dev] = ([float(g["loss"]) for g in logs], [float(g["grad_norm"]) for g in logs],
                    to_flat(model), state_to_flat(state.ema_state["std0.05"]))
    check_train_agreement("2 train steps of a tiny model, CUDA (kernels) vs CPU (plain "
                          "versions)", out, lr)


def check_train_agreement(what: str, out: dict, lr: float,
                          names=("on the card", "the CPU run")) -> None:
    """``out[dev]`` = (losses, grad norms, flat params, flat EMA) of the same
    steps on "cuda" and "cpu". Both run bf16 trunks and round at different
    places: loss and grad norm agree to 2e-2 relative. AdamW's first updates
    are about +-lr per element whatever the gradient's size, so a bf16-level
    difference on a near-zero gradient flips an element's update: params and
    EMA agree to 6 lr per element, and no more than 2% of the elements
    differ by more than lr/2."""
    print(f"{what}:", flush=True)
    (lc, gc, pc, ec), (lg, gg, pg, eg) = out["cpu"], out["cuda"]
    for name, a, b in (("loss", lg, lc), ("grad norm", gg, gc)):
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        ok = rel <= 2e-2
        print(f"  {name} {a} vs {b}: rel {rel:.3g} (tol 2e-2) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: {name} {names[0]} disagrees with {names[1]}")
    worst, far, total = 0.0, 0, 0
    for got, want in ((pg, pc), (eg, ec)):
        for k in want:
            diff = abs(got[k] - want[k])
            worst = max(worst, float(diff.max()))
            far += int((diff > lr / 2).sum())
            total += diff.size
    ok = worst <= 6 * lr and far <= 0.02 * total
    print(f"  params and EMA: max abs diff {worst:.3g} (tol {6 * lr:g}), {far} of {total} "
          f"elements beyond lr/2 (tol 2%) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{what}: params {names[0]} disagree with {names[1]}")


def mss2d_dft_route_check(gen) -> None:
    """The shapes the JAX op takes and the FFT kernels do not (bw 16, a
    window that is not separable, a stride above bw, the widest block, 128)
    take the direct-DFT kernels (csrc/mss2d_dft.cu), routed by shape: the
    loss and both gradients against the plain version on CPU copies, 1e-4
    of max (fp32 sums in another order), each call counted as a launch on
    the "dft" route; then each kernel and the plain version on the card
    timed, fp32."""
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import (mss2d_block_loss, mss2d_block_loss_grad,
                                                     mss2d_block_loss_grad_plain,
                                                     mss2d_block_loss_plain, mss2d_route)
    from dualdiffusion_tpu_torch.training.losses import _window_2d, product_weights
    for bw, stride, window in ((16, 2, "flat_top"), (32, 4, "flat_top_circular"),
                               (32, 33, "flat_top"), (128, 16, "flat_top")):
        s, t = (torch.randn((4, 72 + bw, 90 + bw), generator=gen, device="cuda")
                for _ in range(2))
        g = torch.rand((4,), generator=gen, device="cuda") + 0.5
        win, wgt = _window_2d(window, bw), product_weights(bw) / bw
        counts = (mss2d_block_loss.launches, mss2d_block_loss_grad.launches,
                  mss2d_block_loss.routes["dft"], mss2d_block_loss_grad.routes["dft"])
        got = (mss2d_block_loss(s, t, bw, stride, win, wgt),
               *mss2d_block_loss_grad(s, t, g, bw, stride, win, wgt))
        cpu = [v.cpu() for v in (s, t, g)]
        want = (mss2d_block_loss_plain(*cpu[:2], bw, stride, win, wgt),
                *mss2d_block_loss_grad_plain(*cpu, bw, stride, win, wgt))
        tag = f"K5/K6 bw {bw} stride {stride} {window} [{mss2d_route(bw, stride, win)}]"
        for name, a, b in zip(("loss", "d_sample", "d_target"), got, want):
            check_close(f"{tag} {name} (card vs CPU)", a.cpu(), b, 1e-4)
        now = (mss2d_block_loss.launches, mss2d_block_loss_grad.launches,
               mss2d_block_loss.routes["dft"], mss2d_block_loss_grad.routes["dft"])
        if now != tuple(c + 1 for c in counts):
            raise AssertionError(f"{tag}: not counted as one launch each on the dft route")
        args = (bw, stride, win, wgt)
        ms = (time_ms(lambda: mss2d_block_loss(s, t, *args), 5),
              time_ms(lambda: mss2d_block_loss_plain(s, t, *args), 3),
              time_ms(lambda: mss2d_block_loss_grad(s, t, g, *args), 5),
              time_ms(lambda: mss2d_block_loss_grad_plain(s, t, g, *args), 3))
        print(f"  {tag} (4, {72 + bw}, {90 + bw}) fp32: K5 {ms[0]:.3f} ms (plain {ms[1]:.3f}), "
              f"K6 with dTarget {ms[2]:.3f} ms (plain {ms[3]:.3f})", flush=True)


def kernel_phase_mss2d(gen) -> dict:
    """K5 and K6 at the DAE training microbatch's shapes: the (8, 2, 256, 680)
    recon and target mel, mid/side-stacked to 16 images, reflect-padded by
    bw/2 for the block widths 32 and 64 (stride bw/8). Forward per-image sums
    against the plain version to 1e-4 relative (fp32 sums in another order).
    Gradient against the plain version's autograd to 1e-4 of max with
    target = sample / 2, where |S| - |T| = |S| / 2 exactly in both versions;
    with an independent target a few bins have |S| ~ |T| and the sign of the
    difference flips between two fp32 evaluations, so there the gradient is
    held to 1e-3 relative L2. Two K6 calls must agree bit for bit. Times are
    per microbatch (both widths); K6 as the trainer calls it (no dTarget).
    Beside them, per width: the kernels' registers and spills (ptxas) and a
    yardstick, labelled so because no single PyTorch call computes this loss:
    torch.fft.rfft2 (cuFFT) of the unfolded, windowed blocks of both tensors,
    the transforms alone."""
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F
    from dualdiffusion_tpu_torch.models.mp import midside_transform
    from dualdiffusion_tpu_torch.ops.kernels import (mss2d_block_loss, mss2d_block_loss_grad,
                                                     mss2d_block_loss_grad_plain,
                                                     mss2d_block_loss_plain)
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    from dualdiffusion_tpu_torch.training.losses import _window_2d, product_weights
    for name, regs, st, ld in ptxas_usage(library().log, "mss2d"):
        print(f"  ptxas {name}: {regs} registers, spills {st} B stored / {ld} B loaded",
              flush=True)
    mss2d_dft_route_check(gen)
    b, c, h, w = TRAIN_BATCH, 2, 256, 680
    print(f"K5 mss2d_block_loss / K6 mss2d_block_loss_grad: recon and target ({b}, {c}, {h}, {w}) "
          f"fp32, stacked to {b * c} images, widths 32 and 64", flush=True)
    recon = torch.randn((b, c, h, w), generator=gen, device="cuda")
    other = torch.randn((b, c, h, w), generator=gen, device="cuda")
    stack = [(midside_transform(x, 1) * np.sqrt(2.0)).reshape(-1, h, w) for x in (recon, other)]
    g = torch.rand((b * c,), generator=gen, device="cuda") + 0.5
    tot = {"fwd": [0.0, 0.0, 0.0, 0.0, 0.0], "bwd": [0.0, 0.0, 0.0, 0.0, 0.0]}
    yardstick = 0.0
    for bw in (32, 64):
        stride, pad = bw // 8, bw // 2
        s, t = (F.pad(x[:, None], (pad,) * 4, mode="reflect")[:, 0] for x in stack)
        half = 0.5 * s
        win, wgt = _window_2d("flat_top", bw), product_weights(bw) / bw
        bc, hp, wp = s.shape
        n_cols = (wp - bw) // stride + 1
        blocks = bc * ((hp - bw) // stride + 1) * n_cols
        # The least FFT work per tensor pass: the real bw-point transforms
        # along W depend only on (row, column block), so each is counted
        # once, not once per covering block position; then bw/2+1 complex
        # bw-point transforms along H per block. K6 adds one adjoint pass
        # (d_sample only) to the two forward passes it needs for the signs.
        log_bw = math.log2(bw)
        pass_flops = (bc * hp * n_cols * 2.5 * bw * log_bw
                      + blocks * (bw // 2 + 1) * 5 * bw * log_bw)
        bins = bw * (bw // 2 + 1)
        tag = f"bw {bw} ({bc}, {hp}, {wp}), {blocks} blocks"
        got = mss2d_block_loss(s, t, bw, stride, win, wgt)
        torch.cuda.synchronize()
        want = mss2d_block_loss_plain(s, t, bw, stride, win, wgt)
        rel = ((got - want).abs() / want.abs()).max().item()
        ok = rel <= 1e-4
        print(f"  K5 {tag}: per-image rel err {rel:.3g} (tol 1e-4) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError("K5 disagrees with its plain version")
        ds, dt = mss2d_block_loss_grad(s, half, g, bw, stride, win, wgt)
        rs, rt = mss2d_block_loss_grad_plain(s, half, g, bw, stride, win, wgt)
        err = max(check_close(f"K6 d_sample {tag}, target = sample / 2", ds, rs, 1e-4),
                  check_close(f"K6 d_target {tag}, target = sample / 2", dt, rt, 1e-4))
        ds, _ = mss2d_block_loss_grad(s, t, g, bw, stride, win, wgt, need_target=False)
        again, _ = mss2d_block_loss_grad(s, t, g, bw, stride, win, wgt, need_target=False)
        rs, _ = mss2d_block_loss_grad_plain(s, t, g, bw, stride, win, wgt, need_target=False)
        l2 = ((ds - rs).norm() / rs.norm()).item()
        flips = ((ds - rs).abs() > 1e-4 * rs.abs().max()).float().mean().item()
        ok = l2 <= 1e-3 and torch.equal(ds, again)
        print(f"  K6 {tag}, independent target: rel L2 {l2:.3g} (tol 1e-3), {flips:.2e} of "
              f"pixels beyond 1e-4 of max; two calls bit-equal {torch.equal(ds, again)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("K6 disagrees with its plain version or is not deterministic")
        in_bytes = 2 * s.numel() * 4
        for key, res in (
                ("fwd", (abs((got - want)).max().item(),
                         time_ms(lambda: mss2d_block_loss(s, t, bw, stride, win, wgt)),
                         time_ms(lambda: mss2d_block_loss_plain(s, t, bw, stride, win, wgt), 3),
                         2 * pass_flops + blocks * 6 * bins, in_bytes + 4 * bc)),
                ("bwd", (err,
                         time_ms(lambda: mss2d_block_loss_grad(s, t, g, bw, stride, win, wgt,
                                                               need_target=False)),
                         time_ms(lambda: mss2d_block_loss_grad_plain(
                             s, t, g, bw, stride, win, wgt, need_target=False), 3),
                         3 * pass_flops + blocks * 12 * bins, in_bytes * 3 // 2 + 4 * bc))):
            acc = tot[key]
            acc[0] = max(acc[0], res[0])
            for i in range(1, 5):
                acc[i] += res[i]
            print(f"  {'K5' if key == 'fwd' else 'K6'} bw {bw}: kernel {res[1]:.3f} ms, plain "
                  f"{res[2]:.3f} ms, bound {bound(res[3], res[4], 'fp32')[0]:.4f} ms", flush=True)
        win_t = torch.as_tensor(win, dtype=torch.float32, device="cuda")
        bs, bt = ((x.unfold(1, bw, stride).unfold(2, bw, stride) * win_t).contiguous()
                  for x in (s, t))
        yard = time_ms(lambda: (torch.fft.rfft2(bs), torch.fft.rfft2(bt)), 5)
        yardstick += yard
        print(f"  yardstick bw {bw} (no PyTorch call computes this loss; a reference only): "
              f"torch.fft.rfft2 of the unfolded, windowed blocks of both tensors alone "
              f"{yard:.3f} ms", flush=True)
        del bs, bt
    print(f"  yardstick per microbatch (cuFFT's transforms alone, both widths): {yardstick:.3f} ms",
          flush=True)
    out = {}
    for key, name in (("fwd", "mss2d_block_loss"), ("bwd", "mss2d_block_loss_grad")):
        err, ms, plain_ms, flops, nbytes = tot[key]
        print(f"  {name} per microbatch: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        out[name] = result(err, ms, plain_ms, flops, nbytes, "fp32")
    return out


def dae_train_slice_phase():
    """Two train steps (gradient accumulation 2, AdamW, one EMA, the fused
    MSS2D loss, phase invariance) of a tiny DAE on the card (K5, K6) against
    the same DAE on the CPU (their plain versions), with the same weights,
    audio and draws. Both run the trunk in bf16 and round at different
    places: loss and grad norm agree to 2e-2 relative."""
    import copy
    import math

    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSamplerConfig,
                                                  build_optimizer, draw_dae_step,
                                                  init_train_state, make_dae_train_step)
    from dualdiffusion_tpu_torch.training.module_trainers import DAETrainConfig
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=4)
    fmt = MSMDCTDualFormat(MSMDCTDualFormatConfig(ms_num_filters=64))
    tc = DAETrainConfig(grad_accum_steps=2, use_fused_mss2d=True, point_loss_warmup_steps=4,
                        kl_warmup_steps=4, latents_regularization_warmup_steps=4)
    n, length = 4, 80 * 256                 # a 64 x 72 mel after crop and alignment
    gen = torch.Generator().manual_seed(5)
    dae = DAE(dcfg).init_weights(gen)
    t = torch.arange(length) / 32000
    batches = []
    for _ in range(2):
        f0 = torch.rand((n, 2, 1), generator=gen) * 2000 + 100
        audio = 0.3 * torch.sin(2 * math.pi * f0 * t) + 0.05 * torch.randn(
            (n, 2, length), generator=gen)
        batches.append(audio)
    draws = [draw_dae_step(gen, tc, n // 2) for _ in batches]
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(dae).to(dev)
        opt = build_optimizer("adamw", model.parameters(), 1e-3)
        bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
        step = make_dae_train_step(fmt, opt, bank, tc, n)
        state = init_train_state(model, opt, bank, SigmaSamplerConfig(),
                                 torch.Generator(device=dev))
        before = launch_counts()
        logs = [step(state, {"audio": a.to(dev)}, [d.to(dev) for d in dr])
                for a, dr in zip(batches, draws)]
        after = launch_counts()
        if dev == "cuda" and not all(after[k] > before[k]
                                     for k in ("mss2d_block_loss", "mss2d_block_loss_grad")):
            raise AssertionError(f"the DAE train steps on the card skipped a kernel: "
                                 f"{before} {after}")
        out[dev] = ([float(g["loss"]) for g in logs], [float(g["grad_norm"]) for g in logs])
    print("2 train steps of a tiny DAE, CUDA (kernels) vs CPU (plain versions):", flush=True)
    for i, name in enumerate(("loss", "grad norm")):
        a, b = out["cuda"][i], out["cpu"][i]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        ok = rel <= 2e-2
        print(f"  {name} {a} vs {b}: rel {rel:.3g} (tol 2e-2) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"DAE train step {name} on the card disagrees with the CPU run")


def ddec_train_slice_phase():
    """Two train steps each, card against CPU with the same weights, audio
    and draws, of: the DDEC trainer (a tiny DDEC on the frozen tiny
    supersampled, label-conditioned DAE of tests/test_torch_ddec_training.py,
    audio embeddings in the batch), the joint DAE + DDEC trainer, and the
    DAE trainer on that DAE with audio embeddings. Gradient accumulation 2,
    AdamW, one EMA; the tolerances of ``check_train_agreement``. Their convs
    are dense (cuDNN): no kernel of K1-K7 may launch. The DDEC's teacher
    stays bit for bit as it was."""
    import copy
    import math

    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.training import (
        DAETrainConfig, DDECTrainConfig, EMABank, EMAConfig, JointDAEDDECConfig, SigmaSampler,
        SigmaSamplerConfig, build_optimizer, ddec_sample_shape, draw_dae_step, draw_joint_step,
        draw_unet_step, init_train_state, make_dae_train_step, make_ddec_train_step,
        make_joint_dae_ddec_train_step)
    from dualdiffusion_tpu_torch.training.losses import MSSLoss2DConfig
    from dualdiffusion_tpu_torch.training.module_trainers import ddec_prepare_drawer
    from dualdiffusion_tpu_torch.weights import state_to_flat, to_flat
    fcfg = MSMDCTDualFormatConfig(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
                                  default_raw_length=63 * 32)
    fmt = MSMDCTDualFormat(fcfg)
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1,), channel_mult_dec=(1, 2),
                     num_enc_layers_per_block=2, num_dec_layers_per_block=1, latent_channels=4,
                     in_channels_emb=64, supersampled=True)
    ddcfg = UNetConfig(in_channels=2, out_channels=2, in_num_freqs=32, in_psd_freqs=128,
                       sigma_max=20.0, sigma_min=3e-5, model_channels=16, channel_mult=(1, 2),
                       num_layers_per_block=1, mlp_multiplier=2, double_midblock=True,
                       add_constant_channel=True)
    lr, n, length = 1e-3, 4, 63 * 32
    gen = torch.Generator().manual_seed(6)
    dae = DAE(dcfg).init_weights(gen)
    ddec = UNet(ddcfg).init_weights(gen)
    with torch.no_grad():
        ddec.core.out_gain.fill_(1.0)      # a zero out_gain stops every other gradient
        for b in list(dae.enc) + list(dae.dec):
            b.emb_gain.fill_(1.0)          # a zero gain mutes the label embedding
    t = torch.arange(length) / 32000
    batches = []
    for _ in range(2):
        f0 = torch.rand((n, 2, 1), generator=gen) * 2000 + 100
        batches.append({"audio": 0.3 * torch.sin(2 * math.pi * f0 * t)
                        + 0.05 * torch.randn((n, 2, length), generator=gen),
                        "audio_embeddings": torch.randn((n, 64), generator=gen)})
    ddec_tc = DDECTrainConfig()
    ddec_tc.unet.grad_accum_steps = 2
    joint_tc = JointDAEDDECConfig(dae=DAETrainConfig(
        kl_warmup_steps=4, mss2d=MSSLoss2DConfig(block_widths=(8, 16, 32))), grad_accum_steps=2)
    dae_tc = DAETrainConfig(grad_accum_steps=2, kl_warmup_steps=4, point_loss_warmup_steps=4,
                            latents_regularization_warmup_steps=4,
                            mss2d=MSSLoss2DConfig(block_widths=(8, 16, 32)))
    shape = ddec_sample_shape(fmt, dae, ddec_tc, (n // 2, 2, length))
    draws = {
        "ddec": [draw_unet_step(gen, SigmaSampler(ddec_tc.unet.sigma), ddec_tc.unet, n, shape,
                                True, 0, ddec_prepare_drawer(ddec_tc)) for _ in batches],
        "joint": [draw_joint_step(gen, joint_tc, n, shape) for _ in batches],
        "dae": [draw_dae_step(gen, dae_tc, n // 2) for _ in batches]}

    def run(kind: str, dev: str):
        teacher = copy.deepcopy(dae).to(dev).requires_grad_(False)
        if kind == "ddec":
            model = copy.deepcopy(ddec).to(dev)
        elif kind == "joint":
            model = torch.nn.ModuleDict({"dae": copy.deepcopy(dae), "ddec": copy.deepcopy(ddec)}
                                        ).to(dev)
        else:
            model = copy.deepcopy(dae).to(dev)
        opt = build_optimizer("adamw", model.parameters(), lr)
        bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
        if kind == "ddec":
            step = make_ddec_train_step(fmt, teacher, opt, bank, ddec_tc, n)
            sigma = ddec_tc.unet.sigma
        elif kind == "joint":
            step = make_joint_dae_ddec_train_step(fmt, opt, bank, joint_tc, n)
            sigma = joint_tc.ddec.unet.sigma
        else:
            step = make_dae_train_step(fmt, opt, bank, dae_tc, n)
            sigma = SigmaSamplerConfig()
        state = init_train_state(model, opt, bank, sigma, torch.Generator(device=dev))
        logs = []
        for b, d in zip(batches, draws[kind]):
            d = [x.to(dev) for x in d] if isinstance(d, list) else d.to(dev)
            logs.append(step(state, {k: v.to(dev) for k, v in b.items()}, d))
        if kind == "ddec" and not all(torch.equal(v.cpu(), dae.state_dict()[k])
                                      for k, v in teacher.state_dict().items()):
            raise AssertionError("the DDEC train steps moved the teacher DAE")
        return ([float(g["loss"]) for g in logs], [float(g["grad_norm"]) for g in logs],
                to_flat(model), state_to_flat(state.ema_state["std0.05"]))

    for kind, what in (("ddec", "2 DDEC train steps (tiny DDEC, frozen tiny d3 DAE)"),
                       ("joint", "2 joint DAE + DDEC train steps"),
                       ("dae", "2 DAE train steps of a tiny supersampled, label-conditioned "
                               "DAE with audio embeddings")):
        before = launch_counts()
        out = {dev: run(kind, dev) for dev in ("cpu", "cuda")}
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        if launched:
            raise AssertionError(f"{what} launched {launched}; no kernel of K1-K7 expected")
        check_train_agreement(f"{what}, CUDA vs CPU (no kernel launched)", out, lr)


def visible_pairs(seq_len: int, window, causal: bool) -> int:
    """(query, key) pairs that a band |i - j| <= window and a causal mask
    leave: the products and exponentials an attention of them needs."""
    import numpy as np
    i = np.arange(seq_len)
    lo = np.zeros(seq_len, np.int64) if window is None else np.maximum(i - window, 0)
    hi = np.full(seq_len, seq_len - 1) if window is None else np.minimum(i + window, seq_len - 1)
    if causal:
        hi = np.minimum(hi, i)
    return int((hi - lo + 1).sum())


def attention_inputs(gen, b: int, seq_len: int, heads: int, d: int):
    """bf16 q, k, v as the UNet's attention block hands them over: (B, H, L,
    D) views of (B, L, H, D) tensors, unit RMS per head like its normalized
    q, k and v, so the logits are ~N(0, 1) as there."""
    import torch
    return [torch.randn((b, seq_len, heads, d), generator=gen, device="cuda").bfloat16()
            .transpose(1, 2) for _ in range(3)]


def kernel_phase_flash(gen) -> dict:
    """K7 against its plain version (fp32 masked softmax) at the
    full-attention model's level-1 shapes, each also timed against
    ``torch.nn.functional.scaled_dot_product_attention`` (the library
    yardstick, called nowhere in the port). P is rounded to bf16 for the
    P V products, as the JAX einsum route rounds its probabilities, and o is
    stored in bf16: 2e-2 of max |o|. The line's numbers are per UNet
    forward (the 7 level-1 blocks: 4, 5 x 8 and 12 heads); the band, causal
    and ragged cases, the head widths 8, 24 and 192 (zero-padded in the
    kernel's loads) and 320 and 512 (the D-chunked kernel, at L 2048) are
    checked and timed beside them."""
    import torch
    import torch.nn.functional as F
    from dualdiffusion_tpu_torch.ops.kernels import flash_attention, flash_attention_plain
    b, l, d0 = FLASH_B, FLASH_L, FLASH_D
    print(f"K7 flash_attention: B={b} L={l} D={d0} bf16, (B, L, H, D) views", flush=True)
    cases = [(h, l, d0, None, False, n) for h, n in FLASH_HEADS]
    cases += [(8, l, d0, 256, False, 0), (8, l, d0, None, True, 0), (8, 5000, d0, None, False, 0)]
    # head widths that the kernel zero-pads in its loads (to 32, 32 and 256)
    cases += [(8, l, d, None, False, 0) for d in (8, 24, 192)]
    # heads wider than 256 (the D-chunked kernel): B 2, H 4, L 2048
    cases += [(4, 2048, d, None, False, 0) for d in (320, 512)]
    worst, tot = 0.0, [0.0] * 5       # kernel, plain, library ms, flops, bytes
    for h, seq, d, window, causal, n in cases:
        q, k, v = attention_inputs(gen, b, seq, h, d)
        kw = dict(window=window, causal=causal)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"H {h} L {seq} D {d} window {window} causal {causal}"
        err = check_close(tag, got, flash_attention_plain(q, k, v, **kw), 2e-2)
        worst = max(worst, err)
        mask = None
        if window is not None:
            idx = torch.arange(seq, device="cuda")
            mask = (idx[:, None] - idx[None, :]).abs() <= window
        ms = time_ms(lambda: flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                is_causal=causal))
        flops = 4 * b * h * visible_pairs(seq, window, causal) * d
        nbytes = 4 * b * h * seq * d * 2
        bound_ms, by = bound(flops, nbytes, "bf16")
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"{ms / bound_ms:.2f}x", flush=True)
        for i, x in enumerate((ms, plain_ms, lib_ms, flops, nbytes)):
            tot[i] += n * x
    print(f"  per UNet forward (7 level-1 blocks): kernel {tot[0]:.3f} ms, plain {tot[1]:.3f} ms, "
          f"library {tot[2]:.3f} ms", flush=True)
    return result(worst, tot[0], tot[1], tot[3], tot[4], "bf16", tot[2])


def flash_crossover(gen) -> None:
    """K7 against the port's einsum route (the route below FLASH_MIN_SEQ) at
    B 2, H 8, D 64, bf16, from level 4's L 86 of the full-attention model
    (level 3: 344) to level 1's 5504, for the dispatch threshold."""
    from dualdiffusion_tpu_torch.models.attention import FLASH_MIN_SEQ, einsum_attention
    from dualdiffusion_tpu_torch.ops.kernels import flash_attention
    line = {}
    for seq in (86, 172, 344, 1376, 2048, 2752, 5504):
        q, k, v = attention_inputs(gen, FLASH_B, seq, 8, FLASH_D)
        line[seq] = {"k7_ms": time_ms(lambda: flash_attention(q, k, v)),
                     "einsum_ms": time_ms(lambda: einsum_attention(q, k, v, FLASH_D ** -0.5))}
    print(f"K7 vs the einsum route (B {FLASH_B}, H 8, D {FLASH_D}, bf16; FLASH_MIN_SEQ "
          f"{FLASH_MIN_SEQ}): {json.dumps(line)}", flush=True)


def serving_path(model_dir, fmt, prompt, decode_mode: str = "fgla", steps: int = SAMPLER_STEPS):
    """``Pipeline.from_pretrained`` then ``generate`` once per seed, checking
    the audio's shape, finiteness and loudness; returns the pipeline, the
    first seed's audio and {seed: seconds of its generate}."""
    import torch
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams
    t0 = time.perf_counter()
    pipe = Pipeline.from_pretrained(model_dir, device="cuda")
    print(f"from_pretrained: {time.perf_counter() - t0:.2f} s", flush=True)
    params = SampleParams(steps=steps, cfg_scale=1.5, use_heun=True,
                          num_fgla_iters=100, fgla_phase_init="spsi")
    decode = ("the DDEC (same steps, no CFG), inverse MDCT" if decode_mode != "fgla"
              else f"{params.num_fgla_iters} FGLA iters")
    outs, totals = [], {}
    for seed in SEEDS:
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        out = pipe.generate(params, torch.Generator(device="cuda").manual_seed(seed),
                            prompt_embedding=prompt, decode_mode=decode_mode, timings=timings)
        torch.cuda.synchronize()
        total = totals[seed] = time.perf_counter() - t0
        raw = out["raw"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"generate seed {seed} (decode_mode {decode_mode!r}): {params.steps} steps "
              f"(CFG {params.cfg_scale}, Heun), {decode}; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
              + f", total {total:.3f} s; peak memory {peak:.2f} GiB", flush=True)
        rms = raw.float().square().mean().sqrt().item()
        if tuple(raw.shape) != (1, 2, fmt.get_raw_crop_width()):
            raise AssertionError(f"audio shape {tuple(raw.shape)}")
        if not torch.isfinite(raw).all() or not rms > 0:
            raise AssertionError(f"audio not finite or silent (rms {rms})")
        print(f"  audio {tuple(raw.shape)} rms {rms:.5f}", flush=True)
        outs.append(raw)
    if torch.equal(outs[0], outs[1]):
        raise AssertionError("two seeds gave identical audio")
    return pipe, outs[0], totals


def ddec_configs():
    """The DDEC serving path's model: the ref-scale latent UNet and DAE on
    the edm2_default MS-MDCT dual format, with the DDEC of
    configs/models/edm2_ddec_mclt_b1a (32 ch x (1, 2, 3, 4), 3 layers a
    block, mlp x2 dense, 2048 PSD rows folded 8 to a model row)."""
    from dualdiffusion_tpu_torch.models import UNetConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.utils import load_config
    models = REPO / "configs" / "models"
    return (load_config(UNetConfig, models / "edm2_ddec_mclt_b1a" / "ddec.json"),
            load_config(MSMDCTDualFormatConfig, models / "edm2_default" / "format.json"))


def ddec_forward(ddec, cfg, mdct_shape, gen) -> None:
    """One full-width DDEC forward (batch 1, no CFG, as the sampler calls
    it): device ms (CUDA events after a warm-up), the analytic GFLOP of
    ``unet_fwd_flops``, the achieved TFLOP/s and the bound at the bf16 peak;
    then one forward under ``torch.profiler``, its device time by kernel
    group. Its convs are dense (``groups=1``), so cuDNN runs them, not K1."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dualdiffusion_tpu_torch.utils.perf import unet_fwd_flops
    b, h, w, _ = mdct_shape
    x = torch.randn(mdct_shape, generator=gen, device="cuda")
    ref = torch.randn((b, cfg.in_psd_freqs, w, cfg.in_channels), generator=gen,
                      device="cuda").abs()
    sigma = torch.full((b,), 1.0, device="cuda")
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: ddec(x, sigma, None, ref), reps=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = unet_fwd_flops(cfg, b, h, w)
    bound_ms = flops / PEAK_FLOPS["bf16"] * 1e3
    print(f"DDEC forward at {tuple(mdct_shape)} (PSD {tuple(ref.shape)}): {ms:.3f} ms, "
          f"{flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s, bound {bound_ms:.3f} ms "
          f"(operations, bf16 peak; {bound_ms / ms:.1%} of it); peak memory {peak:.2f} GiB",
          flush=True)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ddec(x, sigma, None, ref)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print_device_time(prof, "profiled DDEC forward", wall_s, "on the host clock (profiled)",
                      top=10)


def seamless_conv_check(unet, lat_h: int, lat_w: int, gen) -> None:
    """K1 against its plain version at every distinct grouped-conv shape of
    one UNet forward at the seamless loop's width (the latents' W plus
    2 x LOOP_PAD columns; batch 2 under CFG), with each shape's time and
    the sum over one forward beside its bound."""
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import (grouped_conv3x3, grouped_conv3x3_plain,
                                                     prepare_weights)
    from dualdiffusion_tpu_torch.sampling import LOOP_PAD
    groups = unet.cfg.mlp_groups
    shapes = grouped_conv_shapes(unet, 2, lat_h, lat_w + 2 * LOOP_PAD)
    print(f"K1 at the seamless width W {lat_w + 2 * LOOP_PAD} (latents {lat_w} + 2 x {LOOP_PAD}):",
          flush=True)
    total_ms = flops = 0.0
    for (b, h, w, cin, cout), n in {s: shapes.count(s) for s in dict.fromkeys(shapes)}.items():
        x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
        wt = prepare_weights(torch.randn((cout, cin // groups, 3, 3), generator=gen, device="cuda")
                             / (9 * cin // groups) ** 0.5, groups)
        got = grouped_conv3x3(x, wt, groups)
        torch.cuda.synchronize()
        route = conv_route(cin // groups, cout // groups, x, wt, got)
        ms = time_ms(lambda: grouped_conv3x3(x, wt, groups))
        check_close(f"({b},{h},{w},{cin}->{cout}) x{n} [{route}] {ms:.4f} ms", got,
                    grouped_conv3x3_plain(x, wt, groups), 2 ** -7)
        total_ms += n * ms
        flops += n * 2 * 9 * cin * cout // groups * b * h * w
    print(f"  per UNet forward at W {lat_w + 2 * LOOP_PAD}: K1 {total_ms:.3f} ms, bound "
          f"{bound(flops, 0.0, 'bf16')[0]:.4f} ms ({flops / 1e9:.1f} GFLOP bf16)", flush=True)


def generation_options_path(model_dir: Path, ddec_dir: Path, fmt, mfmt, prompt, clip,
                            k1_per_forward: int, card: str) -> None:
    """The options of ``generate`` at full width on the reference-scale
    pipeline (50 Heun steps, CFG 1.5, SPSI + 100 Griffin-Lim iterations):
    img2img from the first serving clip at strength 0.5 (K1 launched for 25
    steps, half the latent stage) and 0 (no step: the latents are the
    input's normalized encoding plus sigma_min's noise, 0.05 relative L2 as
    tests/test_torch_generate_options.py states); inpainting 10-20 s on the
    converted UNet (its 4 + 4 + 1 inputs, every forward of all 50 steps);
    the seamless loop under Griffin-Lim and under the DDEC (shifts that
    differ from step to step; the audio shorter by the crossfade); the
    chunked preview with an abort after 3 chunks of 10 steps; and the
    ``python -m dualdiffusion_tpu_torch.sample`` CLI with every option, whose
    WAV must read -20 LUFS (0.5 LU). Each run prints its stages' seconds,
    its peak memory and its K1 launches, after a line naming ``card``."""
    import dataclasses
    import torch
    from dualdiffusion_tpu_torch.models.convert import convert_unet_to_inpainting
    from dualdiffusion_tpu_torch.models.mp import normalize
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline, loop_hop_length
    from dualdiffusion_tpu_torch.sample import inpainting_mask
    from dualdiffusion_tpu_torch.sampling import LOOP_PAD, SampleParams
    from dualdiffusion_tpu_torch.training.ema import save_ema_archive
    from dualdiffusion_tpu_torch.utils import (get_audio_loudness, load_audio, save_audio,
                                               save_safetensors)
    base = SampleParams(steps=OPTIONS_STEPS, cfg_scale=1.5, use_heun=True, num_fgla_iters=100,
                        fgla_phase_init="spsi")
    print(f"generation options on {card}: {OPTIONS_STEPS} steps (CFG 1.5, Heun), SPSI + 100 "
          f"Griffin-Lim iterations or the DDEC; seed {SEEDS[0]}", flush=True)

    def run(what, pipe, params, want_k1_steps, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings, debug = {}, {}
        before = launch_counts()["grouped_conv3x3"]
        t0 = time.perf_counter()
        out = pipe.generate(params, torch.Generator(device="cuda").manual_seed(SEEDS[0]),
                            prompt_embedding=prompt, timings=timings, debug=debug, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launched = launch_counts()["grouped_conv3x3"] - before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = 2 * want_k1_steps * k1_per_forward
        print(f"{what}: " + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
              + f", total {total:.3f} s; peak memory {peak:.2f} GiB; K1 launches {launched} "
              f"({want_k1_steps} steps x 2 forwards x {k1_per_forward} expected)", flush=True)
        if launched != want:
            raise AssertionError(f"{what}: {launched} K1 launches, not {want}")
        if not torch.isfinite(out["raw"]).all():
            raise AssertionError(f"{what}: audio not finite")
        return out, debug

    pipe = Pipeline.from_pretrained(model_dir, device="cuda")
    sd = pipe.modules["unet"].config.sigma_data
    audio = clip[0]
    # ---- img2img at strength 0.5 and 0 ----
    run("img2img (strength 0.5)", pipe, dataclasses.replace(base, img2img_strength=0.5),
        OPTIONS_STEPS // 2, input_audio=audio)
    out, debug = run("img2img (strength 0)", pipe, dataclasses.replace(base, img2img_strength=0.0),
                     0, input_audio=audio)
    enc = normalize(pipe.encode_input_audio(audio)) * sd
    rel = ((out["latents"] - enc).norm() / enc.norm()).item()
    expect("strength 0: latents against normalize(encode(input))", rel <= 0.05,
           f"rel L2 {rel:.4g} (tol 0.05)")
    del pipe

    # ---- inpainting on the converted UNet ----
    t0 = time.perf_counter()
    convert_unet_to_inpainting(model_dir)
    pipe = Pipeline.from_pretrained(model_dir, device="cuda")
    print(f"convert_unet_to_inpainting + from_pretrained: {time.perf_counter() - t0:.2f} s",
          flush=True)
    conv, orig = pipe.modules["unet_inpainting"].module, pipe.modules["unet"].module
    cin = conv.core.enc_conv_in.weight.shape[1]
    expect("unet_inpainting's enc_conv_in", cin == 4 + 4 + 1, f"{cin} input channels")
    calls = []
    hook = conv.register_forward_pre_hook(lambda m, a: calls.append(1))
    mask = inpainting_mask(pipe, 10.0, 20.0, fmt.config.sample_rate)
    cols = int(mask.sum())
    out, debug = run("inpainting 10-20 s", pipe, dataclasses.replace(base, img2img_strength=0.5),
                     OPTIONS_STEPS, input_audio=audio, inpainting_mask=mask)
    hook.remove()
    expect("unet_inpainting forwards", len(calls) == 2 * OPTIONS_STEPS and
           len(debug["sample_std"]) == OPTIONS_STEPS,
           f"{len(calls)} forwards, {len(debug['sample_std'])} steps ({cols} of "
           f"{mask.shape[2]} latent columns regenerated)")
    lat = out["latents"]
    x = torch.randn(lat.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda") * 2.0
    sigma = torch.full((1,), 1.0, device="cuda")
    zero_ref = torch.zeros(lat.shape[:-1] + (lat.shape[-1] + 1,), device="cuda")
    with torch.no_grad():
        y_conv = conv(x, sigma, None, zero_ref)
        y_orig = orig(x, sigma)
        scale = (4 / cin) ** 0.5
        orig.core.enc_conv_in.weight.mul_(scale)     # the inference fan-in divisor's change
        y_scaled = orig(x, sigma)
        orig.core.enc_conv_in.weight.div_(scale)
    for name, want in (("the original UNet", y_orig),
                       ("the original with enc_conv_in x sqrt(4/9)", y_scaled)):
        err = ((y_conv - want).abs().max() / want.abs().max()).item()
        print(f"  full-width forward {tuple(x.shape)} of unet_inpainting with a zero reference "
              f"against {name}: max err {err:.4g} of max", flush=True)
    expect("converted forward against the scaled original", err <= 5e-2,
           f"{err:.4g} of max (tol 5e-2, bf16 trunks)")
    del pipe, conv, orig

    # ---- the seamless loop under Griffin-Lim and under the DDEC ----
    for name, d, f, kw in (("Griffin-Lim", model_dir, fmt, {}),
                           ("DDEC", ddec_dir, mfmt, {"decode_mode": "auto"})):
        pipe = Pipeline.from_pretrained(d, device="cuda")
        if name == "Griffin-Lim":
            pipe.modules.pop("unet_inpainting")
        out, debug = run(f"seamless loop ({name})", pipe,
                         dataclasses.replace(base, seamless_loop=True), OPTIONS_STEPS, **kw)
        hop = loop_hop_length(f.config)
        want_len = f.get_raw_crop_width() - int((LOOP_PAD - 0.5) * hop) * 2
        expect("audio length", out["raw"].shape[-1] == want_len,
               f"{out['raw'].shape[-1]} samples (crop {f.get_raw_crop_width()} less "
               f"int((32 - 0.5) x {hop}) x 2)")
        for stage, dbg in (("latent", debug), ("DDEC", debug.get("ddec"))):
            if dbg is None:
                continue
            shifts = dbg["step_shifts"]
            moved = sum(a != b for a, b in zip(shifts, shifts[1:]))
            expect(f"{stage} stage's shifts", len(shifts) == OPTIONS_STEPS and
                   moved >= OPTIONS_STEPS - 5, f"{len(set(shifts))} distinct of "
                   f"{len(shifts)}, {moved} changes between steps")
        del pipe

    # ---- the chunked preview, aborted after 3 chunks of 10 steps ----
    pipe = Pipeline.from_pretrained(model_dir, device="cuda")
    pipe.modules.pop("unet_inpainting")
    seen = []

    def preview(done, sample):
        seen.append((done, bool(torch.isfinite(sample).all())))
        return done >= 30
    out, debug = run("chunked preview, aborted", pipe, base, 30, chunk_size=10,
                     chunk_callback=preview)
    rms = out["latents"].square().mean().sqrt().item()
    expect("callbacks and the partial sample", [d for d, _ in seen] == [10, 20, 30] and
           all(ok for _, ok in seen) and abs(rms - sd) < 1e-2,
           f"called after {[d for d, _ in seen]} steps; latents rms {rms:.5f}")

    # ---- the CLI with every option, on a post-hoc EMA ----
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    state = pipe.modules["unet"].module.state_dict()
    for i, (n, std) in enumerate(((4000, 0.05), (8000, 0.05), (8000, 0.1))):
        save_ema_archive({k: v + 0.01 * torch.randn(v.shape, generator=gen, device="cuda")
                          for k, v in state.items()},
                         model_dir / "unet" / "ema_archive" / f"{n}_ema_std{std}.safetensors",
                         n // 8, n, std)
    dim = pipe.modules["unet"].config.in_channels_emb
    rng = torch.Generator().manual_seed(8)
    save_safetensors({k: torch.randn(dim, generator=rng).numpy()
                      for k in ("label_a_audio", "label_a_text", "_unconditional_audio")},
                     model_dir / "dataset_embeddings.safetensors")
    wav = model_dir / "input.wav"
    save_audio(audio.float().cpu().numpy(), fmt.config.sample_rate, wav)
    del pipe, state
    torch.cuda.empty_cache()
    print(f"CLI inputs (3 bf16 EMA archives, dataset embeddings, the input WAV): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out_wav = model_dir / "cli" / "out.wav"
    cmd = [sys.executable, "-m", "dualdiffusion_tpu_torch.sample", "--model_path", str(model_dir),
           "--prompt", "label_a:1.0", "--load_ema", "phema_0.05", "--img2img", str(wav),
           "--img2img_strength", "0.6", "--inpaint", "10:20", "--seamless_loop",
           "--output", str(out_wav)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(f"python -m dualdiffusion_tpu_torch.sample {' '.join(cmd[3:])}: exit "
          f"{proc.returncode}, {wall:.2f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise AssertionError("the sample CLI failed")
    wav_out, sr = load_audio(out_wav, return_sample_rate=True)
    lufs = get_audio_loudness(wav_out, sr)
    want_len = fmt.get_raw_crop_width() - int((LOOP_PAD - 0.5) * loop_hop_length(fmt.config)) * 2
    expect("CLI output", wav_out.shape == (2, want_len) and abs(lufs + 20.0) <= 0.5,
           f"{wav_out.shape} at {sr} Hz, {lufs:.3f} LUFS (-20 +- 0.5)")


def http(url: str, body=None, timeout: float = 60):
    """GET (POST with a JSON ``body``) ``url``: JSON as a dict, else bytes."""
    import urllib.request
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
        ctype = r.headers.get("Content-Type", "")
    return json.loads(data) if ctype.startswith("application/json") else data


def wait_cmd(state, what: str, timeout: float = 600) -> float:
    """Seconds until the model server has taken its command; raises on its
    error or after ``timeout``."""
    t0 = time.perf_counter()
    while state.get("cmd") is not None:
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what}: the model server did not answer in {timeout} s")
        time.sleep(0.02)
    if state.get("error"):
        raise AssertionError(f"{what}: {state['error']}")
    return time.perf_counter() - t0


def webui_model_configs(root: Path, ucfg, dcfg) -> Path:
    """A config root for ``create_new_model``, ``<root>/configs/ref_scale_ddec/``:
    configs/models/edm2_default's model_index.json and format.json, the DDEC
    of configs/models/edm2_ddec_mclt_b1a, and the reference-scale UNet and DAE
    of ``ref_scale_configs`` (the DDEC serving path's model: edm2_default's
    dae.json has 8 latent channels, the ref-scale UNet takes 4)."""
    from dualdiffusion_tpu_torch.utils import config_to_dict, save_json
    models = REPO / "configs" / "models"
    d = root / "configs" / "ref_scale_ddec"
    d.mkdir(parents=True)
    for name, src in (("model_index", "edm2_default"), ("format", "edm2_default"),
                      ("ddec", "edm2_ddec_mclt_b1a")):
        (d / f"{name}.json").write_text((models / src / f"{name}.json").read_text())
    save_json(config_to_dict(ucfg), d / "unet.json")
    save_json(config_to_dict(dcfg), d / "dae.json")
    return d.parent


def web_ui_serving_path(root: Path, ucfg, dcfg, raw_len: int, clip_s: dict, card: str):
    """The web UI's user flow on the card: ``python -m
    dualdiffusion_tpu_torch.create_new_model`` writes the DDEC serving model
    (ref-scale UNet and DAE, the edm2_default MS-MDCT dual format, the
    edm2_ddec_mclt_b1a DDEC) from a seed; ``launch(device="cuda")`` spawns the
    model server, which loads it and runs ``compile_model``; the port's UI
    handlers behind a port-0 HTTP server take, at full width (45 s, batch 1,
    50 Heun steps, CFG 1.5, decoded by the DDEC under "auto"), (a) a plain
    request (its preview PNG, WAV and spectrogram PNG), (b) an editor inpaint
    of 10-20 s of output 0, (c) an editor append, (d) a request aborted after
    its first preview and (e) a rating and a save, each checked to have come
    from that request with no server error; then ``python -m
    dualdiffusion_tpu_torch.sample --interactive --port <free port>`` answers
    while it runs. Prints the load, warm-up, request, first-preview and abort
    seconds, each request's seconds over ``clip_s`` (the same clip
    in-process), and the server's device memory (the card's free memory as
    ``torch.cuda.mem_get_info`` reports it, against its value before
    ``launch``). Returns the model directory and the request parameters."""
    import io
    import signal
    import socket
    import threading
    import urllib.error
    from http.server import ThreadingHTTPServer
    import numpy as np
    import torch
    from scipy.io import wavfile
    from dualdiffusion_tpu_torch.serving import launch
    from dualdiffusion_tpu_torch.serving.webui import UIState, _make_handler
    from dualdiffusion_tpu_torch.utils import get_audio_metadata, save_safetensors

    print(f"web UI serving on {card}", flush=True)
    cfg_root = webui_model_configs(root, ucfg, dcfg)
    cmd = [sys.executable, "-m", "dualdiffusion_tpu_torch.create_new_model", "--name",
           "ref_scale_ddec", "--config_path", str(cfg_root), "--output_path", str(root / "models")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise AssertionError("create_new_model failed")
    counts = [l.strip() for l in proc.stderr.splitlines() if "params" in l]
    print(f"python -m dualdiffusion_tpu_torch.create_new_model (on the card): {wall:.2f} s; "
          + "; ".join(counts), flush=True)
    model_dir = root / "models" / "ref_scale_ddec"
    # prompt embeddings, so that requests run CFG as the in-process clips did
    rng = torch.Generator().manual_seed(8)
    save_safetensors({k: torch.randn(ucfg.in_channels_emb, generator=rng).numpy()
                      for k in ("label_a_audio", "_unconditional_audio")},
                     model_dir / "dataset_embeddings.safetensors")
    body = {"steps": CUT_SERVING_STEPS, "cfg_scale": 1.5, "use_heun": True, "num_fgla_iters": 100,
            "fgla_phase_init": "spsi", "seed": SEEDS[0], "prompt": {"label_a": 1.0}}

    # the server's device memory: the card's free memory as this process sees
    # it (torch.cuda.mem_get_info), which holds its own allocations still while
    # the server runs, so every change is the server's
    free0 = torch.cuda.mem_get_info()[0]
    least_free = [free0]

    def mib_used(free: int) -> str:
        return f"{(free0 - free) / 2 ** 20:.0f} MiB"

    t0 = time.perf_counter()
    server, state = launch(str(model_dir), device="cuda")
    httpd = None
    try:
        wait_cmd(state, "load_model")
        load_s = time.perf_counter() - t0
        state["sample_params"] = body
        state["cmd"] = "compile_model"
        compile_s = wait_cmd(state, "compile_model")
        state["cmd"] = "get_available_devices"
        wait_cmd(state, "get_available_devices")
        warm_free = torch.cuda.mem_get_info()[0]
        print(f"server process {server.pid}: launch to loaded model {load_s:.2f} s, "
              f"compile_model {compile_s:.2f} s; devices {state['available_devices']}; "
              f"modules {state['model_modules']}, prompt labels {state['prompt_labels']}; "
              f"device memory after load and warm-up {mib_used(warm_free)}", flush=True)
        expect("error after load and warm-up", state.get("error") is None, "None")
        expect("available devices", "cuda:0" in state["available_devices"], "cuda:0 listed")
        ui = UIState(state, model_dir / "presets")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(ui))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        in_process = min(clip_s.values())

        def generated() -> int:
            return sum("generated output" in l for l in ui.log_lines)

        def request(what, extra, abort: bool = False):
            n0, g0 = len(ui.outputs), generated()
            t0 = time.perf_counter()
            r = http(f"{base}/api/generate", dict(body, **extra))
            expect(f"{what}: POST /api/generate", bool(r.get("ok")), str(r))
            first = aborted = None
            while True:
                st = http(f"{base}/api/status")
                now = time.perf_counter()
                least_free[0] = min(least_free[0], torch.cuda.mem_get_info()[0])
                if first is None and st["preview"]:
                    first = now - t0
                    try:
                        png = http(f"{base}/api/preview.png")
                        expect(f"{what}: preview after {first:.2f} s ({st['status']})",
                               png[:8] == b"\x89PNG\r\n\x1a\n", f"PNG of {len(png)} bytes")
                    except urllib.error.HTTPError as e:   # the run ended between the two GETs
                        print(f"  {what}: preview gone ({e.code})", flush=True)
                    if abort:
                        http(f"{base}/api/abort", {})
                        aborted = time.perf_counter()
                if not st["busy"]:
                    break
                if now - t0 > 600:
                    raise TimeoutError(f"{what} did not finish")
                time.sleep(0.1)
            wall = time.perf_counter() - t0
            line = (f"{what}: {wall:.3f} s from POST to idle, first preview after "
                    + ("none" if first is None else f"{first:.3f} s"))
            if abort:
                line += f", abort to idle {time.perf_counter() - aborted:.3f} s"
            else:
                line += (f"; in-process clip {in_process:.3f} s (serving phase, best of "
                         f"{len(clip_s)}), overhead {wall - in_process:+.3f} s")
            print(line, flush=True)
            want = n0 if abort else n0 + 1
            expect(f"{what}: server error", state.get("error") is None, str(state.get("error")))
            expect(f"{what}: outputs", len(ui.outputs) == want and generated() == g0 + want - n0,
                   f"{len(ui.outputs)} (want {want}), {generated() - g0} generated")
            if not abort:
                raw = ui.outputs[0]["raw"]
                expect(f"{what}: audio", raw.shape == (1, 2, raw_len) and
                       bool(np.isfinite(raw).all()), f"{raw.shape} {raw.dtype}")
            return wall

        request("(a) plain request", {})
        print(f"server device memory after request (a) {mib_used(torch.cuda.mem_get_info()[0])},"
              f" at most {mib_used(least_free[0])} while it ran (polled every 0.1 s)",
              flush=True)
        sr, pcm = wavfile.read(io.BytesIO(http(f"{base}/api/output/0/audio.wav")))
        rms = float(np.sqrt(np.mean((pcm.astype(np.float64) / 32767) ** 2)))
        expect("(a) audio.wav", pcm.shape == (raw_len, 2) and rms > 0,
               f"RIFF, {pcm.shape[0] / sr:.3f} s at {sr} Hz, {pcm.shape[1]} channels, rms {rms:.5f}")
        spec = http(f"{base}/api/output/0/spec.png")
        expect("(a) spec.png", spec[:8] == b"\x89PNG\r\n\x1a\n", f"PNG of {len(spec)} bytes")
        request("(b) editor inpaint 10-20 s of output 0",
                {"input_output_id": 0, "inpaint_start": 10.0, "inpaint_end": 20.0})
        request("(c) editor extend (append) of output 0",
                {"input_output_id": 0, "extend": "append"})
        request("(d) aborted request", {"seed": SEEDS[1]}, abort=True)
        st = http(f"{base}/api/status")
        expect("(d) after the abort", st["status"] == "idle" and not st["busy"] and
               state.get("generate_output") is None, f"status {st['status']!r}, no output")
        r = http(f"{base}/api/output/0/rate", {"rating": 4})
        saved = http(f"{base}/api/output/0/save", {})
        tags = get_audio_metadata(saved["path"])
        expect("(e) rate and save", r.get("rating") == 4 and tags.get("RATING") == ["4"],
               f"{saved['path']}, RATING {tags.get('RATING')}")
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        mine = [l for l in apps.splitlines() if l.split(",")[0].strip() == str(server.pid)]
        print(f"server device memory (mem_get_info, over requests (a)-(e)): at most "
              f"{mib_used(least_free[0])}, now {mib_used(torch.cuda.mem_get_info()[0])}; "
              f"nvidia-smi --query-compute-apps, pid {server.pid}: {mine or 'not listed'}; "
              f"this process: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
              flush=True)
    finally:
        state["cmd"] = "shutdown"
        server.join(timeout=60)
        if server.is_alive():
            server.terminate()
            server.join(timeout=30)
        if httpd is not None:
            httpd.shutdown()

    # the CLI: python -m dualdiffusion_tpu_torch.sample --interactive, on a port
    # that was free a moment ago; only an answer while the CLI still runs counts
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cli_base = f"http://127.0.0.1:{port}"
    cli = [sys.executable, "-m", "dualdiffusion_tpu_torch.sample", "--model_path", str(model_dir),
           "--interactive", "--port", str(port)]
    with open(root / "interactive.log", "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cli, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            info = None
            while info is None and proc.poll() is None and time.perf_counter() - t0 < 300:
                try:
                    info = http(f"{cli_base}/api/info", timeout=5)
                except OSError:
                    time.sleep(0.5)
            wall = time.perf_counter() - t0
            st = http(f"{cli_base}/api/status") if info is not None else {}
            alive = proc.poll() is None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGINT)    # the UI and its server exit cleanly
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
    if info is None:
        print((root / "interactive.log").read_text()[-4000:], flush=True)
    expect(f"python -m dualdiffusion_tpu_torch.sample --interactive ({wall:.2f} s to answer)",
           alive and info is not None and "unet" in info["modules"] and st.get("status") == "idle",
           f"port {port}, /api/info modules {None if info is None else info['modules']}, status "
           f"{st.get('status')!r}, CLI running {alive}")
    return model_dir, body


def serving_launch_count(model_dir: Path, body: dict, raw_len: int) -> None:
    """One request through an in-process ``ModelServer`` over a plain dict,
    run in a thread (launch counts live in the process that launches), with
    ``decode_mode`` "fgla": the latent stage and the format's Griffin-Lim
    decode, whose kernels the caller counts."""
    import threading
    import numpy as np
    from dualdiffusion_tpu_torch.serving import ModelServer
    state = {"model_name": str(model_dir), "cmd": "load_model", "decode_mode": "fgla",
             "sample_params": body}
    thread = threading.Thread(target=ModelServer(state, "cuda").run, daemon=True)
    thread.start()
    try:
        load_s = wait_cmd(state, "load_model (in-process)")
        state["cmd"] = "generate"
        gen_s = wait_cmd(state, "generate (in-process, fgla)")
        raw = state["generate_output"]["raw"]
        print(f"in-process ModelServer: load {load_s:.2f} s, one request under decode_mode "
              f"'fgla' {gen_s:.3f} s, audio {raw.shape}", flush=True)
        if raw.shape != (1, 2, raw_len) or not np.isfinite(raw).all():
            raise AssertionError(f"in-process request: audio {raw.shape} not finite or cut")
    finally:
        state["cmd"] = "shutdown"
        thread.join(timeout=60)


def _train_snapshot(trainer) -> dict:
    """Everything a checkpoint must restore, copied to the host: the
    optimizer's whole state (AdamW, Muon, clip) and the host-memory EMA
    profiles among it."""
    import torch
    st = trainer.state

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [host(v) for v in x]
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x
    return {"counters": (st.global_step, st.total_samples_processed),
            "params": host(st.module.state_dict()),
            "ema": {**host(st.ema_state), **host(trainer.host_ema or {})},
            "optimizer": host(st.optimizer.state_dict()),
            "sigma_pdf": st.sigma_pdf.cpu(), "generator": st.generator.get_state()}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "shape"):
        return a.shape == b.shape and bool((a == b).all())
    return a == b


def capture_first_step(trainer, into: dict) -> None:
    """Wrap the trainer's step so that ``into`` gets the first step's loss,
    grad norm and whole parameters (flat, on the host)."""
    step = trainer.train_step

    def wrapped(state, batch):
        logs = step(state, batch)
        if not into:
            from dualdiffusion_tpu_torch.parallel import gathered
            from dualdiffusion_tpu_torch.weights import to_flat
            with gathered(state.module):   # copies: to_flat shares a CPU tensor's memory
                into.update(loss=float(logs["loss"]), grad_norm=float(logs["grad_norm"]),
                            params={k: v.copy() for k, v in to_flat(state.module).items()})
        return logs
    trainer.train_step = wrapped


def run_training(model_dir: Path, data_dir: Path, config: dict, device: str,
                 steps: int = TRAIN_STEPS, after=None, first=None) -> dict:
    """The port's training entry on ``model_dir`` (a pipeline model
    directory) with the TrainerConfig ``config``: ``steps`` steps, then
    ``--resume`` for one more. Checks finite losses, that params and every
    EMA moved, and that the resumed state is the saved one exactly;
    ``after(trainer, saved)`` checks more on the resumed trainer and the
    snapshot of the state before its step; ``first``, a dict, gets the first
    step (``capture_first_step``). Returns step seconds (after the first),
    samples/s and peak memory."""
    import gc
    import numpy as np
    import torch
    from dualdiffusion_tpu_torch import train
    path = model_dir / f"{config['module_name']}_train_config.json"
    path.write_text(json.dumps(config))
    argv = ["--model_path", str(model_dir), "--train_config_path", str(path),
            "--dataset_path", str(data_dir), "--device", device]
    batch = config["device_batch_size"] * config["gradient_accumulation_steps"]
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train.build_trainer(train.parse_args(argv + ["--max_steps", str(steps)]))
    if first is not None:
        capture_first_step(trainer, first)
    trainer.train(max_steps=steps)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    history = list(trainer.history)
    saved = _train_snapshot(trainer)
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    resumed = train.build_trainer(train.parse_args(argv + ["--resume",
                                                           "--max_steps", str(steps + 1)]))
    if not _same(_train_snapshot(resumed), saved):
        raise AssertionError("the resumed train state differs from the saved one")
    parts = ", ".join(k for k, v in saved["optimizer"].items() if v is not None)
    print(f"  checkpoint round-trip: step {resumed.state.global_step}, params and buffers, EMA "
          f"(device and host), optimizer state ({parts}), sigma pdf and generator restored "
          f"exactly", flush=True)
    resumed.train(max_steps=steps + 1)
    history += resumed.history
    final = resumed.state
    losses = [h["loss"] for h in history]
    if len(losses) != steps + 1 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if final.global_step != steps + 1:
        raise AssertionError(f"ended at step {final.global_step}")

    def moved(now, before) -> float:
        return max(float((now[k].detach().float().cpu() - before[k].float()).abs().max())
                   for k in before)
    params_moved = moved(final.module.state_dict(), saved["params"])
    profiles = {**final.ema_state, **(resumed.host_ema or {})}
    ema_moved = min(moved(profiles[name], saved["ema"][name]) for name in config["emas"])
    print(f"  losses {[round(x, 5) for x in losses]}; in the resumed step params moved by up to "
          f"{params_moved:.4g} and each EMA by up to at least {ema_moved:.4g}", flush=True)
    if not (params_moved > 0 and ema_moved > 0):
        raise AssertionError("params or an EMA did not move")
    if after is not None:
        after(resumed, saved)
    step_s = [h["seconds"] for h in history[1:steps]]
    stats = {"step_s": float(np.mean(step_s)), "samples_per_s": batch / np.mean(step_s),
             "peak_gib": peak, "wall_s": wall}
    print(f"  step seconds after the first {[round(x, 4) for x in step_s]} (mean "
          f"{stats['step_s']:.4f}); {stats['samples_per_s']:.2f} samples/s; peak memory "
          f"{peak:.2f} GiB; {steps} steps with checkpoint in {wall:.1f} s", flush=True)
    return stats


def unet_train_config(latent_w: int) -> dict:
    """The UNet training path's TrainerConfig: device batch 8 x accumulation
    2, one EMA, no warm-up, the latents' whole width."""
    return {"device_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": TRAIN_ACCUM,
            "module_name": "unet", "lr_schedule": {"lr_warmup_steps": 0},
            "emas": {"std0.05": {"std": 0.05}},
            "dataloader": {"latents_crop_width": latent_w}}


def unet_training_path(model_dir: Path, latent_chw, emb_dim: int, device: str,
                       first=None) -> dict:
    """UNet training on a synthetic latent dataset (the JAX trainer's
    default crop), device batch 8 x accumulation 2, one EMA, no warm-up;
    ``first`` as in ``run_training``."""
    from dualdiffusion_tpu_torch.dataset import write_latent_dataset
    data_dir = model_dir / "latents"
    write_latent_dataset(data_dir, TRAIN_SAMPLES, latent_chw, emb_dim, seed=5)
    print(f"UNet training: latents {tuple(latent_chw)}, device batch {TRAIN_BATCH} x accumulation "
          f"{TRAIN_ACCUM}, {TRAIN_SAMPLES} samples, {TRAIN_STEPS} steps then --resume for 1",
          flush=True)
    return run_training(model_dir, data_dir, unet_train_config(latent_chw[-1]), device,
                        first=first)


def dae_training_path(model_dir: Path, device: str = "cuda", steps: int = TRAIN_STEPS):
    """The edm2_default DAE (configs/models/edm2_default/dae.json) on its
    MS-MDCT dual format, trained with its dae_train.json (KL, phase
    invariance, point loss, crop 4, edm2 lr, std-0.05 EMA) plus the fused
    MSS2D loss, from seeded random weights on 32 synthetic stereo WAVs.
    Cut: accumulation 2 (the config's 8) and 5.5 s crops (the dataloader's
    45 s default). ``steps=0`` writes the model directory, data and
    config only."""
    import torch
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.utils import config_from_dict, load_json
    cfg_dir = REPO / "configs" / "models" / "edm2_default"
    dcfg = config_from_dict(DAEConfig, load_json(cfg_dir / "dae.json"))
    fcfg = config_from_dict(MSMDCTDualFormatConfig, load_json(cfg_dir / "format.json") or {})
    tjson = load_json(cfg_dir / "dae_train.json")
    fmt = MSMDCTDualFormat(fcfg)
    dae = DAE(dcfg, device=device).init_weights(torch.Generator(device=device).manual_seed(7))
    n_params = sum(p.numel() for p in dae.parameters())
    Pipeline({"dae": ModuleHandle("dae", "dae", dcfg, dae),
              "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg, fmt)}
             ).save_pretrained(model_dir)
    del dae
    data_dir = model_dir / "audio"
    t0 = time.perf_counter()
    write_audio_dataset(data_dir, TRAIN_SAMPLES, 2, DAE_RAW_CROP + 8192, fcfg.sample_rate, seed=6)
    frames = DAE_RAW_CROP // fcfg.ms_hop_length + 1
    crop = tjson["module_trainer_config"]["crop_edges"]
    ds = 2 ** (len(dcfg.channel_mult_dec) - 1)
    width = (frames - 2 * crop) // ds * ds
    mel = (TRAIN_BATCH, fcfg.ms_num_filters, width, fcfg.num_raw_channels)
    lat = (TRAIN_BATCH, fcfg.ms_num_filters // ds, width // ds, dcfg.latent_channels)
    config = {
        "module_name": "dae", "module_trainer": "dae",
        "module_trainer_config": {**tjson["module_trainer_config"], "use_fused_mss2d": True},
        "device_batch_size": TRAIN_BATCH, "gradient_accumulation_steps": TRAIN_ACCUM,
        "lr_schedule": tjson["lr_schedule"], "emas": tjson["emas"],
        "dataloader": {"use_pre_encoded_latents": False, "load_datatypes": ["audio"],
                       "raw_crop_width": DAE_RAW_CROP}}
    print(f"DAE training: edm2_default DAE {n_params / 1e6:.2f}M params "
          f"({dcfg.model_channels} ch x {dcfg.channel_mult_enc}, "
          f"{dcfg.num_enc_layers_per_block} + {dcfg.num_dec_layers_per_block} layers per block, "
          f"latent {dcfg.latent_channels}), format ms_mdct_dual; trainer config "
          f"{config['module_trainer_config']}; {TRAIN_SAMPLES} synthetic stereo WAVs written in "
          f"{time.perf_counter() - t0:.1f} s; raw crop {DAE_RAW_CROP} samples -> {frames} mel "
          f"frames, {mel} after the trainer's crop and alignment, latents {lat}; "
          f"cut: device batch {TRAIN_BATCH} x accumulation "
          f"{TRAIN_ACCUM} (the config's 8), crop 5.5 s (the dataloader's 45 s), "
          f"{TRAIN_STEPS} steps then --resume for 1", flush=True)
    if steps == 0:        # model directory, data and config only
        (model_dir / "dae_train_config.json").write_text(json.dumps(config))
        return None
    return run_training(model_dir, data_dir, config, device, steps)


def ddec_training_path(root: Path, smi: str) -> Path:
    """DDEC training at full width: ``python -m
    dualdiffusion_tpu_torch.create_new_model`` writes
    configs/models/edm2_ddec_mclt_b1a from a seed on the card (the default
    MS-MDCT dual format, the d3-series supersampled, label-conditioned DAE,
    the 14.49M-parameter DDEC); 32 synthetic stereo WAVs with embedding
    files; the training entry with b1a's own ddec_train.json (its lr
    schedule, clip, both EMAs), 4 steps then 1 after ``--resume``. Cut:
    accumulation 2 (the config's 12), 5.5 s crops (the dataloader's 45 s),
    EMA archives every 4 steps (the config's 10,000); device batch 8, as in
    the config. Checks the teacher DAE is bit for bit unchanged and absent
    from the checkpoint. Then one DDEC training microbatch (forward and
    backward) at the full 45 s length. Returns a pristine copy of the model
    directory for the joint phase."""
    import shutil

    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.dataset import write_audio_dataset
    from dualdiffusion_tpu_torch.utils import load_json, load_safetensors
    from dualdiffusion_tpu_torch.weights import to_flat
    name = "edm2_ddec_mclt_b1a"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.create_new_model",
                    "--name", name, "--config_path", str(REPO / "configs" / "models"),
                    "--output_path", str(root), "--seed", "7"], check=True, cwd=REPO)
    model_dir = root / name
    print(f"create_new_model {name} on the card: {time.perf_counter() - t0:.2f} s", flush=True)
    pristine = root / f"{name}_pristine"
    shutil.copytree(model_dir, pristine)
    dae_cfg = load_json(model_dir / "dae" / "dae.json")
    data_dir = root / "audio"
    t0 = time.perf_counter()
    write_audio_dataset(data_dir, TRAIN_SAMPLES, 2, DAE_RAW_CROP + 8192, seed=8,
                        emb_dim=dae_cfg["in_channels_emb"])
    tjson = load_json(REPO / "configs" / "models" / name / "ddec_train.json")
    config = {**tjson, "gradient_accumulation_steps": TRAIN_ACCUM,
              "emas": {k: {**v, "num_archive_steps": TRAIN_STEPS}
                       for k, v in tjson["emas"].items()},
              "dataloader": {**tjson["dataloader"], "raw_crop_width": DAE_RAW_CROP}}
    print(f"DDEC training: {name}; trainer config {json.dumps(config)}; {TRAIN_SAMPLES} "
          f"synthetic stereo WAVs with {dae_cfg['in_channels_emb']}-dim embedding files written "
          f"in {time.perf_counter() - t0:.1f} s; cut: device batch "
          f"{config['device_batch_size']} x accumulation {TRAIN_ACCUM} (the config's "
          f"{tjson['gradient_accumulation_steps']}), crop 5.5 s (the dataloader's 45 s), EMA "
          f"archives every {TRAIN_STEPS} steps (the config's 10000), {TRAIN_STEPS} steps then "
          f"--resume for 1; {smi}", flush=True)
    teacher_file = load_safetensors(model_dir / "dae" / "dae.safetensors")

    def after(trainer, saved):
        teacher = trainer.train_step.teacher
        got = to_flat(teacher)
        if any(p.requires_grad for p in teacher.parameters()) or not all(
                np.array_equal(got[k], v) for k, v in teacher_file.items()):
            raise AssertionError("the teacher DAE changed or is trainable")
        ckpt = sorted(model_dir.glob("ddec_checkpoint-*"))[-1]
        if sorted(p.name for p in ckpt.iterdir() if p.is_dir()) != ["ddec", "src_snapshot"]:
            raise AssertionError(f"the DDEC checkpoint holds {list(ckpt.iterdir())}")
        archives = sorted(p.name for p in (model_dir / "ddec_ema_archive").iterdir())
        print(f"  teacher DAE bit for bit unchanged; checkpoint {ckpt.name} holds the DDEC "
              f"only (and the source snapshot); EMA archives {archives}", flush=True)
        if len(archives) != len(config["emas"]):
            raise AssertionError("EMA archives missing")
    run_training(model_dir, data_dir, config, "cuda", after=after)
    ddec_microbatch_45s(model_dir)
    return pristine


def ddec_microbatch_45s(model_dir: Path) -> None:
    """One DDEC training microbatch, forward and backward, at the full 45 s
    length: (1, 256, 5504, 2) MDCT coefficients, the (1, 2048, 5504, 2)
    PSD, the EDM2-weighted loss with the learned logvar. Device ms (CUDA
    events after a warm-up) and peak memory, for sizing a DDEC training
    cell."""
    import torch
    from dualdiffusion_tpu_torch.pipelines.pipeline import load_module
    _, cfg, ddec = load_module(model_dir, "ddec", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (1, cfg.in_num_freqs, 5504, cfg.in_channels)
    x = torch.randn(shape, generator=gen, device="cuda")
    ref = torch.randn((1, cfg.in_psd_freqs, 5504, cfg.in_channels), generator=gen,
                      device="cuda").abs()
    sigma = torch.full((1,), 0.5, device="cuda")

    def step():
        ddec.zero_grad(set_to_none=True)
        sig = sigma.reshape(-1, 1, 1, 1)
        denoised = ddec(x + x * sig, sigma, None, ref, training=True)
        weight = (sig ** 2 + 1) / sig ** 2
        loss = ((denoised - x) ** 2 * weight).mean(dim=(1, 2, 3))
        lv = ddec.get_sigma_loss_logvar(sigma).reshape(-1)
        (loss / torch.exp(lv) + lv).mean().backward()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, reps=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"DDEC training microbatch at {shape} (PSD {tuple(ref.shape)}), forward + backward: "
          f"{ms:.2f} ms, peak memory {peak:.2f} GiB", flush=True)
    del ddec
    torch.cuda.empty_cache()


def joint_training_path(root: Path, model_dir: Path, batch: int) -> None:
    """Joint DAE + DDEC training on a fresh copy of the b1a model directory:
    ``"module_trainer": "dae_ddec"``, the ``ddec`` section from b1a's
    ddec_train.json (the rest of the trainer config too) and the ``dae``
    section from configs/models/edm2_dae_d3a/dae_train.json (no joint config
    exists in configs/). Cut: accumulation 2, 5.5 s crops, EMA archives
    every 4 steps; device batch ``batch``. Checks that both modules' params
    and the DAE's stats moved, and that the checkpoint holds both modules
    and ``from_pretrained`` loads them."""
    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline
    from dualdiffusion_tpu_torch.utils import load_json
    from dualdiffusion_tpu_torch.weights import to_flat
    models = REPO / "configs" / "models"
    tjson = load_json(models / "edm2_ddec_mclt_b1a" / "ddec_train.json")
    dae_json = load_json(models / "edm2_dae_d3a" / "dae_train.json")
    config = {**tjson, "module_trainer": "dae_ddec", "device_batch_size": batch,
              "gradient_accumulation_steps": TRAIN_ACCUM,
              "module_trainer_config": {"ddec": tjson.get("module_trainer_config", {}),
                                        "dae": dae_json["module_trainer_config"]},
              "emas": {k: {**v, "num_archive_steps": TRAIN_STEPS}
                       for k, v in tjson["emas"].items()},
              "dataloader": {**tjson["dataloader"], "raw_crop_width": DAE_RAW_CROP}}
    print(f"joint DAE + DDEC training: {model_dir.name}; trainer config {json.dumps(config)}; "
          f"cut: device batch {batch} x accumulation {TRAIN_ACCUM}, crop 5.5 s, EMA archives "
          f"every {TRAIN_STEPS} steps, {TRAIN_STEPS} steps then --resume for 1", flush=True)

    def after(trainer, saved):
        state = trainer.state.module.state_dict()
        for name in ("dae", "ddec"):
            moved = max(float((state[k].float().cpu() - v.float()).abs().max())
                        for k, v in saved["params"].items()
                        if k.startswith(name + ".") and "latents_" not in k)
            print(f"  {name} params moved by up to {moved:.4g} in the resumed step", flush=True)
            if not moved > 0:
                raise AssertionError(f"the {name} params did not move")
        stats = state["dae.latents_var"].cpu()
        if torch.equal(stats, saved["params"]["dae.latents_var"]):
            raise AssertionError("the DAE's latent stats did not move")
        ckpt = sorted(model_dir.glob("ddec_checkpoint-*"))[-1]
        pipe = Pipeline.from_pretrained(model_dir, device="cuda",
                                        load_checkpoints={"dae": ckpt.name, "ddec": "latest"})
        for name in ("dae", "ddec"):
            got, want = to_flat(pipe.modules[name].module), to_flat(trainer.state.module[name])
            if sorted(got) != sorted(want) or not all(np.array_equal(got[k], want[k])
                                                      for k in want):
                raise AssertionError(f"the checkpoint's {name} does not load as trained")
        print(f"  checkpoint {ckpt.name} holds {sorted(p.name for p in ckpt.iterdir())}; "
              f"from_pretrained loads its dae and ddec as trained; EMA archives in "
              f"{sorted(p.name for p in model_dir.glob('*_ema_archive'))}", flush=True)
        del pipe
    run_training(model_dir, root / "audio", config, "cuda", after=after)


#: the dataset factory phase's songs: (path under the dataset, seconds); two
#: share a file name in two folders
FACTORY_SONGS = (("gameA/01 - Title.wav", 45), ("gameB/01 - Title.wav", 45),
                 ("gameA/02 - Boss.wav", 180), ("gameB/03 - Field.wav", 180))
#: the bf16 bound for encodes that differ only in summation order (card against
#: CPU, tiled against untiled away from the seams): each of the DAE's ~30
#: layers rounds to bf16 (2**-9 relative), in another order, so the errors add
#: up as a random walk to about 1e-2 relative L2; 3e-2 leaves room for it
FACTORY_BF16_REL_L2 = 3e-2


def timed_steps(trainer, rounds: int = 3) -> dict:
    """Seconds of the trainer's own step on one batch, with the host-memory
    EMA update and without it, in turns (each ending on the loss's copy to
    the host, as the trainer's clock ends)."""
    batch = next(iter(trainer.dataloader.epoch_iter(trainer.epoch, 0)))
    batch.pop("paths", None)
    times = {True: [], False: []}
    for i in range(rounds):
        for offload in ((True, False) if i % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            logs = trainer.train_step(trainer.state, dict(batch))
            if offload:
                trainer._update_host_emas()
            float(logs["loss"])
            times[offload].append(time.perf_counter() - t0)
    trainer.host_ema         # waits for the worker
    return times


def host_ema_copy_ms(trainer, reps: int = 5):
    """Milliseconds of one host-memory EMA hand-over: the module's tensors
    packed into one fp32 buffer on the card and copied to pinned host memory,
    until the copy's event completes; and its bytes."""
    import torch
    from dualdiffusion_tpu_torch.training.ema import trained_tensors
    worker = trainer._async_host_ema
    trainer.host_ema                        # the worker is idle: its buffers are free
    tensors = trained_tensors(trainer.state.module)
    worker._stage(tensors)[1].synchronize()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        worker._stage(tensors)[1].synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, sum(t.numel() for t in tensors.values()) * 4


def optimizer_step_ms(model, reps: int = 3):
    """Milliseconds of one optimizer update of ``model``'s parameters at
    seeded gradients: Muon (its w_mp weights, AdamW the rest) against AdamW
    alone, in turns, after a warm-up each."""
    import torch
    from dualdiffusion_tpu_torch.training.optim import build_optimizer, jax_param_paths
    g = torch.Generator(device="cuda").manual_seed(13)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g, device="cuda") * 1e-3
    paths = jax_param_paths(model, collection=False)
    opts = {"muon": build_optimizer("muon", paths, 1e-5),
            "adamw": build_optimizer("adamw", [p for _, p in paths], 1e-5)}
    for o in opts.values():
        o.step(0)
    ms = {k: [] for k in opts}
    for i in range(reps):
        for name in (("muon", "adamw") if i % 2 == 0 else ("adamw", "muon")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opts[name].step(i + 1)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return ms, len(opts["muon"].muon.params)


def m1_mss2d_check(batch, fmt) -> None:
    """K5 and K6 through the wrapper the m1 step calls (widths 8-64, mid/side
    "stack"), on the (2, 2, 256, W) MDCT images of two real samples rotated
    as the step rotates them, and a perturbed copy, against their plain
    versions on the CPU (the loss to 1e-4 relative, the recon gradient to
    1e-3 relative L2: independent targets flip |S| - |T| in a few bins)."""
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import mss2d_loss_fused
    g = torch.Generator(device="cuda").manual_seed(17)
    audio = batch["audio"][:2]
    theta = torch.rand((audio.shape[0],), generator=g, device="cuda") * 6.2832
    with torch.no_grad():
        x = fmt.raw_to_mdct(audio, theta)[:, :, 4:-4]
        x = x[:, :, : x.shape[2] // 8 * 8].permute(0, 3, 1, 2).contiguous()
    recon = (x + 0.1 * torch.randn(x.shape, generator=g, device="cuda")).requires_grad_()
    got = mss2d_loss_fused(recon, x, use_midside=True)
    got.sum().backward()
    ref = recon.detach().cpu().requires_grad_()
    want = mss2d_loss_fused(ref, x.cpu(), use_midside=True)
    want.sum().backward()
    rel = ((got.detach().cpu() - want.detach()).abs() / want.detach().abs()).max().item()
    l2 = ((recon.grad.cpu() - ref.grad).norm() / ref.grad.norm()).item()
    expect(f"K5/K6 on the m1 microbatch's MDCT image {tuple(x.shape)}",
           rel <= 1e-4 and l2 <= 1e-3,
           f"loss rel err {rel:.3g} (tol 1e-4), recon gradient rel L2 {l2:.3g} (tol 1e-3) "
           f"against the plain version on the CPU")


def rest_of_training_path(root: Path, path_counts, reset_counts, smi: str) -> None:
    """The rest of training at full width: (a) the m1 DAE (edm2_default's DAE
    on its MDCT: ``domain="mdct"``, the fused MSS2D through K5/K6, the
    prime-width 1-D MSS, phase invariance, NorMuon, a host-memory EMA
    profile beside a device one of the same std, a profiler trace of step
    1); (b) the p1 DAE (the mel domain, the randomized-prime MSS, the
    equivariance loss, Muon); both with the DAE training path's cut, batch
    8 x accumulation 2 of 5.5 s crops, 4 steps then 1 after ``--resume``;
    (c) the VAE and the
    discriminator at their default configs, through a saved pipeline, on a
    45 s mel, and on 1 s of it against the CPU. Each part's launches are
    counted from 0."""
    import copy

    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.models import VAE, Discriminator, DiscriminatorConfig, VAEConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.ops.kernels.common import no_tf32
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.utils import config_from_dict, load_json
    others = tuple(name for name, *_ in KERNEL_INFO
                   if name not in ("mss2d_block_loss", "mss2d_block_loss_grad"))

    # ---- (a) the m1 DAE ----------------------------------------------------
    m1_dir = root / "m1"
    dae_training_path(m1_dir, steps=0)
    base = json.loads((m1_dir / "dae_train_config.json").read_text())
    mtc = {k: v for k, v in base["module_trainer_config"].items() if k != "use_fused_mss2d"}
    m1 = {**base, "module_trainer_config": {**mtc, "domain": "mdct", "use_fused_mss2d": True,
                                            "mss1d_prime_loss_weight": 1.0,
                                            "phase_invariance_loss_weight": 1.0},
          "optimizer": {"optimizer": "normuon"}, "profile_steps": [1, 2],
          "emas": {"std0.05": {"std": 0.05}, "host_std0.05": {"std": 0.05, "cpu_offload": True}}}
    fmt = MSMDCTDualFormat(config_from_dict(
        MSMDCTDualFormatConfig, load_json(REPO / "configs" / "models" / "edm2_default"
                                          / "format.json") or {}))
    print(f"(a) m1 DAE training on {smi}: trainer config {m1['module_trainer_config']}, "
          f"optimizer normuon, EMAs {m1['emas']}, profile_steps {m1['profile_steps']}",
          flush=True)
    found = {}

    def after_m1(trainer, saved):
        trace = m1_dir / "profiles" / "dae_steps_1-2.trace.json"
        expect("profiler trace of step 1", trace.is_file() and trace.stat().st_size > 0,
               f"{trace.name} {trace.stat().st_size if trace.is_file() else 0} bytes")
        host, dev = trainer.host_ema["host_std0.05"], trainer.state.ema_state["std0.05"]
        err = max(float((host[k] - dev[k].float().cpu()).abs().max()) for k in dev)
        scale = max(float(dev[k].abs().max()) for k in dev)
        expect("host-memory profile against the device profile of the same std",
               err <= 1e-5 * scale, f"max abs diff {err:.3g} (max |w| {scale:.3g}, tol 1e-5 "
               f"x max) after {trainer.state.global_step} steps")
        ms, nbytes = host_ema_copy_ms(trainer)
        found["copy"] = (ms, nbytes)
        found["times"] = timed_steps(trainer)
        found["batch"] = next(iter(trainer.dataloader.epoch_iter(trainer.epoch, 0)))

    reset_counts()
    stats = run_training(m1_dir, m1_dir / "audio", m1, "cuda", after=after_m1)
    c = path_counts("m1 DAE training", ("mss2d_block_loss", "mss2d_block_loss_grad"),
                    absent=others, only_routes=(("mss2d_block_loss", "fft"),
                                                ("mss2d_block_loss_grad", "fft")))
    print(f"  m1 launches: K5 {c['mss2d_block_loss']}, K6 {c['mss2d_block_loss_grad']}; no other "
          f"kernel of K1-K7", flush=True)
    m1_mss2d_check(found.pop("batch"), fmt)
    ms, nbytes = found["copy"]
    times = found["times"]
    print(f"  m1 on {smi}: step {stats['step_s']:.4f} s after the first, peak "
          f"{stats['peak_gib']:.2f} GiB; host-EMA hand-over (pack + copy to pinned memory) "
          f"{np.median(ms):.3f} ms median of {[round(x, 3) for x in ms]} for "
          f"{nbytes / 1e6:.1f} MB ({nbytes / np.median(ms) / 1e6:.2f} GB/s); step with the "
          f"offload {[round(x, 4) for x in times[True]]} s, without "
          f"{[round(x, 4) for x in times[False]]} s (median {np.median(times[True]):.4f} "
          f"against {np.median(times[False]):.4f})", flush=True)
    torch.cuda.empty_cache()

    # ---- (b) the p1 DAE ----------------------------------------------------
    p1_dir = root / "p1"
    dae_training_path(p1_dir, steps=0)
    p1 = {**base, "module_trainer_config": {**mtc, "use_random_prime_mss": True,
                                            "equivariance_loss_weight": 0.1},
          "optimizer": {"optimizer": "muon"}}
    print(f"(b) p1 DAE training on {smi}: trainer config {p1['module_trainer_config']}, "
          f"optimizer muon", flush=True)

    def after_p1(trainer, saved):
        found["opt"] = optimizer_step_ms(trainer.state.module)

    reset_counts()
    stats = run_training(p1_dir, p1_dir / "audio", p1, "cuda", after=after_p1)
    path_counts("p1 DAE training", (), absent=tuple(name for name, *_ in KERNEL_INFO))
    opt_ms, n_muon = found["opt"]
    print(f"  p1 on {smi}: step {stats['step_s']:.4f} s after the first, peak "
          f"{stats['peak_gib']:.2f} GiB; one optimizer update of the 102M-param DAE: Muon "
          f"({n_muon} weights by NS5, AdamW the rest) {[round(x, 2) for x in opt_ms['muon']]} ms, "
          f"AdamW {[round(x, 2) for x in opt_ms['adamw']]} ms (median "
          f"{np.median(opt_ms['muon']):.2f} against {np.median(opt_ms['adamw']):.2f})",
          flush=True)
    torch.cuda.empty_cache()

    # ---- (c) the VAE and the discriminator at their default configs -------
    reset_counts()
    fcfg = fmt.config
    vcfg, dcfg = VAEConfig(), DiscriminatorConfig()
    g = torch.Generator(device="cuda").manual_seed(11)
    vae = VAE(vcfg, device="cuda").init_weights(g)
    disc = Discriminator(dcfg, device="cuda").init_weights(g)
    d = root / "vae_disc"
    Pipeline({"vae": ModuleHandle("vae", "vae", vcfg, vae),
              "disc": ModuleHandle("disc", "disc", dcfg, disc)}).save_pretrained(d)
    pipe = Pipeline.from_pretrained(d)
    for name, module in (("vae", vae), ("disc", disc)):
        loaded = pipe.modules[name].module.state_dict().values()
        same = all(torch.equal(a, b) for a, b in zip(module.state_dict().values(), loaded))
        expect(f"{name} through save_pretrained / from_pretrained", same,
               f"{sum(p.numel() for p in module.parameters()) / 1e6:.2f}M params equal")
    vae, disc = pipe.modules["vae"].module, pipe.modules["disc"].module
    raw = fmt.get_raw_crop_width()          # the format's 45 s
    audio = torch.randn((1, 2, raw), generator=g, device="cuda") * 0.1
    with torch.no_grad():
        mel = fmt.raw_to_mel_spec(audio)
        mel = mel[:, :, : mel.shape[2] // 8 * 8].contiguous()
        vemb = vae.get_embeddings(torch.randn((1, vcfg.label_dim), generator=g, device="cuda"))
        demb = disc.get_embeddings(torch.randn((1, dcfg.in_channels_emb), generator=g,
                                               device="cuda"))
        folded = mel.permute(0, 3, 1, 2)[..., None].contiguous()

        def run_vae(x):
            return vae(x, vemb, training=False)

        def run_disc(x):
            return disc(x, demb)
        for name, fn, x in (("VAE encode + decode", run_vae, mel),
                            ("discriminator", run_disc, folded)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: fn(x), 3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"  (c) {name} on a 45 s mel {tuple(x.shape)} on {smi}: {ms:.2f} ms a forward, "
                  f"peak {peak:.2f} GiB", flush=True)
        one = mel[:, :, :128]
        with no_tf32():
            cuda_out = [t.float().cpu() for t in (*run_vae(one)[:2], *run_disc(
                one.permute(0, 3, 1, 2)[..., None].contiguous()))]
        cvae, cdisc = copy.deepcopy(vae).cpu(), copy.deepcopy(disc).cpu()
        vl, vr, _ = cvae(one.cpu(), vemb.cpu(), training=False)
        dl, dk = cdisc(one.cpu().permute(0, 3, 1, 2)[..., None].contiguous(), demb.cpu())
    for name, got, want in zip(("VAE latents", "VAE recon", "disc logits", "disc hidden kld"),
                               cuda_out, (vl, vr, dl, dk)):
        rel = float((got - want).norm() / want.norm())
        expect(f"{name} at 1 s, card (TF32 off) against CPU", rel <= 1e-4,
               f"rel L2 {rel:.3g} (tol 1e-4)")
    path_counts("VAE and discriminator", (), absent=tuple(name for name, *_ in KERNEL_INFO))


def factory_song(seed: int, seconds: float, sample_rate: int = 32000):
    """A stereo song from a seed: a few chords with vibrato, a pulse and a
    little noise, the channels at different gains."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    sig = np.zeros_like(t)
    for _ in range(5):
        f0 = rng.uniform(60.0, 3000.0)
        vibrato = rng.uniform(0.3, 3.0) * np.sin(2 * np.pi * rng.uniform(0.2, 4.0) * t)
        sig += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f0 * t + vibrato)
    sig *= 0.6 + 0.4 * (np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * t) > 0)
    sig += 0.05 * rng.standard_normal(t.size)
    audio = np.stack([sig * rng.uniform(0.5, 1.0), sig * rng.uniform(0.5, 1.0)])
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)


def dataset_cli(process: str, data: Path, *args: str, device: str = "cuda") -> tuple:
    """``python -m dualdiffusion_tpu_torch.dataset_process`` in a subprocess
    (no CLAP weights and no network: CLAP_* unset, the hub offline):
    (seconds, its log)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("CLAP_")}
    env.update(HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    cmd = [sys.executable, "-m", "dualdiffusion_tpu_torch.dataset_process", process,
           "--dataset_path", str(data), *args]
    if process == "encode":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", flush=True)
        raise AssertionError(f"dataset_process {process} exited with {proc.returncode}")
    return seconds, proc.stdout + proc.stderr


def encode_log(log: str) -> dict:
    """The encode worker's report: per song its stage seconds, chunks and
    shape, the seconds from its spawn to its model loaded, its peak device
    memory and its kernel launch counts, all as it logged them."""
    import re
    songs = {m.group(1): json.loads(m.group(2))
             for m in re.finditer(r"encoded (.+?): (\{.*\})$", log, re.M)}
    ready = re.search(r"EncodeStage:0 ready ([0-9.]+) s after spawn", log)
    worker = re.search(r"encode worker on (\S+): peak device memory (\d+) bytes; kernel "
                       r"launches (\{.*\})$", log, re.M)
    if not (songs and ready and worker):
        print(log[-6000:], flush=True)
        raise AssertionError("the encode worker's report is missing from its log")
    return {"songs": songs, "ready_s": float(ready.group(1)), "device": worker.group(1),
            "peak_bytes": int(worker.group(2)), "launches": json.loads(worker.group(3))}


def tiny_encode_slice(root: Path) -> None:
    """The encode CLI on a tiny model (32-filter mel, bf16 DAE of ratio 4) and
    two 1.5 s songs, with ``--device cuda`` and with ``--device cpu`` at the
    same time: the float16 latents agree to the bf16 bound (relative
    L2)."""
    import shutil

    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, MSMDCTDualFormatConfig
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.utils import load_safetensors, save_audio
    fcfg = MSMDCTDualFormatConfig(ms_num_filters=32, ms_window_length=256, mdct_window_len=64,
                                  default_raw_length=63 * 32)
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8,
                     in_num_freqs=32)
    model = root / "tiny_model"
    Pipeline({"dae": ModuleHandle("dae", "dae", dcfg,
                                  DAE(dcfg).init_weights(torch.Generator().manual_seed(3))),
              "format": ModuleHandle("format", "format:ms_mdct_dual", fcfg,
                                     MSMDCTDualFormat(fcfg))}).save_pretrained(model)
    for i in range(2):
        save_audio(factory_song(40 + i, 1.5), 32000, root / "tiny_a" / f"song{i}.wav")
    shutil.copytree(root / "tiny_a", root / "tiny_b")
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:     # both at once: each is mostly its start-up
        runs = {data: pool.submit(dataset_cli, "encode", root / data, "--model_path",
                                  str(model), device=dev)
                for data, dev in (("tiny_a", "cuda"), ("tiny_b", "cpu"))}
        secs = {data: run.result()[0] for data, run in runs.items()}
    errs = []
    for i in range(2):
        got = load_safetensors(root / "tiny_a" / "latents" / f"song{i}.safetensors")["latents"]
        want = load_safetensors(root / "tiny_b" / "latents" / f"song{i}.safetensors")["latents"]
        if got.shape != want.shape or got.dtype != np.float16:
            raise AssertionError(f"tiny encode: {got.shape} {got.dtype} against {want.shape}")
        g, w = got.astype(np.float32), want.astype(np.float32)
        errs.append(float(np.linalg.norm(g - w) / np.linalg.norm(w)))
    expect(f"tiny encode CLI, --device cuda against --device cpu (2 songs of 1.5 s, "
           f"latents {got.shape} float16; {secs['tiny_a']:.2f} s and {secs['tiny_b']:.2f} s)",
           max(errs) <= FACTORY_BF16_REL_L2,
           f"relative L2 {[round(e, 6) for e in errs]} <= {FACTORY_BF16_REL_L2}")


def dataset_factory_path(root: Path, smi: str) -> None:
    """The dataset factory at full width, then the UNet trained on what it
    made: four stereo 32 kHz songs from a seed (two of 45 s and two of
    180 s, two sharing a file name in two folders); ``python -m
    dualdiffusion_tpu_torch.create_new_model`` writes edm2_default from a
    seed; the dataset CLI normalizes them, encodes them with its DAE in a
    spawned worker (8 variations, 180 s songs in chunks of 6144 mel frames)
    and checks their integrity; seeded CLAP-like audio embeddings are added
    to each latents file (no CLAP weights exist here); build_splits and
    aggregate_embeddings (copied into the model) follow; the UNet trains 4
    steps then 1 after ``--resume`` on those latents with edm2_default's
    unet_train.json (cut: device batch 2 for the 4 songs, accumulation 2);
    the trained pipeline generates one clip from a label of the aggregated
    table. Holds every latents file's shape and finiteness, the sidecars,
    train.jsonl, the two same-named songs' two files, the 180 s songs' chunk
    count, one 180 s variation tiled against untiled (away from the seams
    and over all columns) and against the file, and no kernel launch in the
    encode worker; then the tiny CLI slice on the card against the CPU."""
    import numpy as np
    import torch
    from dualdiffusion_tpu_torch.dataset import processes as P
    from dualdiffusion_tpu_torch.models import tiled_encode, tiled_encode_plan
    from dualdiffusion_tpu_torch.models.embeddings import mp_normalize
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline, load_module
    from dualdiffusion_tpu_torch.sampling import SampleParams
    from dualdiffusion_tpu_torch.utils import (load_audio, load_json, load_safetensors,
                                               save_audio, save_safetensors)
    t_phase = time.perf_counter()
    songs = FACTORY_SONGS
    data, name = root / "data", "edm2_default"
    t0 = time.perf_counter()
    for i, (rel, seconds) in enumerate(songs):
        save_audio(factory_song(30 + i, seconds), 32000, data / rel)
    print(f"dataset factory: {len(songs)} stereo 32 kHz songs "
          f"{[(rel, s) for rel, s in songs]} written in {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.create_new_model", "--name",
                    name, "--config_path", str(REPO / "configs" / "models"), "--output_path",
                    str(root), "--seed", "7", "--device", "cuda"], check=True, cwd=REPO)
    model_dir = root / name
    print(f"create_new_model {name} on cuda: {time.perf_counter() - t0:.2f} s", flush=True)

    wall = {"normalize": dataset_cli("normalize", data)[0]}
    wall["encode"], log = dataset_cli("encode", data, "--model_path", str(model_dir))
    wall["integrity_check"] = dataset_cli("integrity_check", data)[0]
    report = encode_log(log)

    # ---- what the encode wrote ------------------------------------------------
    _, fcfg, fmt = load_module(model_dir, "format", "cuda")
    dcfg = load_json(model_dir / "dae" / "dae.json")
    ds = 2 ** (len(dcfg["channel_mult_dec"]) - 1)
    hop = fcfg.ms_hop_length
    max_off = 8 * hop * 3 // 4          # 4 time offsets of the EncodeConfig defaults
    want_files, audio_s = {}, 0.0
    print(f"  {'song':<26} {'s':>4} {'W':>5} {'chunks':>6} {'encode s':>9} {'audio s/s':>10} "
          f"{'load s':>7} {'mel s':>7} {'dae s':>7} {'save s':>7}", flush=True)
    for rel, seconds in songs:
        path = data / rel
        n = load_audio(path).shape[-1]
        frames = fmt._get_num_mel_frames(n - max_off) // ds * ds
        width = frames // ds
        meta = P.read_sidecar(str(path))
        lat_rel = str(Path("latents") / Path(rel).with_suffix(".safetensors"))
        lat = load_safetensors(data / lat_rel)["latents"]
        stats = report["songs"][str(path)]
        chunks = len(tiled_encode_plan(frames, ds))
        ok = (lat.shape == (8, dcfg["latent_channels"], fcfg.ms_num_filters // ds, width)
              and lat.dtype == np.float16 and bool(np.isfinite(lat).all())
              and meta.get("latents_file_name") == lat_rel
              and meta.get("latents_length") == width
              and meta.get("latents_num_variations") == 8
              and meta.get("post_norm_lufs") == -20.0 and stats["chunks"] == chunks)
        expect(f"{rel}: latents {lat.shape} {lat.dtype}, sidecar, {stats['chunks']} chunks", ok,
               f"want (8, {dcfg['latent_channels']}, {fcfg.ms_num_filters // ds}, {width}) "
               f"float16 finite at {lat_rel}, {chunks} chunks")
        want_files[rel] = data / lat_rel
        audio_s += stats["audio_s"]
        print(f"  {rel:<26} {seconds:>4} {width:>5} {stats['chunks']:>6} "
              f"{stats['encode_s']:>9.3f} {stats['audio_s'] / stats['encode_s']:>10.2f} "
              f"{stats['load_s']:>7.3f} {stats['mel_s']:>7.3f} {stats['dae_s']:>7.3f} "
              f"{stats['save_s']:>7.3f}", flush=True)
    same = [want_files[rel] for rel, _ in songs if Path(rel).name == "01 - Title.wav"]
    expect("two songs named '01 - Title.wav' in two folders", len(same) == 2
           and same[0] != same[1] and all(p.is_file() for p in same),
           f"two latents files {[str(p.relative_to(data)) for p in same]}")
    long_song = max(songs, key=lambda s: s[1])[0]
    expect(f"{long_song}: chunks", report["songs"][str(data / long_song)]["chunks"] == 4,
           "4 chunks of at most 6144 mel frames")
    expect("kernel launches in the encode worker", not any(report["launches"].values()),
           json.dumps(report["launches"]))
    print(f"  encode CLI {wall['encode']:.2f} s for {audio_s:.1f} s of audio: "
          f"{audio_s / wall['encode']:.2f} audio s per wall s (stage only: "
          f"{audio_s / sum(s['encode_s'] for s in report['songs'].values()):.2f}); the worker "
          f"on {report['device']} ready {report['ready_s']:.2f} s after spawn, its peak device "
          f"memory {report['peak_bytes'] / 2 ** 30:.2f} GiB; normalize {wall['normalize']:.2f} "
          f"s, integrity_check {wall['integrity_check']:.2f} s; {smi}", flush=True)

    # ---- one long variation tiled against untiled, on the device ----------------
    _, _, dae = load_module(model_dir, "dae", "cuda")
    audio = load_audio(data / long_song)
    x = torch.from_numpy(audio[:, : audio.shape[-1] - max_off]).to("cuda")[None]
    with torch.inference_mode():
        mel = fmt.raw_to_mel_spec(x)
        mel = mel[:, :, : mel.shape[2] // ds * ds]
        tiled = tiled_encode(dae, mel)
        untiled = dae.encode(mel)
    stored = torch.from_numpy(load_safetensors(want_files[long_song])["latents"][0]).float()
    tiled, untiled = tiled.cpu()[0].permute(2, 0, 1), untiled.float().cpu()[0].permute(2, 0, 1)
    plan = tiled_encode_plan(mel.shape[2], ds)
    keep = torch.ones(tiled.shape[-1], dtype=torch.bool)
    margin = 256 // ds
    for *_, d0, _ in plan[1:]:
        keep[max(d0 - margin, 0): d0 + margin] = False
    err = float((tiled[..., keep] - untiled[..., keep]).norm() / untiled[..., keep].norm())
    err_all = float((tiled - untiled).norm() / untiled.norm())
    err_file = float((tiled.half().float() - stored).norm() / stored.norm())
    expect(f"{long_song} variation 0 tiled ({len(plan)} chunks) against untiled, "
           f"{int(keep.sum())} of {keep.numel()} latent columns away from the seams (+-{margin})",
           err <= FACTORY_BF16_REL_L2,
           f"relative L2 {err:.6f} <= {FACTORY_BF16_REL_L2}")
    expect(f"{long_song} variation 0 tiled against untiled, all {keep.numel()} latent columns",
           err_all <= FACTORY_BF16_REL_L2, f"relative L2 {err_all:.6f} <= {FACTORY_BF16_REL_L2}")
    expect(f"{long_song} variation 0: the stored file against the tiled encode here",
           err_file <= FACTORY_BF16_REL_L2, f"relative L2 {err_file:.6f}")
    del dae, mel, x
    torch.cuda.empty_cache()

    # ---- embeddings, splits, the prompt table --------------------------------
    rng = np.random.default_rng(50)
    for rel, seconds in songs:
        lat_path = want_files[rel]
        tensors = load_safetensors(lat_path)
        tensors["clap_audio_embeddings"] = mp_normalize(
            rng.standard_normal((max(int(seconds // 10), 1), 1024)).astype(np.float32))
        save_safetensors(tensors, lat_path)
        P.write_sidecar(str(data / rel), {"latents_has_audio_embeddings": True})
    print("  no CLAP weights on this machine: seeded clap_audio_embeddings (chunks, 1024), "
          "mp-normalized, added to each latents file and flagged in its sidecar", flush=True)
    wall["build_splits"] = dataset_cli("build_splits", data)[0]
    wall["aggregate_embeddings"] = dataset_cli("aggregate_embeddings", data,
                                               "--copy_to_model_path", str(model_dir))[0]
    records = [json.loads(line) for line in (data / "train.jsonl").read_text().splitlines()]
    expect("train.jsonl", sorted(r["latents_file_name"] for r in records)
           == sorted(str(p.relative_to(data)) for p in want_files.values())
           and all(r["latents_has_audio_embeddings"] and r["post_norm_lufs"] == -20.0
                   for r in records), f"{len(records)} records, one a song")
    table = load_safetensors(model_dir / "dataset_embeddings.safetensors")
    expect("the aggregated table in the model", set(table) == {
        "_unconditional_audio", "gameA_audio", "gameB_audio"}, f"keys {sorted(table)}")
    print(f"  build_splits {wall['build_splits']:.2f} s, aggregate_embeddings "
          f"{wall['aggregate_embeddings']:.2f} s", flush=True)

    # ---- the UNet trains on the factory's latents --------------------------------
    tjson = load_json(REPO / "configs" / "models" / name / "unet_train.json")
    crop = 688
    config = {**tjson, "device_batch_size": 2, "gradient_accumulation_steps": TRAIN_ACCUM,
              "dataloader": {"latents_crop_width": crop}}
    print(f"UNet training on the factory's latents: {name}'s unet_train.json; cut: device "
          f"batch 2 (the config's 8) for the {len(songs)} songs, accumulation {TRAIN_ACCUM} "
          f"(the config's {tjson['gradient_accumulation_steps']}); crop {crop} latent columns; "
          f"{TRAIN_STEPS} steps then --resume for 1", flush=True)
    train = run_training(model_dir, data, config, "cuda")

    # ---- the trained pipeline generates from the aggregated table -------------------
    pipe = Pipeline.from_pretrained(model_dir, device="cuda", load_checkpoints=True)
    emb = pipe.get_prompt_embedding({"gameB": 1.0})
    uncond = pipe.get_prompt_embedding({})
    steps = 10
    t0 = time.perf_counter()
    raw = pipe.generate(SampleParams(steps=steps, seed=3), prompt_embedding=emb)["raw"]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    expect(f"generate from the table's 'gameB' ({steps} steps, DDEC decode)",
           emb is not None and not torch.allclose(emb, uncond)
           and bool(torch.isfinite(raw).all()) and raw.shape[:2] == (1, 2),
           f"audio {tuple(raw.shape)} finite in {gen_s:.2f} s")
    del pipe, raw
    torch.cuda.empty_cache()

    tiny_encode_slice(root)
    print(f"dataset factory summary ({smi}): encode wall s per song "
          f"{ {rel: round(report['songs'][str(data / rel)]['encode_s'], 3) for rel, _ in songs} }; "
          f"{audio_s / wall['encode']:.2f} audio s per encode CLI s; worker ready "
          f"{report['ready_s']:.2f} s after spawn; worker peak "
          f"{report['peak_bytes'] / 2 ** 30:.2f} GiB; UNet step {train['step_s']:.4f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the rest of the model surface: the 3-D UNet, the formats, the harnesses
# ---------------------------------------------------------------------------

#: the 3-D UNet's level 1 under "full" attention: Z x H x W = 2 x 16 x 344
#: positions of a 45 s clip's latents, twice ref_scale_full_attn's
FLASH3D_L = 2 * 16 * 344
#: the stereo-folded latent sample of a 45 s clip: (B, Z, H, W, C)
UNET3D_SHAPE = (1, 2, 32, 688, 4)
#: relative L2 bounds of a format's card against its CPU run: the linear
#: transforms (bases and FFTs in fp32) and those with a power or a mel after
#: the FFT (tests/test_torch_formats_more.py holds the same bounds on JAX)
FORMAT_REL_L2 = {"linear": 1e-5, "mel": 1e-4}


def unet_3d_config(**overrides):
    """The reference-scale UNet (bench.py:68-92: 256 ch x (1,2,3,4,5), 2
    layers a block, mlp x2 in 8 groups, 1,024-d embeddings) with the d1
    options of tests/test_reference_parity.py:1264-1273 (stereo-folded 3-D
    convs, stereo-wrapped io convs without bias, W reflect padding, a skip
    conv in every block, the constant and ln-freq channels, a double
    midblock with attention) and "full" attention at levels 1, 3 and 4."""
    import dataclasses
    kw = dict(use_3d=True, io_kernel_z=2, conv_w_pad="reflect", io_bias=False,
              always_skip=True, add_constant_channel=True, add_ln_freqs_channel=True,
              double_midblock=True, midblock_attn=True, attn_axis="full", attn_levels=(1, 3, 4))
    kw.update(overrides)
    return dataclasses.replace(ref_scale_configs()[0], **kw)


def kernel_phase_flash_3d(gen) -> None:
    """K7 at the 3-D UNet's level 1 (B 2 under CFG, 8 heads, L 11,008, D
    64, bf16) against its plain version, one batch element at a time (the
    fp32 scores of all 16 batch-heads at once would take 7.8 GB), all 8
    heads of each: 2e-2 of max |o|, as at L 5504."""
    import torch
    import torch.nn.functional as F
    from dualdiffusion_tpu_torch.ops.kernels import flash_attention, flash_attention_plain
    b, h, d = 2, 8, FLASH_D
    q, k, v = attention_inputs(gen, b, FLASH3D_L, h, d)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    for i in range(b):
        check_close(f"K7 at the 3-D level 1: batch element {i}, H {h} L {FLASH3D_L} D {d}",
                    got[i:i + 1], flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1]),
                    2e-2)
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = b * time_ms(lambda: flash_attention_plain(q[:1], k[:1], v[:1]), 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4 * b * h * visible_pairs(FLASH3D_L, None, False) * d
    bound_ms, by = bound(flops, 4 * b * h * FLASH3D_L * d * 2, "bf16")
    print(f"    K7 at L {FLASH3D_L}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP), "
          f"{ms / bound_ms:.2f}x", flush=True)


def unet_3d_path(gen, prompt, path_counts, smi: str) -> None:
    """The stereo-folded 3-D UNet at full width: 50 Heun steps at CFG 1.5
    through ``edm_sample`` on a (1, 2, 32, 688, 4) sample ("full" attention:
    K7 at level 1, 7 calls a forward; every conv is 5-D, on cuDNN, so K1
    never launches), then the UNet's train step on 5-D latents with "freq"
    attention at levels 3-4 and dropout 0.1 (device batch 8 x accumulation
    2, AdamW, one EMA), 5 steps, the first a warm-up."""
    import torch
    from dualdiffusion_tpu_torch.models import UNet
    from dualdiffusion_tpu_torch.ops.kernels import reset_launch_counts
    from dualdiffusion_tpu_torch.sampling import SampleParams, edm_sample
    from dualdiffusion_tpu_torch.training import (EMABank, EMAConfig, SigmaSamplerConfig,
                                                  UNetTrainConfig, build_optimizer,
                                                  init_train_state, make_unet_train_step)
    cfg = unet_3d_config()
    unet = UNet(cfg, device="cuda").init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"3-D UNet: {n_params / 1e6:.1f}M params, sample {UNET3D_SHAPE}, attention "
          f"{cfg.attn_axis!r} at levels {cfg.attn_levels} (level 1 L {FLASH3D_L}); {smi}",
          flush=True)
    params = SampleParams(steps=OPTIONS_STEPS, cfg_scale=1.5, use_heun=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        emb = unet.get_embeddings(prompt.expand(2, -1),
                                  torch.tensor([1.0, 0.0], device="cuda"))
        out = edm_sample(lambda x, s: unet(x, s, emb), UNET3D_SHAPE, params, cfg.sigma_max,
                         cfg.sigma_min, cfg.sigma_data,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    c = path_counts("3-D UNet sampling", ("flash_attention",),
                    absent=("grouped_conv3x3", "grouped_conv3x3_wgrad"))
    forwards = 2 * OPTIONS_STEPS
    expect(f"3-D UNet sampling: {OPTIONS_STEPS} Heun steps at CFG {params.cfg_scale} in "
           f"{secs:.3f} s ({secs / forwards * 1e3:.2f} ms a forward), peak memory {peak:.2f} "
           f"GiB, output {tuple(out.shape)} std {out.float().std().item():.4f}",
           tuple(out.shape) == UNET3D_SHAPE and bool(torch.isfinite(out).all())
           and c["flash_attention"] == 7 * forwards,
           f"finite; K7 {c['flash_attention']} = 7 x {forwards} forwards, K1 0")
    # where a forward's time goes: its kernels' device time (under the
    # profiler) against the host clock of the same forwards without it
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        x = torch.randn((2,) + UNET3D_SHAPE[1:], device="cuda")
        sigma = torch.ones((2,), device="cuda")
        unet(x, sigma, emb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            unet(x, sigma, emb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                unet(x, sigma, emb)
            torch.cuda.synchronize()
    print_device_time(prof, "3-D UNet, 3 forwards at batch 2 (CFG)", wall,
                      "on the host clock without the profiler", top=8)
    del unet, emb, out, x
    torch.cuda.empty_cache()

    tcfg = unet_3d_config(attn_axis="freq", attn_levels=(3, 4), dropout=0.1)
    model = UNet(tcfg, device="cuda").init_weights(gen)
    opt = build_optimizer("adamw", model.parameters(), 1e-4)
    bank = EMABank([EMAConfig(name="std0.05", std=0.05)])
    tc = UNetTrainConfig(sigma=SigmaSamplerConfig(), grad_accum_steps=TRAIN_ACCUM)
    n = TRAIN_BATCH * TRAIN_ACCUM
    step = make_unet_train_step(opt, bank, tc, n)
    state = init_train_state(model, opt, bank, tc.sigma,
                             torch.Generator(device="cuda").manual_seed(5))
    data = torch.Generator(device="cuda").manual_seed(6)
    batch = {"samples": torch.randn((n,) + UNET3D_SHAPE[1:], generator=data, device="cuda"),
             "embeddings": torch.randn((n, tcfg.in_channels_emb), generator=data,
                                       device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    path_counts("3-D UNet training", (), absent=tuple(name for name, *_ in KERNEL_INFO))
    expect(f"3-D UNet training (attention 'freq' at levels 3-4, dropout {tcfg.dropout}): "
           f"device batch {TRAIN_BATCH} x accumulation {TRAIN_ACCUM} of {UNET3D_SHAPE[1:]}, "
           f"{TRAIN_STEPS + 1} steps, s a step {[round(s, 4) for s in secs]} (after the first: "
           f"{sum(secs[1:]) / TRAIN_STEPS:.4f}), peak memory {peak:.2f} GiB",
           all(math.isfinite(x) for x in losses), f"losses {[round(x, 5) for x in losses]}")
    del model, opt, bank, state, batch
    torch.cuda.empty_cache()


def format_round_trip(name: str, fmt):
    """(forward, inverse, kind) of a format's round trip: its sample pair,
    or the MDCT pair where its sample is a mel."""
    if name in ("ms_mdct_dual", "ms_mdct_dual_v1", "mdct_psd"):
        return fmt.raw_to_mdct, fmt.mdct_to_raw, "linear"
    return fmt.raw_to_sample, fmt.sample_to_raw, "mel" if name == "spectrogram" else "linear"


def formats_path(root: Path, path_counts, smi: str) -> None:
    """Every registered format at its default config on a seeded 45 s, 32 kHz
    stereo song: the round trip (seconds and the relative L2 error against
    the input; the spectrogram's inverse is Griffin-Lim, through K2/K3), and
    1 s of it on the card against the CPU (the forward, and the inverse of
    the linear ones, within FORMAT_REL_L2); then a model_index.json naming
    ms_mdct_dual_v1 loads through ``from_pretrained``."""
    import torch
    from dualdiffusion_tpu_torch.models.formats import get_format_class
    from dualdiffusion_tpu_torch.models.formats.format import _FORMAT_REGISTRY
    from dualdiffusion_tpu_torch.ops.kernels import reset_launch_counts
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    song = factory_song(60, 45.0)
    print(f"formats: {sorted(_FORMAT_REGISTRY)} on a seeded 45 s stereo song; {smi}", flush=True)
    reset_launch_counts()

    def rel_l2(a, b) -> float:
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).norm() / b.norm())

    for name in sorted(_FORMAT_REGISTRY):
        cls, cfg_cls = get_format_class(name)
        fmt = cls(cfg_cls())
        fwd, inv, kind = format_round_trip(name, fmt)
        x = torch.from_numpy(song[None]).cuda()
        x = x[..., : fmt.get_raw_crop_width(x.shape[-1])]
        with torch.no_grad():
            fwd(x)                       # a warm-up: cuFFT plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = fwd(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            back = inv(s)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m = min(back.shape[-1], x.shape[-1])
            err = rel_l2(back[..., :m], x[..., :m])
            one = x[..., :32000]
            cs, gs = fwd(one.cpu()), fwd(one)
            errs = [rel_l2(gs, cs)]
            if kind == "linear":
                errs.append(rel_l2(inv(gs), inv(cs)))
        tol = FORMAT_REL_L2[kind]
        expect(f"{name}: {tuple(x.shape)} -> {tuple(s.shape)} in {t1 - t0:.4f} s, back "
               f"{tuple(back.shape)} in {t2 - t1:.4f} s, round-trip relative L2 {err:.3g}",
               bool(torch.isfinite(back).all()) and max(errs) <= tol,
               f"1 s card against CPU relative L2 {[float(f'{e:.3g}') for e in errs]} <= {tol:g}")
    path_counts("formats", ("fgla_frame", "ola_reframe"), absent=("grouped_conv3x3",
                                                                 "flash_attention"))
    cfg_cls = get_format_class("ms_mdct_dual_v1")[1]
    cfg = cfg_cls()
    Pipeline({"format": ModuleHandle("format", "format:ms_mdct_dual_v1", cfg,
                                     get_format_class("ms_mdct_dual_v1")[0](cfg))}
             ).save_pretrained(root / "v1_model")
    loaded = Pipeline.from_pretrained(root / "v1_model", device="cuda").format
    expect("from_pretrained of a model_index.json naming format:ms_mdct_dual_v1",
           type(loaded).__name__ == "MSMDCTDualV1Format" and loaded.config == cfg,
           type(loaded).__name__)


def harness(name: str, *args: str, cwd: Path) -> tuple:
    """``python -m dualdiffusion_tpu_torch.scripts.<name>`` on the card in a
    subprocess: (wall seconds, its output, the kernel launches it printed)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"dualdiffusion_tpu_torch.scripts.{name}",
                           *args], cwd=cwd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", flush=True)
        raise AssertionError(f"harness {name} exited with {proc.returncode}")
    line = [l for l in proc.stdout.splitlines() if l.startswith("kernel launches: ")]
    if not line:
        raise AssertionError(f"harness {name} printed no kernel launches")
    return secs, proc.stdout, json.loads(line[-1].split(": ", 1)[1])


def harness_path(root: Path, smi: str) -> Path:
    """The four component harnesses as subprocesses on the card, all five
    runs at once (each is mostly its start-up; its wall seconds are taken
    beside the others): ``create_new_model`` writes edm2_default and
    edm2_dae_d3a (spectrogram) from seeds; ``unet_test`` on edm2_default
    with configs/tests/unet_test.json (20 steps, CFG 1.5, seeds 4000 and
    4001 at 45 s, the DDEC under "auto"); ``format_test`` with
    configs/tests/format_test.json (the spectrogram, 64 Griffin-Lim
    iterations: K2/K3); ``dae_test`` on both models; ``sigma_sampler_test``.
    The files each one writes are checked. Returns the edm2_dae_d3a
    directory."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()

    def create(name: str, seed: int) -> None:
        subprocess.run([sys.executable, "-m", "dualdiffusion_tpu_torch.create_new_model",
                        "--name", name, "--config_path", str(REPO / "configs" / "models"),
                        "--output_path", str(root), "--seed", str(seed), "--device", "cuda"],
                       check=True, cwd=REPO, capture_output=True)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(create, ("edm2_default", "edm2_dae_d3a"), (7, 8)))
    print(f"harnesses: create_new_model edm2_default and edm2_dae_d3a on cuda (together) "
          f"{time.perf_counter() - t0:.2f} s; {smi}", flush=True)
    default, d3a = root / "edm2_default", root / "edm2_dae_d3a"
    (root / "format").mkdir()
    tests = REPO / "configs" / "tests"
    runs = {
        "unet_test on edm2_default (2 clips of 45 s, 20 steps, the DDEC)":
            ("unet_test", ("--model_path", str(default), "--config",
                           str(tests / "unet_test.json")), root),
        "format_test (the spectrogram, 4 s, 64 Griffin-Lim iterations)":
            ("format_test", ("--config", str(tests / "format_test.json")), root / "format"),
        **{f"dae_test on {m.name}": ("dae_test", ("--model_path", str(m), "--output_path",
                                                  str(root / f"dae_{m.name}")), root)
           for m in (default, d3a)},
        "sigma_sampler_test": ("sigma_sampler_test", (), root)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {what: pool.submit(harness, name, *args, cwd=cwd)
                   for what, (name, args, cwd) in runs.items()}
        done = {what: f.result() for what, f in futures.items()}
    print(f"  the five harness runs together: {time.perf_counter() - t0:.2f} s", flush=True)

    def files(what: str, paths) -> dict:
        secs, out, launches = done[what]
        print("\n".join("  " + l for l in out.splitlines()
                        if l.startswith(("s4", "avg", "mel (")) or "MSE" in l), flush=True)
        missing = [str(p) for p in paths if not (p.is_file() and p.stat().st_size > 0)]
        expect(f"{what}: {secs:.2f} s wall; kernel launches {json.dumps(launches)}",
               not missing, f"{len(paths)} files written" + (f", missing {missing}"
                                                             if missing else ""))
        return launches

    step_dir = default / "output" / "step_0"
    audio = [p for s in (4000, 4001) for p in (step_dir / f"s{s}.flac", step_dir / f"s{s}.wav")
             if p.is_file()]
    what = next(iter(runs))
    files(what, audio[:1] + [step_dir / f"s{s}{suffix}" for s in (4000, 4001)
                             for suffix in ("_mel.png", "_latents.png", ".json")])
    if len(audio) != 2:
        raise AssertionError(f"unet_test: audio files {audio}")
    launches = files("format_test (the spectrogram, 4 s, 64 Griffin-Lim iterations)",
                     [root / "format" / "format_test_out" / n
                      for n in ("input.wav", "recon.wav", "sample.png")])
    if not (launches["fgla_frame"] > 0 and launches["ola_reframe"] > 0):
        raise AssertionError(f"format_test launched no K2/K3: {launches}")
    for m in (default, d3a):
        files(f"dae_test on {m.name}", [root / f"dae_{m.name}" / n for n in (
            "input.wav", "recon.wav", "mel.png", "mel_recon.png", "latents_pca.png")])
    secs, out, _ = done["sigma_sampler_test"]
    dists = [l.split(":")[0] for l in out.splitlines() if "median" in l]
    expect(f"sigma_sampler_test: {secs:.2f} s wall", len(dists) == 6, f"distributions {dists}")
    return d3a


def spectrogram_encode_path(root: Path, model_dir: Path, smi: str) -> None:
    """``python -m dualdiffusion_tpu_torch.dataset_process encode`` with the
    spectrogram-format edm2_dae_d3a on two seeded 45 s songs (the
    EncodeConfig defaults: 8 variations), alone on the card; the latents'
    shape and the worker's report."""
    import numpy as np
    from dualdiffusion_tpu_torch.utils import load_safetensors, save_audio
    data = root / "spec_data"
    for i in range(2):
        save_audio(factory_song(80 + i, 45.0), 32000, data / f"song{i}.wav")
    wall, log = dataset_cli("encode", data, "--model_path", str(model_dir))
    report = encode_log(log)
    audio_s = sum(s["audio_s"] for s in report["songs"].values())
    stage_s = sum(s["encode_s"] for s in report["songs"].values())
    shapes = []
    for i in range(2):
        lat = load_safetensors(data / "latents" / f"song{i}.safetensors")["latents"]
        shapes.append(lat.shape)
        if not (lat.dtype == np.float16 and np.isfinite(lat).all() and lat.shape[0] == 8):
            raise AssertionError(f"spectrogram encode: latents {lat.shape} {lat.dtype}")
    expect(f"spectrogram encode (edm2_dae_d3a, 2 songs of 45 s): latents {shapes}; "
           f"{audio_s / stage_s:.2f} audio s per encode-stage s, {audio_s / wall:.2f} per CLI s "
           f"({wall:.2f} s); the worker ready {report['ready_s']:.2f} s after spawn, peak device "
           f"memory {report['peak_bytes'] / 2 ** 30:.2f} GiB; {smi}",
           not any(report["launches"].values()), f"no kernel launch in the worker "
           f"{json.dumps(report['launches'])}")


def model_surface_paths(gen, prompt, path_counts, smi: str) -> None:
    """K7 at the 3-D level 1, then the 3-D UNet, the formats, the harnesses
    and the spectrogram encode, each timed."""
    import torch
    kernel_phase_flash_3d(gen)
    for what, run in (("3-D UNet", lambda tmp: unet_3d_path(gen, prompt, path_counts, smi)),
                      ("formats", lambda tmp: formats_path(tmp, path_counts, smi)),
                      ("harness and spectrogram encode",
                       lambda tmp: spectrogram_encode_path(tmp, harness_path(tmp, smi), smi))):
        with tempfile.TemporaryDirectory(prefix="dd_smoke_surface_") as tmp:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            run(Path(tmp))
            print(f"{what} phase: {time.perf_counter() - t0:.2f} s", flush=True)


#: kernel groups of the profile, by substrings of the kernel's name (first match)
PROFILE_GROUPS = [
    ("K5/K6 (port)", ("mss2d", "sum_partials")),
    ("cuDNN convolutions", ("cudnn", "xmma_fprop", "xmma_dgrad", "xmma_wgrad", "implicit_gemm",
                            "conv")),
    ("cuFFT", ("fft",)),
    ("GEMM", ("gemm", "cutlass")),
    ("reductions", ("reduce",)),
    ("copies", ("copy", "memcpy", "memset", "fill", "cat")),
    ("elementwise", ("elementwise",)),
]


def profile_dae_step(model_dir: Path) -> None:
    """``--profile``: one full-width DAE train step (the DAE training path's
    model, data and config) under ``torch.profiler`` after two warm-up
    steps: the step's wall seconds, the device time its kernels took, and
    the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dualdiffusion_tpu_torch import train
    dae_training_path(model_dir, steps=0)
    config = model_dir / "dae_train_config.json"
    argv = ["--model_path", str(model_dir), "--train_config_path", str(config),
            "--dataset_path", str(model_dir / "audio"), "--device", "cuda"]
    trainer = train.build_trainer(train.parse_args(argv))
    trainer.config.model_path = ""               # no checkpoint inside the window
    trainer.train(max_steps=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(max_steps=3)
        torch.cuda.synchronize()
    print_device_time(prof, "profiled DAE step", trainer.history[-1]["seconds"],
                      "on the trainer's clock")


def print_device_time(prof, what: str, wall_s: float, clock: str, top: int = 15) -> None:
    """The device time of a ``torch.profiler`` window's kernels against its
    wall seconds, by kernel group (PROFILE_GROUPS) and for the ``top``
    kernels with the most device time."""
    from torch.autograd import DeviceType
    # the kernels themselves (the operator rows above them repeat their time)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"{what}: {wall_s:.4f} s {clock}; kernels {device_ms:.1f} ms of device time in "
          f"{launches} launches ({device_ms / 1e3 / wall_s:.1%} of it)", flush=True)
    groups = {}
    for e in rows:
        name = e.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group}: {ms:.1f} ms in {n} launches ({ms / device_ms:.1%})", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:100]}",
              flush=True)



# ---------------------------------------------------------------------------
# the parallel phase: ranks of torch.distributed.run
# ---------------------------------------------------------------------------

PARALLEL_LR = 3e-3       # the UNet training path's rate (TrainerConfig's default, no warm-up)
PARALLEL_MODES = ("fsdp", "dp")     # (a): FSDP, then plain data parallelism
RESUMED_MODE = "fsdp"    # (a): the run that also resumes for a step
TO_STEPS = 25            # (d): sampler steps of the clip with the DAE on the CPU
GLOO_RANKS = 2           # (b): data-parallel ranks on the one card
GLOO_BATCH = 4           # (b): each rank's device batch, x TRAIN_ACCUM: half of 8 x 2


def torchrun(nproc: int, *args: str, timeout: float = 600) -> str:
    """``python -m torch.distributed.run --standalone`` of this script with
    ``args`` on ``nproc`` ranks; a rank that exits non-zero fails the phase.
    Returns the ranks' standard output."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DD_SMOKE_LAUNCHED=str(time.time()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(nproc), str(REPO / "chip_smoke.py"), *args],
                          env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-6000:], sep="\n", flush=True)
        raise AssertionError(f"torch.distributed.run {args[0]} exited {proc.returncode}")
    print(f"  torch.distributed.run {' '.join(args[:2])} on {nproc} rank(s): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return proc.stdout


def parallel_train_rank(root: Path) -> None:
    """The rank of (a), in one process for both runs: the UNet training
    path's run through the train entry on ``root / mode`` with
    ``parallel.fsdp`` for "fsdp" and without for "dp", 4 steps (then 1 after
    ``--resume`` for ``RESUMED_MODE``); each writes its first step
    (its parameters in ``first.safetensors``, its loss and grad norm in
    ``result.json`` with the losses, steps, step seconds, peak memory and
    kernel launches)."""
    import gc
    import numpy as np
    import torch
    from dualdiffusion_tpu_torch import train
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualdiffusion_tpu_torch.parallel import is_main_process, shutdown
    from dualdiffusion_tpu_torch.utils import save_safetensors

    def since_launch(what: str) -> None:
        print(f"  (a) rank: {what} {time.time() - float(os.environ['DD_SMOKE_LAUNCHED']):.1f} s "
              f"after the launch", flush=True)

    since_launch("imports done")
    for mode in PARALLEL_MODES:
        model_dir = root / mode
        hwc = json.loads((model_dir / "latent_shape.json").read_text())["hwc"]
        config = dict(unet_train_config(hwc[1]), parallel={"fsdp": mode == "fsdp"})
        path = model_dir / "train_config.json"
        path.write_text(json.dumps(config))
        argv = ["--model_path", str(model_dir), "--train_config_path", str(path),
                "--dataset_path", str(root / "latents")]
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        first: dict = {}
        marks = [("start", time.perf_counter())]
        trainer = train.build_trainer(train.parse_args(argv + ["--max_steps", str(TRAIN_STEPS)]))
        capture_first_step(trainer, first)
        marks.append(("build", time.perf_counter()))
        trainer.train(max_steps=TRAIN_STEPS)
        marks.append((f"{TRAIN_STEPS} steps + checkpoint", time.perf_counter()))
        history = list(trainer.history)
        steps = TRAIN_STEPS + (mode == RESUMED_MODE)
        del trainer
        if mode == RESUMED_MODE:
            trainer = train.build_trainer(train.parse_args(argv + ["--resume", "--max_steps",
                                                                   str(steps)]))
            marks.append(("build + resume", time.perf_counter()))
            trainer.train(max_steps=steps)
            marks.append(("1 step + checkpoint", time.perf_counter()))
            history += trainer.history
            if trainer.state.global_step != steps:
                raise AssertionError(f"ended at step {trainer.state.global_step}")
            del trainer
        print(f"  (a) {mode} rank seconds: " + ", ".join(
            f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:])), flush=True)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if is_main_process():
            save_safetensors(first["params"], model_dir / "first.safetensors")
            (model_dir / "result.json").write_text(json.dumps({
                "first": {k: first[k] for k in ("loss", "grad_norm")},
                "losses": [h["loss"] for h in history], "counts": counts, "peak_gib": peak,
                "steps": steps,
                "step_s": float(np.mean([h["seconds"] for h in history[1:TRAIN_STEPS]]))}))
        since_launch(f"{mode} written")
        del first
        gc.collect()
        torch.cuda.empty_cache()
    shutdown()
    since_launch("group shut down")


def gloo_inputs(model_dir: Path):
    """(b)'s global batch of 16 latents and its draws, from seed 11: the
    quantiles and two global microbatches of 8."""
    import torch
    from dualdiffusion_tpu_torch.training import SigmaSampler, UNetTrainConfig
    from dualdiffusion_tpu_torch.training.train_state import draw_unet_step
    cfg = json.loads((model_dir / "unet" / "unet.json").read_text())
    data = json.loads((model_dir / "latent_shape.json").read_text())
    n = GLOO_RANKS * GLOO_BATCH * TRAIN_ACCUM
    gen = torch.Generator().manual_seed(11)
    batch = {"samples": torch.randn((n,) + tuple(data["hwc"]), generator=gen),
             "embeddings": torch.randn((n, cfg["in_channels_emb"]), generator=gen)}
    tc = UNetTrainConfig(grad_accum_steps=TRAIN_ACCUM)
    draws = draw_unet_step(gen, SigmaSampler(tc.sigma), tc, n,
                           (n // TRAIN_ACCUM,) + tuple(data["hwc"]), True, 0)
    return batch, draws, tc


def gloo_step(model_dir: Path, batch, draws, tc, data=None):
    """One UNet train step of the reference-scale UNet (AdamW, no EMA) on
    cuda:0; returns (whole gradient after the clip, grad norm, seconds)."""
    import torch
    from dualdiffusion_tpu_torch.parallel.collectives import Axis
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline
    from dualdiffusion_tpu_torch.training import (build_optimizer, init_train_state,
                                                  make_unet_train_step)
    model = Pipeline.from_pretrained(model_dir, device="cuda:0").modules["unet"].module
    opt = build_optimizer("adamw", model.parameters(), PARALLEL_LR)
    opt.axis = data
    n = batch["samples"].shape[0] * (data.size if data else 1)
    step = make_unet_train_step(opt, None, tc, n, data=data)
    state = init_train_state(model, opt, None, tc.sigma, torch.Generator(device="cuda:0"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = step(state, {k: v.to("cuda:0") for k, v in batch.items()}, draws.to("cuda:0"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grad = torch.cat([p.grad.reshape(-1) for p in opt.params])
    return grad, float(logs["grad_norm"]), seconds


def parallel_gloo_rank(model_dir: Path) -> None:
    """One rank of (b): gloo on cuda:0, the rank's share of the global batch
    through the data-parallel step; rank 0 writes the averaged gradient."""
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualdiffusion_tpu_torch.parallel import (MeshConfig, ParallelState, make_mesh,
                                                  maybe_initialize_distributed, shard_batch,
                                                  shutdown)
    maybe_initialize_distributed(device="cuda", backend="gloo", local_device_ids=[0])
    parallel = ParallelState(make_mesh(MeshConfig(), device_type="cpu"))
    batch, draws, tc = gloo_inputs(model_dir)
    local = shard_batch(parallel.mesh, batch, TRAIN_ACCUM, device="cpu")
    reset_launch_counts()
    grad, norm, seconds = gloo_step(model_dir, local, draws, tc, parallel.data)
    if parallel.data.rank == 0:
        torch.save({"grad": grad.cpu(), "grad_norm": norm, "seconds": seconds,
                    "counts": launch_counts()}, model_dir / "gloo_dp.pt")
    shutdown()


def tp_shard_conv_check(conv_shapes, groups: int, gen) -> None:
    """(c) K1 at the tensor-parallel shard's shapes: each grouped conv of a
    UNet forward with ``groups / 2`` of its groups (half the input and
    output channels), against the plain version, timed per forward."""
    import torch
    from dualdiffusion_tpu_torch.ops.kernels import (grouped_conv3x3, grouped_conv3x3_plain,
                                                     prepare_weights)
    g = groups // 2
    counts = {s: conv_shapes.count(s) for s in dict.fromkeys(conv_shapes)}
    print(f"(c) K1 at the tensor-parallel shard (model axis 2): {g} of {groups} groups, half "
          f"the channels, {len(conv_shapes)} convs per UNet forward (batch 2)", flush=True)
    ms = plain_ms = 0.0
    for (b, h, w, cin, cout), n in counts.items():
        x = torch.randn((b, h, w, cin // 2), generator=gen, device="cuda").bfloat16()
        wgt = torch.randn((cout // 2, cin // groups, 3, 3), generator=gen, device="cuda")
        wt = prepare_weights(wgt / (9 * cin // groups) ** 0.5, g)
        got = grouped_conv3x3(x, wt, g)
        torch.cuda.synchronize()
        route = conv_route(cin // groups, cout // groups, x, wt, got)
        check_close(f"({b},{h},{w},{cin // 2}->{cout // 2}) {g} groups x{n} [{route}]", got,
                    grouped_conv3x3_plain(x, wt, g), 2 ** -7)
        ms += n * time_ms(lambda: grouped_conv3x3(x, wt, g))
        plain_ms += n * time_ms(lambda: grouped_conv3x3_plain(x, wt, g))
    print(f"  per UNet forward at the shard: kernel {ms:.3f} ms, plain fp32 {plain_ms:.3f} ms",
          flush=True)


def parallel_path(root: Path, plain_first: dict, plain_stats: dict, counts: dict,
                  conv_shapes, groups: int, fmt, prompt, path_counts, reset_counts,
                  smi: str) -> None:
    """Step 15 on the pristine reference-scale model in ``root / "model"``
    and the UNet training path's latents in ``root / "latents"``; the
    ranks' launch counts join ``counts``."""
    import torch
    from dualdiffusion_tpu_torch.parallel.collectives import Axis
    from dualdiffusion_tpu_torch.pipelines.pipeline import Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams
    from dualdiffusion_tpu_torch.training import StepDraws
    from dualdiffusion_tpu_torch.utils import load_safetensors
    print(f"parallel phase ({smi})", flush=True)
    unet_counts = counts["UNet training"]
    plain = ([plain_first["loss"]], [plain_first["grad_norm"]], plain_first["params"], {})
    print(f"(a) UNet training under a process group of one over NCCL, one rank running "
          f"FSDP (over one rank the weights stay whole), then plain data parallelism: "
          f"{TRAIN_STEPS} steps each, then --resume for 1 under {RESUMED_MODE}", flush=True)
    for mode in PARALLEL_MODES:
        shutil.copytree(root / "model", root / mode)
    out = torchrun(1, "--parallel-train", str(root))
    print("\n".join(line for line in out.splitlines() if line.startswith("  (a)")), flush=True)
    for mode in PARALLEL_MODES:
        mdir = root / mode
        res = json.loads((mdir / "result.json").read_text())
        first = res["first"]
        params = load_safetensors(mdir / "first.safetensors")
        check_train_agreement(f"  step 1 under {mode} against the plain trainer", {
            "cpu": plain, "cuda": ([first["loss"]], [first["grad_norm"]], params, {})},
            PARALLEL_LR, names=(f"under {mode}", "the plain trainer"))
        for k in ("grouped_conv3x3", "grouped_conv3x3_wgrad"):
            # the UNet training path runs TRAIN_STEPS + 1 steps
            want = unet_counts[k] * res["steps"] // (TRAIN_STEPS + 1)
            expect(f"{k} launches under {mode}", res["counts"][k] == want > 0,
                   f"{res['counts'][k]} in {res['steps']} steps (the UNet training path's "
                   f"{unet_counts[k]} in {TRAIN_STEPS + 1})")
        counts[f"parallel {mode}, world 1"] = res["counts"]
        print(f"  losses {[round(x, 5) for x in res['losses']]}; step {res['step_s']:.4f} s, "
              f"peak memory {res['peak_gib']:.2f} GiB; the plain trainer: step "
              f"{plain_stats['step_s']:.4f} s, peak {plain_stats['peak_gib']:.2f} GiB ({smi})",
              flush=True)
        if mode == "fsdp":
            got = Pipeline.from_pretrained(mdir, device="cuda", load_checkpoints=True
                                           ).modules["unet"].module.state_dict()
            want = Pipeline.from_pretrained(root / "model", device="cpu"
                                            ).modules["unet"].module.state_dict()
            ok = (all(got[k].shape == v.shape for k, v in want.items())
                  and all(bool(torch.isfinite(v).all()) for v in got.values())
                  and any(not torch.equal(got[k].cpu(), v) for k, v in want.items()))
            expect("the FSDP checkpoint in a single-device pipeline", ok,
                   f"unet_checkpoint-{TRAIN_STEPS + 1}: whole shapes, finite, trained")
            del got, want
        shutil.rmtree(mdir)
        torch.cuda.empty_cache()

    # (b) two data-parallel ranks on the one card over gloo
    n = GLOO_RANKS * GLOO_BATCH * TRAIN_ACCUM
    print(f"(b) {GLOO_RANKS} data-parallel ranks on one card over gloo: device batch "
          f"{GLOO_BATCH} x accumulation {TRAIN_ACCUM} each, a global batch of {n}; one process "
          f"steps the same batch as {GLOO_RANKS * TRAIN_ACCUM} microbatches of {GLOO_BATCH}, "
          f"each a rank's microbatch (same rows, same kernels: the bf16 roundings match)",
          flush=True)
    torchrun(GLOO_RANKS, "--parallel-gloo", str(root / "model"))
    dp = torch.load(root / "model" / "gloo_dp.pt", weights_only=False)
    counts["parallel gloo, rank 0 of 2"] = dp["counts"]
    batch, draws, tc = gloo_inputs(root / "model")
    # microbatch 2i + r of one process = rank r's microbatch i
    one = StepDraws(draws.quantiles, [m.share(Axis(None, r, GLOO_RANKS))
                                      for m in draws.micro for r in range(GLOO_RANKS)])
    one_tc = type(tc)(grad_accum_steps=GLOO_RANKS * TRAIN_ACCUM)
    grad, norm, seconds = gloo_step(root / "model", batch, one, one_tc)
    rel = float((dp["grad"].cuda() - grad).norm() / grad.norm())
    expect("averaged gradient against one process's", rel <= 1e-4,
           f"relative L2 {rel:.3g} (tol 1e-4); grad norm {dp['grad_norm']:.6g} vs {norm:.6g}")
    print(f"  step seconds: {dp['seconds']:.3f} on each of {GLOO_RANKS} gloo ranks sharing the "
          f"card, {seconds:.3f} on one process; correctness only, they measure no speed "
          f"({smi})", flush=True)
    del grad, dp
    torch.cuda.empty_cache()

    # (c) K1 at the tensor-parallel shard's shapes
    tp_shard_conv_check(conv_shapes, groups, torch.Generator(device="cuda").manual_seed(4))

    # (d) Pipeline.to: the UNet on the card, the DAE on the CPU, whose decode
    # of a 45 s clip takes ~40 s there: img2img at strength 0.5 from seeded
    # audio of an eighth of the length, 25 steps (the DAE encodes and decodes
    # on the CPU, the UNet samples on the card)
    pipe = Pipeline.from_pretrained(root / "model", device="cuda").to(device_map={"dae": "cpu"})
    length = fmt.get_raw_crop_width() // 8
    params = SampleParams(steps=TO_STEPS, cfg_scale=1.5, use_heun=True, length=length,
                          num_fgla_iters=100, fgla_phase_init="spsi", img2img_strength=0.5)
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[0])
    audio = 0.1 * torch.randn((2, fmt.get_raw_crop_width(length)), generator=gen, device="cuda")
    reset_counts()
    timings: dict = {}
    out = pipe.generate(params, gen, prompt_embedding=prompt, input_audio=audio,
                        timings=timings)
    raw = out["raw"]
    ok = (tuple(raw.shape) == (1, 2, fmt.get_raw_crop_width(length)) and raw.is_cuda
          and bool(torch.isfinite(raw).all()) and float(raw.float().square().mean()) > 0
          and set(timings) >= {"encode", "sampler", "dae_decode"})
    expect("(d) Pipeline.to(device_map={'dae': 'cpu'}) img2img", ok,
           f"audio {tuple(raw.shape)} on {raw.device}; stages " +
           ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
    path_counts("Pipeline.to", ("grouped_conv3x3", "fgla_frame", "ola_reframe"),
                absent=("flash_attention",))
    del pipe, out, raw
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "dualdiffusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--parallel-train"]:
        parallel_train_rank(Path(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--parallel-gloo"]:
        parallel_gloo_rank(Path(sys.argv[2]))
        return 0
    from dualdiffusion_tpu_torch.models import DAE, UNet
    from dualdiffusion_tpu_torch.models.formats import MSMDCTDualFormat, SpectrogramFormat
    from dualdiffusion_tpu_torch.ops.kernels import (launch_counts, reset_launch_counts,
                                                     route_counts)
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = library()
    print(f"kernel build: {lib.build_seconds:.2f} s nvcc ({time.perf_counter() - t0:.2f} s "
          f"with load) -> {lib.path.name}", flush=True)
    print("\n".join(l for l in lib.log.splitlines() if l.startswith("nvcc seconds")), flush=True)
    if sys.argv[1:] == ["--profile"]:
        with tempfile.TemporaryDirectory(prefix="dd_profile_") as tmp:
            profile_dae_step(Path(tmp))
        print(smi)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    ucfg, dcfg, fcfg = ref_scale_configs()
    fmt = SpectrogramFormat(fcfg)
    unet = UNet(ucfg, device="cuda").init_weights(gen)
    dae = DAE(dcfg, device="cuda").init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)      # as bench.py: a zero out_gain mutes the trunk
    mel_shape = fmt.get_sample_shape(1)
    lat_shape = dae.get_latent_shape(mel_shape)
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"ref-scale UNet {n_params / 1e6:.1f}M params; mel {mel_shape}; latents {lat_shape}",
          flush=True)

    # ---- kernel phases and tiny slices, each once -------------------------
    measured = {"grouped_conv3x3": kernel_phase_conv(unet, ucfg.mlp_groups, lat_shape[1],
                                                     lat_shape[2], gen)}
    # inputs from a generator of their own, so the later phases' draws stay as they were
    seamless_conv_check(unet, lat_shape[1], lat_shape[2],
                        torch.Generator(device="cuda").manual_seed(2))
    conv_shapes = grouped_conv_shapes(unet, 2, lat_shape[1], lat_shape[2])
    k1_per_forward = len(conv_shapes)
    measured.update(kernel_phase_fgla(fmt, gen))
    measured.update(kernel_phase_ola(fmt, gen))
    slice_phase()
    slice_phase("ms_mdct_dual")
    ddec_slice_phase()
    options_slice_phase()
    measured["grouped_conv3x3_wgrad"] = kernel_phase_conv_backward(
        unet, ucfg.mlp_groups, lat_shape[1], lat_shape[2], gen)
    train_slice_phase()
    measured.update(kernel_phase_mss2d(gen))
    dae_train_slice_phase()
    ddec_train_slice_phase()
    measured["flash_attention"] = kernel_phase_flash(gen)
    flash_crossover(gen)
    slice_phase("full")

    src = Pipeline({"unet": ModuleHandle("unet", "unet", ucfg, unet),
                    "dae": ModuleHandle("dae", "dae", dcfg, dae),
                    "format": ModuleHandle("format", "format:spectrogram", fcfg, fmt)})
    full_cfg = full_attention_config()
    full_unet = UNet(full_cfg, device="cuda").init_weights(gen)
    with torch.no_grad():
        full_unet.core.out_gain.fill_(1.0)
    full_src = Pipeline({"unet": ModuleHandle("unet", "unet", full_cfg, full_unet),
                         "dae": ModuleHandle("dae", "dae", dcfg, dae),
                         "format": ModuleHandle("format", "format:spectrogram", fcfg, fmt)})
    ddec_cfg, mfcfg = ddec_configs()
    mfmt = MSMDCTDualFormat(mfcfg)
    ddec = UNet(ddec_cfg, device="cuda").init_weights(gen)
    with torch.no_grad():
        ddec.core.out_gain.fill_(1.0)
    ddec_src = Pipeline({"unet": ModuleHandle("unet", "unet", ucfg, unet),
                         "dae": ModuleHandle("dae", "dae", dcfg, dae),
                         "ddec": ModuleHandle("ddec", "ddec", ddec_cfg, ddec),
                         "format": ModuleHandle("format", "format:ms_mdct_dual", mfcfg, mfmt)})
    prompt = torch.randn((1, 1024), generator=gen, device="cuda")
    prompt = prompt / prompt.norm(dim=-1, keepdim=True)
    counts = {}

    def path_counts(name: str, kernels, absent=(), only_routes=()) -> dict:
        """The path's launch counts; every kernel of ``kernels`` launched, none
        of ``absent``, and every call of (wrapper, route) in ``only_routes``
        on that route."""
        counts[name] = launch_counts()
        routes = route_counts()
        print(f"kernel launches on the {name} path: {counts[name]}; calls per route: {routes}",
              flush=True)
        for k in kernels:
            if counts[name][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {name} path")
        for k in absent:
            if counts[name][k] != 0:
                raise AssertionError(f"kernel {k} was launched on the {name} path")
        for k, route in only_routes:
            if sum(routes[k].values()) != routes[k][route]:
                raise AssertionError(f"{k} took another route than {route} on the {name} path: "
                                     f"{routes[k]}")
        return counts[name]

    with tempfile.TemporaryDirectory(prefix="dd_smoke_") as tmp:
        full_dir = Path(tmp) / "ref_scale_full_attn"
        ddec_dir = Path(tmp) / "ref_scale_ddec"
        options_dir = Path(tmp) / "ref_scale_options"
        t0 = time.perf_counter()
        src.save_pretrained(tmp)
        src.save_pretrained(options_dir)
        full_src.save_pretrained(full_dir)
        ddec_src.save_pretrained(ddec_dir)
        print(f"save_pretrained (four pipelines): {time.perf_counter() - t0:.2f} s", flush=True)
        del src, unet, dae, full_src, full_unet, ddec_src, ddec
        torch.cuda.empty_cache()
        torch.cuda.synchronize()

        # ---- serving path: from_pretrained -> generate x2 ------------------
        reset_launch_counts()
        print(f"serving: FGLA n_fft {fcfg.padded_length}, K2 {fgla_route(fcfg.padded_length)} "
              f"route, K3 {ola_route(fcfg.padded_length, fcfg.hop_length)} route", flush=True)
        first_clip = serving_path(tmp, fmt, prompt)[1]
        path_counts("serving", ("grouped_conv3x3", "fgla_frame", "ola_reframe"),
                    absent=("flash_attention",), only_routes=(("ola_reframe", "hopper"),))

        # ---- the same with full attention at levels 1, 3, 4 ---------------
        print(f"ref_scale_full_attn: attn_axis {full_cfg.attn_axis!r}, attn_levels "
              f"{full_cfg.attn_levels}; level 1 sees L = {(lat_shape[1] >> 1) * (lat_shape[2] >> 1)}",
              flush=True)
        torch.cuda.empty_cache()
        reset_launch_counts()
        serving_path(full_dir, fmt, prompt, steps=CUT_SERVING_STEPS)
        path_counts("full-attention serving", ("flash_attention", "grouped_conv3x3", "fgla_frame",
                                               "ola_reframe"),
                    only_routes=(("ola_reframe", "hopper"),))

        # ---- DDEC serving: the same latent stage on the MS-MDCT dual format,
        # decoded by the diffusion decoder under decode_mode="auto" -----------
        torch.cuda.empty_cache()
        mdct_shape = mfmt.get_mdct_shape_for_mel_frames(1, mfmt.get_sample_shape(1)[2])
        print(f"DDEC serving: {ddec_cfg.model_channels} ch x {ddec_cfg.channel_mult}, "
              f"{ddec_cfg.num_layers_per_block} layers a block, mlp x{ddec_cfg.mlp_multiplier} "
              f"(groups {ddec_cfg.mlp_groups}), PSD {ddec_cfg.in_psd_freqs} rows; mel "
              f"{mfmt.get_sample_shape(1)}, MDCT {mdct_shape}", flush=True)
        reset_launch_counts()
        ddec_pipe, _, ddec_totals = serving_path(ddec_dir, mfmt, prompt, decode_mode="auto",
                                                 steps=CUT_SERVING_STEPS)
        path_counts("DDEC serving", ("grouped_conv3x3",),
                    absent=("fgla_frame", "ola_reframe", "flash_attention"))
        ddec_forward(ddec_pipe.modules["ddec"].module, ddec_cfg, mdct_shape, gen)
        del ddec_pipe

        # ---- generation options: img2img, inpainting, the seamless loop,
        # the chunked preview and the sample CLI, at full width --------------
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        generation_options_path(options_dir, ddec_dir, fmt, mfmt, prompt, first_clip,
                                k1_per_forward, smi)
        print(f"generation options phase: {time.perf_counter() - t0:.2f} s", flush=True)
        path_counts("generation options", ("grouped_conv3x3", "fgla_frame", "ola_reframe"),
                    absent=("flash_attention",))
        del first_clip

        # ---- web UI serving: create_new_model, the model server in its own
        # process and the UI's requests over HTTP; then one request through an
        # in-process ModelServer, whose kernel launches this process counts ----
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        webui_dir, body = web_ui_serving_path(Path(tmp) / "webui", ucfg, dcfg,
                                              mfmt.get_raw_crop_width(), ddec_totals, smi)
        print(f"web UI serving phase: {time.perf_counter() - t0:.2f} s", flush=True)
        n_fft = mfcfg.ms_window_length
        print(f"counted request (decode_mode 'fgla'): FGLA n_fft {n_fft}, K2 {fgla_route(n_fft)} "
              f"route, K3 {ola_route(n_fft, 256)} route", flush=True)
        torch.cuda.empty_cache()
        reset_launch_counts()
        serving_launch_count(webui_dir, body, mfmt.get_raw_crop_width())
        c = path_counts("web UI serving", ("grouped_conv3x3", "fgla_frame", "ola_reframe"),
                        absent=("flash_attention",), only_routes=(("ola_reframe", "hopper"),))
        want = 2 * CUT_SERVING_STEPS * k1_per_forward
        if c["grouped_conv3x3"] != want or fgla_route(n_fft) != "hopper":
            raise AssertionError(f"web UI serving: {c['grouped_conv3x3']} K1 launches (want "
                                 f"{want}), K2 route {fgla_route(n_fft)}")
        print(f"  K1 launches {c['grouped_conv3x3']} = {CUT_SERVING_STEPS} steps x 2 forwards x "
              f"{k1_per_forward} ok", flush=True)

        # ---- UNet training path: train 4 steps, --resume 1 more -------------
        torch.cuda.empty_cache()
        reset_launch_counts()
        plain_first: dict = {}
        plain_stats = unet_training_path(Path(tmp), (ucfg.in_channels,) + lat_shape[1:3],
                                         ucfg.in_channels_emb, "cuda", first=plain_first)
        path_counts("UNet training", ("grouped_conv3x3", "grouped_conv3x3_wgrad"))
        # the pristine model and the latents, for the parallel phase
        par_root = Path(tempfile.mkdtemp(prefix="dd_smoke_parallel_"))
        (par_root / "model").mkdir()
        for name in ("model_index.json", "unet", "dae", "format"):
            copy = shutil.copytree if (Path(tmp) / name).is_dir() else shutil.copy2
            copy(Path(tmp) / name, par_root / "model" / name)
        shutil.copytree(Path(tmp) / "latents", par_root / "latents")
        (par_root / "model" / "latent_shape.json").write_text(json.dumps(
            {"hwc": list(lat_shape[1:3]) + [ucfg.in_channels]}))

    # ---- DAE training path: train 4 steps, --resume 1 more ------------------
    with tempfile.TemporaryDirectory(prefix="dd_smoke_dae_") as tmp:
        torch.cuda.empty_cache()
        reset_launch_counts()
        dae_training_path(Path(tmp))
        per_step = {k: v / (TRAIN_STEPS + 1) for k, v in
                    path_counts("DAE training", ("mss2d_block_loss", "mss2d_block_loss_grad"),
                                only_routes=(("mss2d_block_loss", "fft"),
                                             ("mss2d_block_loss_grad", "fft"))).items()}
        print(f"  launches per DAE train step: K5 {per_step['mss2d_block_loss']:g}, "
              f"K6 {per_step['mss2d_block_loss_grad']:g}", flush=True)

    # ---- the rest of training: the m1 and p1 DAEs, Muon / NorMuon, a host
    # EMA, the profiler; the VAE and the discriminator ------------------------
    with tempfile.TemporaryDirectory(prefix="dd_smoke_rest_") as tmp:
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        rest_of_training_path(Path(tmp), path_counts, reset_launch_counts, smi)
        print(f"rest of training phase: {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- the parallel phase: torch.distributed ranks at full width ----------
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        parallel_path(par_root, plain_first, plain_stats, counts, conv_shapes, ucfg.mlp_groups,
                      fmt, prompt, path_counts, reset_launch_counts, smi)
        print(f"parallel phase: {time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(par_root, ignore_errors=True)
    del plain_first

    # ---- DDEC training, then joint DAE + DDEC training, at full width -------
    no_kernels = tuple(name for name, *_ in KERNEL_INFO)
    with tempfile.TemporaryDirectory(prefix="dd_smoke_ddec_") as tmp:
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        pristine = ddec_training_path(Path(tmp), smi)
        print(f"DDEC training phase: {time.perf_counter() - t0:.2f} s", flush=True)
        path_counts("DDEC training", (), absent=no_kernels)
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        joint_training_path(Path(tmp), pristine, JOINT_BATCH)
        print(f"joint training phase: {time.perf_counter() - t0:.2f} s", flush=True)
        path_counts("joint DAE + DDEC training", (), absent=no_kernels)

    # ---- the dataset factory: audio -> latents on the card -> UNet training ----
    with tempfile.TemporaryDirectory(prefix="dd_smoke_factory_") as tmp:
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        dataset_factory_path(Path(tmp), smi)
        print(f"dataset factory phase: {time.perf_counter() - t0:.2f} s", flush=True)
        path_counts("dataset factory", (), absent=no_kernels)

    # ---- the 3-D UNet, every format, the component harnesses ----------------
    model_surface_paths(gen, prompt, path_counts, smi)

    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": sum(c[name] for c in counts.values()), **measured[name]}
               for name, route, source, replaces in KERNEL_INFO]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
