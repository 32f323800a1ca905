#!/usr/bin/env python3
"""Smoke test of dualdiffusion_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, with no arguments, on one CUDA card:

1. prints the card's name and power limit;
2. builds the port's CUDA kernels from ``dualdiffusion_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version at the main path's
   shapes (the reference-scale UNet's grouped convs at batch 2; one 45 s
   stereo Griffin-Lim iteration; a 5-iteration Griffin-Lim run) and times
   both, then holds a tiny model's whole slice on the card against the
   same model on the CPU;
4. drives the main path: builds the reference-scale pipeline (356M-param
   UNet, 64-ch DAE, 256-bin mel format) from a seed, saves it, loads it with
   ``Pipeline.from_pretrained`` and calls ``generate`` twice (45 s, batch 1,
   CFG 1.5, Heun, SPSI + 100 Griffin-Lim iterations), checking the audio and
   that every kernel was launched.

Any failure raises, so the exit code is not 0. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
The script imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SAMPLER_STEPS = 100
SEEDS = (1, 2)

#: (name, route, source, TPU kernel it replaces)
KERNEL_INFO = [
    ("grouped_conv3x3", "cuda", "dualdiffusion_tpu_torch/csrc/grouped_conv3x3.cu",
     "dualdiffusion_tpu/ops/pallas/grouped_conv.py:120"),
    ("fgla_frame", "cuda", "dualdiffusion_tpu_torch/csrc/fgla_frame.cu",
     "dualdiffusion_tpu/ops/pallas/fgla_iter.py:75"),
    ("ola_reframe", "cuda", "dualdiffusion_tpu_torch/csrc/ola_reframe.cu",
     "dualdiffusion_tpu/ops/pallas/ola_reframe.py:68"),
]


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
    worst, ms, plain_ms, cudnn_ms = 0.0, 0.0, 0.0, 0.0
    for (b, h, w, cin, cout), n in counts.items():
        x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()
        wgt = torch.randn((cout, cin // groups, 3, 3), generator=gen, device="cuda")
        wt = prepare_weights(wgt / (9 * cin // groups) ** 0.5, groups)
        got = grouped_conv3x3(x, wt, groups)
        torch.cuda.synchronize()
        want = grouped_conv3x3_plain(x, wt, groups)
        # bf16 output: one rounding of an fp32 sum taken in another order
        err = check_close(f"({b},{h},{w},{cin}->{cout}) x{n}", got, want, 2 ** -7)
        worst = max(worst, err)
        ms += n * time_ms(lambda: grouped_conv3x3(x, wt, groups))
        plain_ms += n * time_ms(lambda: grouped_conv3x3_plain(x, wt, groups))
        xc = x.permute(0, 3, 1, 2)
        wc = (wgt / (9 * cin // groups) ** 0.5).bfloat16()
        cudnn_ms += n * time_ms(lambda: F.conv2d(xc, wc, padding=1, groups=groups))
    print(f"  per UNet forward: kernel {ms:.3f} ms, plain fp32 {plain_ms:.3f} ms, "
          f"cuDNN bf16 {cudnn_ms:.3f} ms", flush=True)
    return worst, ms, plain_ms


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


def kernel_phase_fgla(fmt, gen):
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
    print(f"K2 fgla_frame / K3 ola_reframe: B={b} C={c} F={f} n_fft={n} hop={hop}", flush=True)
    for wd, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        # tolerances: fp32 -> two transforms' rounding in another order;
        # bf16 -> one rounding of the stored result (bf16 keeps 8 bits)
        spec = mag.to(wd).contiguous()
        merged = mag.mean(1, keepdim=True).expand_as(mag).to(wd).contiguous()
        y = torch.randn((b, c, f, n), generator=gen, device="cuda").mul(0.05).to(wd)
        r_prev = torch.randn((b, c, f, bins, 2), generator=gen, device="cuda").to(wd)
        e3 = check_close(f"K3 {wd}", ola_reframe(y, win, inv_env, hop),
                         ola_reframe_plain(y, win, inv_env, hop), tol)
        frames = ola_reframe_plain(y, win, inv_env, hop)
        r_k, y_k = fgla_frame(frames, r_prev, spec, merged, 0.25, 0.4975, tw)
        r_p, y_p = fgla_frame_plain(frames, r_prev, spec, merged, 0.25, 0.4975)
        e2 = max(check_close(f"K2 spectrum {wd}", r_k, r_p, tol),
                 check_close(f"K2 frames {wd}", y_k, y_p, tol))
        if wd == getattr(torch, cfg.fgla_work_dtype):
            results["ola_reframe"] = (e3, time_ms(lambda: ola_reframe(y, win, inv_env, hop)),
                                      time_ms(lambda: ola_reframe_plain(y, win, inv_env, hop)))
            results["fgla_frame"] = (
                e2, time_ms(lambda: fgla_frame(frames, r_prev, spec, merged, 0.25, 0.4975, tw)),
                time_ms(lambda: fgla_frame_plain(frames, r_prev, spec, merged, 0.25, 0.4975)))
            for k in ("fgla_frame", "ola_reframe"):
                print(f"  {k} {wd}: kernel {results[k][1]:.3f} ms, plain {results[k][2]:.3f} ms",
                      flush=True)

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
    print(f"  griffinlim 5 iters ({cfg.fgla_work_dtype}, {cfg.fgla_phase_init}): kernels vs "
          f"plain loop rel L2 {rel:.4g} (tol 0.05); spectral convergence {ek:.5f} vs "
          f"{ep:.5f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("Griffin-Lim through the kernels disagrees with the plain loop")
    return results


def slice_phase():
    """The whole slice on a tiny model (grouped MLP convs, 64-bin mel): the
    CUDA run (through the kernels) against the CPU run (their plain
    versions), same weights and noise. Both run the UNet and DAE in bf16 and
    round at different places, so latents and mel agree to 5e-2 of max;
    the audio, whose SPSI phases follow mel peaks, is compared through its
    own mel spectrogram (0.2 relative L2)."""
    import copy
    import torch
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats import (SpectrogramFormat,
                                                        SpectrogramFormatConfig)
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams
    ucfg = UNetConfig(in_channels=8, out_channels=8, in_channels_emb=1024, model_channels=32,
                      channel_mult=(1, 2), num_layers_per_block=1, channels_per_head=32,
                      mlp_multiplier=2, mlp_groups=2, attn_levels=(1,))
    dcfg = DAEConfig(model_channels=16, channel_mult_enc=(1, 2, 4), channel_mult_dec=(1, 2, 4),
                     num_enc_layers_per_block=1, num_dec_layers_per_block=1, latent_channels=8)
    fcfg = SpectrogramFormatConfig(window_duration_ms=40, padded_duration_ms=40,
                                   num_frequencies=64, default_raw_length=63 * 256)
    gen = torch.Generator().manual_seed(1)
    unet = UNet(ucfg).init_weights(gen)
    dae = DAE(dcfg).init_weights(gen)
    with torch.no_grad():
        unet.core.out_gain.fill_(1.0)
    fmt = SpectrogramFormat(fcfg)
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
            "format": ModuleHandle("format", "format:spectrogram", fcfg, fmt)})
        out = pipe.generate(params, prompt_embedding=prompt.to(dev), init_noise=init.to(dev),
                            step_noise=[n.to(dev) for n in noise])
        outs[dev] = {k: v.float().cpu() for k, v in out.items()}
        outs[dev]["audio_mel"] = fmt.raw_to_sample(outs[dev]["raw"])
    print("slice on a tiny model, CUDA (kernels) vs CPU (plain versions):", flush=True)
    for key, tol in (("latents", 5e-2), ("sample", 5e-2)):
        check_close(key, outs["cuda"][key], outs["cpu"][key], tol)
    a, b = outs["cuda"]["audio_mel"], outs["cpu"]["audio_mel"]
    rel = ((a - b).norm() / b.norm()).item()
    print(f"  audio's mel spectrogram: rel L2 {rel:.4g} (tol 0.2) {'ok' if rel < 0.2 else 'FAIL'}",
          flush=True)
    if not rel < 0.2:
        raise AssertionError("the slice on the card disagrees with the CPU run")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "dualdiffusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from dualdiffusion_tpu_torch.models import DAE, UNet
    from dualdiffusion_tpu_torch.models.formats import SpectrogramFormat
    from dualdiffusion_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualdiffusion_tpu_torch.ops.kernels.build import library
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.sampling import SampleParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = library()
    print(f"kernel build: {lib.build_seconds:.2f} s nvcc ({time.perf_counter() - t0:.2f} s "
          f"with load) -> {lib.path.name}", flush=True)

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

    # ---- kernel phases ----------------------------------------------------
    conv_err, conv_ms, conv_plain_ms = kernel_phase_conv(unet, ucfg.mlp_groups, lat_shape[1],
                                                         lat_shape[2], gen)
    measured = {"grouped_conv3x3": (conv_err, conv_ms, conv_plain_ms)}
    measured.update(kernel_phase_fgla(fmt, gen))
    slice_phase()

    # ---- main path: save -> from_pretrained -> generate x2 -----------------
    src = Pipeline({"unet": ModuleHandle("unet", "unet", ucfg, unet),
                    "dae": ModuleHandle("dae", "dae", dcfg, dae),
                    "format": ModuleHandle("format", "format:spectrogram", fcfg, fmt)})
    prompt = torch.randn((1, 1024), generator=gen, device="cuda")
    prompt = prompt / prompt.norm(dim=-1, keepdim=True)
    with tempfile.TemporaryDirectory(prefix="dd_smoke_") as tmp:
        t0 = time.perf_counter()
        src.save_pretrained(tmp)
        print(f"save_pretrained: {time.perf_counter() - t0:.2f} s", flush=True)
        del src, unet, dae
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        pipe = Pipeline.from_pretrained(tmp, device="cuda")
        print(f"from_pretrained: {time.perf_counter() - t0:.2f} s", flush=True)
        params = SampleParams(steps=SAMPLER_STEPS, cfg_scale=1.5, use_heun=True,
                              num_fgla_iters=100, fgla_phase_init="spsi")
        outs = []
        for seed in SEEDS:
            torch.cuda.reset_peak_memory_stats()
            timings = {}
            t0 = time.perf_counter()
            out = pipe.generate(params, torch.Generator(device="cuda").manual_seed(seed),
                                prompt_embedding=prompt, decode_mode="fgla", timings=timings)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            raw = out["raw"]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"generate seed {seed}: {params.steps} steps (CFG {params.cfg_scale}, Heun), "
                  f"{params.num_fgla_iters} FGLA iters; "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
                  + f", total {total:.3f} s; peak memory {peak:.2f} GiB", flush=True)
            rms = raw.float().square().mean().sqrt().item()
            if tuple(raw.shape) != (1, 2, fmt.get_raw_crop_width()):
                raise AssertionError(f"audio shape {tuple(raw.shape)}")
            if not torch.isfinite(raw).all() or not rms > 0:
                raise AssertionError(f"audio not finite or silent (rms {rms})")
            print(f"  audio {tuple(raw.shape)} rms {rms:.5f}", flush=True)
            outs.append(raw)
        counts = launch_counts()
    print(f"kernel launches on the main path: {counts}", flush=True)
    if torch.equal(outs[0], outs[1]):
        raise AssertionError("two seeds gave identical audio")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": measured[name][0],
                "ms": measured[name][1], "plain_ms": measured[name][2]}
               for name, route, source, replaces in KERNEL_INFO]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
