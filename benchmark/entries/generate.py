"""The generate entry: a closed loop of one client calling the port's
``Pipeline.generate`` back to back.

A traffic file for this entry holds ``batch`` (clips a request), ``steps``
(Heun steps of each sampler), ``cfg_scale``, ``decode_mode`` ("fgla" or
"auto": the DDEC where the configuration has one) and ``check_rows``
(the clips of the checked request that the reference recomputes, spread
over the batch). Griffin-Lim's iterations and phase init are the
configuration's format's. Each request has a fresh noise seed and a fresh
prompt embedding, drawn from the run's seed and its index.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchmark.common import make_weights, seeds
from benchmark.reference import model as ref_model
from benchmark.reference.serve import ServeReference, compare
from benchmark.yardstick import work

#: the modules of a configuration file, in the order their weights are drawn
MODULES = ("unet", "dae", "ddec")
#: sampler steps in each profiled part
TRACE_STEPS = 2


def weight_shapes(config: dict) -> Dict[str, dict]:
    """name -> shape of each module's parameters, from the reference's
    modules (the benchmark's own description of the models)."""
    out = {"unet": ref_model.parameter_shapes(ref_model.UNet(config["unet"])),
           "dae": ref_model.parameter_shapes(ref_model.DAE(config["dae"]))}
    if "ddec" in config:
        out["ddec"] = ref_model.parameter_shapes(ref_model.UNet(config["ddec"]))
    return out


def weights(config: dict, seed: int, device) -> Dict[str, dict]:
    shapes = weight_shapes(config)
    return {m: make_weights(shapes[m], seeds(seed, 100 + i)[0], device)
            for i, m in enumerate(MODULES) if m in shapes}


def build_pipeline(config: dict, device, seed: int):
    """The port's pipeline of ``config`` on ``device``, its weights made from
    ``seed`` by the benchmark."""
    from dualdiffusion_tpu_torch.models import DAE, DAEConfig, UNet, UNetConfig
    from dualdiffusion_tpu_torch.models.formats.format import get_format_class
    from dualdiffusion_tpu_torch.pipelines.pipeline import ModuleHandle, Pipeline
    from dualdiffusion_tpu_torch.utils import config_from_dict

    fmt_cfg = dict(config["format"])
    fmt_type = fmt_cfg.pop("type")
    fmt_cls, fmt_cfg_cls = get_format_class(fmt_type)
    fcfg = config_from_dict(fmt_cfg_cls, fmt_cfg)
    modules = {"format": ModuleHandle("format", f"format:{fmt_type}", fcfg, fmt_cls(fcfg))}
    made = weights(config, seed, device)
    for name in MODULES:
        if name not in config:
            continue
        cls, cfg_cls = (DAE, DAEConfig) if name == "dae" else (UNet, UNetConfig)
        cfg = config_from_dict(cfg_cls, config[name])
        module = cls(cfg, device=device)
        own = dict(module.named_parameters())
        if {k: tuple(v.shape) for k, v in own.items()} != \
                {k: tuple(v.shape) for k, v in made[name].items()}:
            raise KeyError(f"the port's {name} parameters differ from the configuration's")
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(made[name][k])
        module.eval()
        modules[name] = ModuleHandle(name, name, cfg, module)
    del made
    return Pipeline(modules)


class Session:
    """One run's program: built and warmed up at construction (set-up)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dualdiffusion_tpu_torch.sampling import SampleParams
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.pipe = build_pipeline(config, self.device, seed)
        fmt_cfg = config["format"]
        fgla = {k: fmt_cfg[k] for k in ("num_fgla_iters", "fgla_phase_init") if k in fmt_cfg}
        self.params = SampleParams(steps=traffic["steps"], batch_size=traffic["batch"],
                                   cfg_scale=traffic["cfg_scale"], **fgla)
        fmt = self.pipe.format
        self.mel_shape = tuple(fmt.get_sample_shape(traffic["batch"]))
        self.lat_shape = tuple(self.pipe.modules["dae"].module.get_latent_shape(self.mel_shape))
        self.emb_dim = config["unet"]["in_channels_emb"]
        self.records: List[dict] = []
        self.sync()
        t1 = time.perf_counter()
        # warm-up: one request of two steps at the cell's shapes
        self._generate(10 ** 6 + 1, dict(steps=2))
        self.sync()
        self.setup_parts = {"pipeline_s": t1 - t0, "warmup_s": time.perf_counter() - t1}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def request_inputs(self, i: int):
        noise_seed, emb_seed = seeds(self.seed, 1, i, n=2)
        gen = torch.Generator(device=self.device).manual_seed(emb_seed)
        emb = torch.randn((1, self.emb_dim), generator=gen, device=self.device)
        return noise_seed, emb.expand(self.traffic["batch"], self.emb_dim)

    def _generate(self, i: int, overrides: Optional[dict] = None, **kw) -> dict:
        import dataclasses
        params = dataclasses.replace(self.params, **(overrides or {}))
        noise_seed, emb = self.request_inputs(i)
        gen = torch.Generator(device=self.device).manual_seed(noise_seed)
        out = self.pipe.generate(params, gen, prompt_embedding=emb,
                                 decode_mode=self.traffic["decode_mode"], **kw)
        return dict(out, seed=noise_seed, emb=emb)

    def rows(self) -> List[int]:
        """The checked rows of a request: ``check_rows`` of the batch, spread
        evenly over it."""
        b, k = self.traffic["batch"], self.traffic["check_rows"]
        return sorted({round(j * b / k) for j in range(k)})

    def window(self, seconds: float, timings: bool = False) -> dict:
        """Requests back to back until the first that ends after ``seconds``;
        each ends when its outputs are on the host."""
        rows = self.rows()
        stages: Dict[str, List[float]] = {}
        ends: List[float] = []
        t0 = time.perf_counter()
        i = 0
        while True:
            t = {} if timings else None
            out = self._generate(i, timings=t)
            kept = {k: out[v][rows].cpu() for k, v in (("latents", "latents"), ("mel", "sample"),
                                                       ("raw", "raw"))}
            kept.update(seed=out["seed"], emb=out["emb"].cpu(), index=i)
            self.records.append(kept)
            for k, v in (t or {}).items():
                stages.setdefault(k, []).append(v)
            i += 1
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds:
                break
        return {"seconds": elapsed, "requests": i, "clips": i * self.traffic["batch"],
                "request_s": [b - a for a, b in zip([0.0] + ends, ends)],
                "stage_s": stages, "flops": i * self.request_flops()}

    def request_flops(self) -> float:
        """Model FLOPs of one request: the latent UNet's forwards at the CFG
        batch, the DAE decode and the DDEC's forwards."""
        tr, cfg = self.traffic, self.config
        b, h, w, _ = self.lat_shape
        forwards = 2 * tr["steps"]          # Heun: two forwards a step
        flops = forwards * work.unet_fwd_flops(cfg["unet"], 2 * b, h, w)
        flops += work.dae_decode_flops(cfg["dae"], b, self.mel_shape[1], self.mel_shape[2])
        if tr["decode_mode"] != "fgla" and "ddec" in cfg:
            n_bins = cfg["format"]["mdct_window_len"] // 2
            flops += forwards * work.unet_fwd_flops(cfg["ddec"], b, n_bins, self.mel_shape[2])
        return flops

    # ---- the traced parts ------------------------------------------------------
    def trace(self) -> List[dict]:
        """Profiled parts of one more request, each between two device
        synchronizes: ``TRACE_STEPS`` steps from the middle of the latent
        sampler (the sampler then stops: a chunk callback's abort), the DAE
        decode with Griffin-Lim or with the DDEC's conditioning, and under
        the DDEC ``TRACE_STEPS`` of its steps and the inverse MDCT. Each part
        records the UNet forwards it ran (their input shapes), the
        Griffin-Lim work it asked for, and its ``weight``: how many times a
        request runs what it holds (steps / TRACE_STEPS for a sampler's
        steps, 1 for the rest)."""
        from torch.profiler import ProfilerActivity, profile
        from benchmark.yardstick.trace import split_events
        tr, pipe = self.traffic, self.pipe
        parts: List[dict] = []
        forwards: List[tuple] = []

        def count(_module, args):
            forwards.append(tuple(args[0].shape))

        class Part:
            def __init__(part, name: str, module: Optional[str] = None, weight: float = 1.0):
                part.rec = {"name": name, "work": {}, "weight": weight}
                part.module = module

            def __enter__(part):
                self.sync()
                forwards.clear()
                part.hook = (pipe.modules[part.module].module.register_forward_pre_hook(count)
                             if part.module else None)
                part.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                part.prof.start()
                part.t0 = time.perf_counter()
                return part.rec

            def __exit__(part, *exc):
                self.sync()
                part.rec["wall_s"] = time.perf_counter() - part.t0
                part.prof.stop()
                if part.hook is not None:
                    part.hook.remove()
                    part.rec["work"]["forwards"] = {part.module: list(forwards)}
                part.rec["device"], part.rec["host"] = split_events(part.prof)
                parts.append(part.rec)

        def stepper(module: str):
            """A chunk callback that profiles ``TRACE_STEPS`` steps from the
            middle of a sampler, then stops it."""
            k0 = max(1, tr["steps"] // 2 - 1)
            part = Part(f"{module}_steps", module, tr["steps"] / TRACE_STEPS)

            def callback(done, _sample):
                if done == k0:
                    part.__enter__()
                elif done == k0 + TRACE_STEPS:
                    part.__exit__(None, None, None)
                    return True
                return False
            return callback

        noise_seed, emb = self.request_inputs(10 ** 6)
        gen = torch.Generator(device=self.device).manual_seed(noise_seed)
        with torch.no_grad():
            lat = pipe.diffusion_decode(self.params, self.lat_shape, emb, gen, chunk_size=1,
                                        chunk_callback=stepper("unet"))
            fmt = pipe.format
            with Part("decode") as rec:
                mel = pipe.modules["dae"].module.decode(lat).float()
                if tr["decode_mode"] == "fgla":
                    fmt.sample_to_raw(mel, n_fgla_iters=self.params.num_fgla_iters,
                                      phase_init=self.params.fgla_phase_init)
                    item = torch.finfo(getattr(torch, fmt.config.fgla_work_dtype)).bits // 8
                    rec["work"]["fgla"] = dict(
                        rows=mel.shape[0] * mel.shape[3], frames=mel.shape[2],
                        n_fft=fmt.config.padded_length, hop=fmt.config.hop_length,
                        iters=self.params.num_fgla_iters, item=item)
                else:
                    lin = fmt.mel_spec_to_linear(mel)
            if tr["decode_mode"] != "fgla":
                shape = fmt.get_mdct_shape_for_mel_frames(mel.shape[0], lin.shape[2])
                coeffs = pipe.diffusion_decode(self.params, shape, generator=gen,
                                               module_name="ddec", x_ref=lin, chunk_size=1,
                                               chunk_callback=stepper("ddec"))
                with Part("imdct"):
                    fmt.mdct_to_raw(coeffs)
        return parts

    # ---- correctness ---------------------------------------------------------------
    def free(self) -> None:
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, seed_pick: int, control: bool = False, detail: bool = False
              ) -> Dict[str, float]:
        """The gaps of one finished request drawn from the seed (its checked
        rows), against the plain reference; ``control`` puts the reference
        in the control's precision in the port's place."""
        from benchmark.reference.precision import CONTROL
        rec = self.records[seed_pick % len(self.records)]
        made = weights(self.config, self.seed, self.device)
        ref = ServeReference(self.config, made, self.device)
        ctl = ServeReference(self.config, made, self.device, CONTROL) if control else None
        del made
        request = dict(rec, rows=rows_slice(self.rows()), lat_shape=self.lat_shape)
        return compare(ref, self.traffic, request, ctl, detail)


def rows_slice(rows: List[int]):
    """``rows`` as an index the reference can take: a slice where they are
    evenly spaced, else the list."""
    if len(rows) == 1:
        return slice(rows[0], rows[0] + 1)
    step = rows[1] - rows[0]
    if all(b - a == step for a, b in zip(rows, rows[1:])):
        return slice(rows[0], rows[-1] + 1, step)
    return rows
