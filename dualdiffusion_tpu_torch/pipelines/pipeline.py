"""Pipeline: the named-module container over on-disk model directories, and
text-to-audio generation (JAX: dualdiffusion_tpu/pipelines/pipeline.py;
reference: src/pipelines/dual_diffusion_pipeline.py:126-752).

A model directory holds ``model_index.json`` (module name -> registered
type) and one subfolder per module with ``<module>.json`` (config plus
``__module_type__``) and ``<module>.safetensors`` (the JAX package's flat
'/'-joined keys). The port reads and writes the same format, so a directory
written by either package loads in the other.
"""

from __future__ import annotations

import inspect
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..models.dae import DAE, DAEConfig
from ..models.formats.format import _FORMAT_REGISTRY
from ..models.formats.ms_mdct_dual import MSMDCTDualFormat
from ..models.unet import UNet, UNetConfig
from ..sampling import SampleParams, edm_sample
from ..utils import (config_from_dict, config_to_dict, load_json, load_safetensors,
                     save_json, save_safetensors)
from ..weights import load_flat, to_flat

#: module type -> (factory(config, device), config class)
MODULE_REGISTRY: Dict[str, Tuple[Callable, type]] = {
    "unet": (lambda cfg, device: UNet(cfg, device=device), UNetConfig),
    "ddec": (lambda cfg, device: UNet(cfg, device=device), UNetConfig),
    "dae": (lambda cfg, device: DAE(cfg, device=device), DAEConfig),
}
for _name, (_cls, _cfg_cls) in _FORMAT_REGISTRY.items():
    MODULE_REGISTRY[f"format:{_name}"] = ((lambda c: lambda cfg, device: c(cfg))(_cls), _cfg_cls)


def get_module_class(name: str) -> Tuple[Callable, type]:
    if name not in MODULE_REGISTRY:
        raise KeyError(f"unknown module type '{name}'; known: {sorted(MODULE_REGISTRY)}")
    return MODULE_REGISTRY[name]


def save_module(path: Union[str, Path], name: str, module_type: str, config,
                module: Any, last_global_step: int = 0) -> None:
    """Write ``<path>/<name>/<name>.json`` (+ ``.safetensors`` for modules
    with weights)."""
    d = Path(path) / name
    d.mkdir(parents=True, exist_ok=True)
    cfg = config_to_dict(config)
    cfg["__module_type__"] = module_type
    cfg["__last_global_step__"] = last_global_step
    save_json(cfg, d / f"{name}.json")
    if isinstance(module, nn.Module):
        save_safetensors(to_flat(module), d / f"{name}.safetensors")


def load_module(path: Union[str, Path], name: str, device,
                load_ema: Optional[str] = None) -> Tuple[str, Any, Any]:
    """-> (module_type, config, module) with the weights loaded."""
    d = Path(path) / name
    raw = load_json(d / f"{name}.json")
    module_type = raw.pop("__module_type__")
    raw.pop("__last_global_step__", None)
    factory, cfg_cls = get_module_class(module_type)
    config = config_from_dict(cfg_cls, raw)
    module = factory(config, device)
    weights = d / f"{name}.safetensors"
    if load_ema:
        if re.search(r"[/\\\0]|\.\.", load_ema):
            raise ValueError(f"invalid EMA selection {load_ema!r}")
        if load_ema.startswith("phema_"):
            raise NotImplementedError("post-hoc EMA reconstruction is not ported")
        weights = d / f"ema_{load_ema}.safetensors"
        if not weights.is_file():
            raise FileNotFoundError(f"no EMA '{load_ema}' for module '{name}' in {d}")
    if isinstance(module, nn.Module):
        if not weights.is_file():
            raise FileNotFoundError(f"no weights for module '{name}' in {d}")
        load_flat(module, load_safetensors(weights))
        module.eval()
    return module_type, config, module


@dataclass
class ModuleHandle:
    name: str
    module_type: str
    config: Any
    module: Any            # nn.Module, or a Format


class Pipeline:
    """Named-module container + generation orchestration."""

    def __init__(self, modules: Dict[str, ModuleHandle]):
        self.modules = modules

    @property
    def format(self):
        for h in self.modules.values():
            if h.module_type.startswith("format:"):
                return h.module
        return None

    # ---- io ------------------------------------------------------------
    def save_pretrained(self, model_path: Union[str, Path], last_global_step: int = 0) -> None:
        model_path = Path(model_path)
        model_path.mkdir(parents=True, exist_ok=True)
        index = {"modules": {h.name: h.module_type for h in self.modules.values()},
                 "framework": "dualdiffusion_tpu_torch"}
        save_json(index, model_path / "model_index.json")
        for h in self.modules.values():
            save_module(model_path, h.name, h.module_type, h.config, h.module,
                        last_global_step)

    @classmethod
    def from_pretrained(cls, model_path: Union[str, Path], device="cuda",
                        load_checkpoints: Union[bool, Dict[str, str]] = False,
                        load_emas: Optional[Dict[str, str]] = None) -> "Pipeline":
        """Load a model directory onto ``device``: the card unless the caller
        asks for the CPU (``device="cpu"``); without a card the default raises.

        ``load_checkpoints``: False loads the model root; True each module's
        latest ``<module>_checkpoint-<step>/``; a dict maps module name to
        "latest", "root", a step number or a checkpoint directory name.
        ``load_emas`` maps module name -> EMA name (``ema_<name>.safetensors``).
        """
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to load onto the CPU")
        model_path = Path(model_path)
        index = load_json(model_path / "model_index.json")
        load_emas = load_emas or {}
        modules: Dict[str, ModuleHandle] = {}
        for name, module_type in index["modules"].items():
            get_module_class(module_type)  # fail fast on unknown types
            sel = (load_checkpoints.get(name) if isinstance(load_checkpoints, dict)
                   else ("latest" if load_checkpoints else None))
            src = model_path
            if sel not in (None, "", "root"):
                src = cls._checkpoint_dir(model_path, name, str(sel)) or model_path
            mtype, config, module = load_module(src, name, device, load_ema=load_emas.get(name))
            modules[name] = ModuleHandle(name, mtype, config, module)
        return cls(modules)

    @classmethod
    def _checkpoint_dir(cls, model_path: Path, name: str, sel: str) -> Optional[Path]:
        if sel == "latest":
            ckpts = cls.get_checkpoints(model_path, name)
            return ckpts[-1] if ckpts else None
        cand = f"{name}_checkpoint-{sel}" if sel.isdigit() else sel
        if not re.fullmatch(rf"{re.escape(name)}_checkpoint-\d+", cand):
            raise ValueError(f"invalid checkpoint selection {sel!r} for module '{name}'")
        if not (model_path / cand).is_dir():
            raise FileNotFoundError(f"no checkpoint '{sel}' for module '{name}' in {model_path}")
        return model_path / cand

    @staticmethod
    def get_checkpoints(model_path: Union[str, Path], module_name: str) -> List[Path]:
        model_path = Path(model_path)
        pat = re.compile(rf"^{re.escape(module_name)}_checkpoint-(\d+)$")
        found = []
        if model_path.is_dir():
            for p in model_path.iterdir():
                m = pat.match(p.name)
                if m and p.is_dir():
                    found.append((int(m.group(1)), p))
        return [p for _, p in sorted(found)]

    @classmethod
    def get_latest_checkpoint(cls, model_path: Union[str, Path], module_name: str
                              ) -> Optional[Path]:
        ckpts = cls.get_checkpoints(model_path, module_name)
        return ckpts[-1] if ckpts else None

    # ---- generation -------------------------------------------------------
    @torch.no_grad()
    def diffusion_decode(self, params: SampleParams, sample_shape: Tuple[int, ...],
                         audio_embedding: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         init_noise: Optional[torch.Tensor] = None,
                         step_noise: Optional[Sequence[torch.Tensor]] = None,
                         module_name: str = "unet",
                         x_ref: Optional[torch.Tensor] = None) -> torch.Tensor:
        """EDM sampling with the named UNet, CFG-doubled when a prompt
        embedding is given. ``x_ref`` is the conditioning of a model with
        ``in_psd_freqs`` (the DDEC's PSD), doubled with the batch under CFG."""
        h = self.modules[module_name]
        unet, ucfg = h.module, h.config
        if ucfg.in_channels != ucfg.out_channels:
            raise NotImplementedError("inpainting / img2img reference channels are not ported")
        device = next(unet.parameters()).device
        emb2 = None
        if audio_embedding is not None and ucfg.in_channels_emb > 0:
            e = audio_embedding.to(device)
            ones = torch.ones((e.shape[0],), device=device)
            emb2 = torch.cat([unet.get_embeddings(e, ones),
                              unet.get_embeddings(e, torch.zeros_like(ones))], dim=0)
        ref = None
        if x_ref is not None:
            ref = x_ref.to(device)
            if emb2 is not None:
                ref = torch.cat([ref, ref], dim=0)

        # the ref rides in the closure: JAX passes it through edm_sample only
        # so that the seamless-loop roll can move it, which the port's
        # edm_sample does not take
        def denoise(x, sigma):
            return unet(x, sigma, emb2, ref)

        return edm_sample(denoise, sample_shape, params,
                          params.sigma_max or ucfg.sigma_max,
                          params.sigma_min or ucfg.sigma_min,
                          params.sigma_data or ucfg.sigma_data,
                          generator=generator, device=device, init_noise=init_noise,
                          step_noise=step_noise, use_cfg=emb2 is not None)

    @torch.no_grad()
    def generate(self, params: SampleParams, generator: Optional[torch.Generator] = None,
                 prompt_embedding: Optional[torch.Tensor] = None, decode_mode: str = "auto",
                 input_audio=None, input_latents: Optional[torch.Tensor] = None,
                 inpainting_mask: Optional[torch.Tensor] = None,
                 init_noise: Optional[torch.Tensor] = None,
                 step_noise: Optional[Sequence[torch.Tensor]] = None,
                 ddec_init_noise: Optional[torch.Tensor] = None,
                 ddec_step_noise: Optional[Sequence[torch.Tensor]] = None,
                 timings: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        """Latent sampling -> DAE decode -> audio.

        ``decode_mode``: "fgla" (mel unscale + Griffin-Lim), "ddec" (the
        diffusion decoder samples MDCT coefficients conditioned on the mel's
        linear PSD, then the inverse MDCT; needs a "ddec" module and the
        ms_mdct_dual format), or "auto": "ddec" when the pipeline has a
        "ddec" module, else "fgla". The DDEC samples with the same
        ``params`` and never with CFG: it takes no prompt embedding.
        ``input_audio``, ``input_latents`` and ``inpainting_mask`` (img2img,
        inpainting) raise NotImplementedError. Noise comes from
        ``generator`` (default: seeded from ``params.seed``, else 0), drawn
        by the latent stage and then the DDEC stage, unless
        ``init_noise``/``step_noise`` (latent stage) or
        ``ddec_init_noise``/``ddec_step_noise`` (DDEC stage) are given. ``timings``, when given, receives per-stage seconds (each
        stage ends in a device synchronize): sampler, dae_decode, then fgla
        or ddec and mdct_to_raw. Returns dict(raw, sample, latents): raw
        audio (B, C, T), the mel sample and the latents.
        """
        if decode_mode not in ("auto", "fgla", "ddec"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if input_audio is not None or input_latents is not None or inpainting_mask is not None:
            raise NotImplementedError("img2img and inpainting are not ported")
        fmt = self.format
        if fmt is None:
            raise ValueError("pipeline has no format module")
        if decode_mode == "auto":
            decode_mode = "ddec" if "ddec" in self.modules else "fgla"
        if decode_mode == "ddec":
            if "ddec" not in self.modules:
                raise KeyError("decode_mode='ddec' needs a 'ddec' module")
            if not isinstance(fmt, MSMDCTDualFormat):
                raise TypeError("ddec decode requires the ms_mdct_dual format")
        unet = self.modules["unet"].module
        device = next(unet.parameters()).device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(params.seed or 0)

        def mark(stage: str, t0: float) -> float:
            if timings is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                now = time.perf_counter()
                timings[stage] = now - t0
                return now
            return t0

        t0 = time.perf_counter()
        mel_shape = fmt.get_sample_shape(params.batch_size, params.length)
        dae_h = self.modules.get("dae")
        latents = None
        if dae_h is not None:
            lat_shape = dae_h.module.get_latent_shape(mel_shape)
            latents = self.diffusion_decode(params, lat_shape, prompt_embedding, generator,
                                            init_noise, step_noise)
            t0 = mark("sampler", t0)
            mel = dae_h.module.decode(latents).float()
            t0 = mark("dae_decode", t0)
        else:
            mel = self.diffusion_decode(params, tuple(mel_shape), prompt_embedding, generator,
                                        init_noise, step_noise)
            t0 = mark("sampler", t0)
        if decode_mode == "ddec":
            lin = fmt.mel_spec_to_linear(mel)
            mdct_shape = fmt.get_mdct_shape_for_mel_frames(params.batch_size, lin.shape[2])
            coeffs = self.diffusion_decode(params, mdct_shape, generator=generator,
                                           init_noise=ddec_init_noise,
                                           step_noise=ddec_step_noise,
                                           module_name="ddec", x_ref=lin)
            t0 = mark("ddec", t0)
            raw = fmt.mdct_to_raw(coeffs)
            mark("mdct_to_raw", t0)
            return {"raw": raw, "sample": mel, "latents": latents}
        # the format's FGLA decode where it has one (ms_mdct_dual's
        # sample_to_raw is the MDCT inverse); phase_init where it takes one
        decode = getattr(fmt, "sample_to_raw_fgla", fmt.sample_to_raw)
        kw = {}
        if params.fgla_phase_init and "phase_init" in inspect.signature(decode).parameters:
            kw["phase_init"] = params.fgla_phase_init
        raw = decode(mel, n_fgla_iters=params.num_fgla_iters, **kw)
        mark("fgla", t0)
        return {"raw": raw, "sample": mel, "latents": latents}
