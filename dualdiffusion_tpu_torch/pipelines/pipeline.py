"""Pipeline: the named-module container over on-disk model directories, and
text-to-audio generation (JAX: dualdiffusion_tpu/pipelines/pipeline.py;
reference: src/pipelines/dual_diffusion_pipeline.py:126-752).

A model directory holds ``model_index.json`` (module name -> registered
type), one subfolder per module with ``<module>.json`` (config plus
``__module_type__``) and ``<module>.safetensors`` (the JAX package's flat
'/'-joined keys), EMA weights beside them (``ema_<name>.safetensors``, and
bf16 archives in ``<module>/ema_archive/`` for post-hoc EMAs), and the
per-label prompt embeddings in ``dataset_embeddings.safetensors``. The port
reads and writes the same format, so a directory written by either package
loads in the other.

``Pipeline.to`` places each module on a device of its own; ``generate``
then moves each stage's input to the device of the module that runs it.
``Pipeline.shard`` puts every module on the tensor-parallel route over the
ranks of a process group (``parallel.mesh``).
"""

from __future__ import annotations

import dataclasses
import inspect
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..models.dae import DAE, DAEConfig
from ..models.discriminator import Discriminator, DiscriminatorConfig
from ..models.formats.format import _FORMAT_REGISTRY
from ..models.formats.ms_mdct_dual import MSMDCTDualFormat
from ..models.mp import normalize
from ..models.unet import UNet, UNetConfig
from ..models.vae import VAE, VAEConfig
from ..sampling import SampleParams, edm_sample, seamless_loop_crossfade
from ..utils import (config_from_dict, config_to_dict, load_json, load_safetensors,
                     save_json, save_safetensors)
from ..weights import SCALAR_SUFFIX, flax_key, load_flat, to_flat

#: module type -> (factory(config, device), config class)
MODULE_REGISTRY: Dict[str, Tuple[Callable, type]] = {
    "unet": (lambda cfg, device: UNet(cfg, device=device), UNetConfig),
    "ddec": (lambda cfg, device: UNet(cfg, device=device), UNetConfig),
    "dae": (lambda cfg, device: DAE(cfg, device=device), DAEConfig),
    "vae": (lambda cfg, device: VAE(cfg, device=device), VAEConfig),
    "disc": (lambda cfg, device: Discriminator(cfg, device=device), DiscriminatorConfig),
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
    flat = None
    if load_ema:
        if re.search(r"[/\\\0]|\.\.", load_ema):
            raise ValueError(f"invalid EMA selection {load_ema!r}")
        weights = d / f"ema_{load_ema}.safetensors"
        if not weights.is_file():
            # "phema_<std>": reconstructed from the module's EMA archive. As in
            # JAX, the archive is read from <module>/ema_archive/, not from
            # the <module>_ema_archive/ that the trainers write (ROADMAP §3)
            m = re.match(r"phema_([0-9.]+)", load_ema)
            if not (m and (d / "ema_archive").is_dir()):
                raise FileNotFoundError(f"no EMA '{load_ema}' for module '{name}' in {d}")
            from ..training.ema import reconstruct_phema
            flat = reconstruct_phema(float(m.group(1)), d / "ema_archive")
            # a JAX-written archive stores 0-d leaves as (1,) under the bare key
            scalars = {flax_key(k, True) for k, v in module.state_dict().items()
                       if v.dim() == 0}
            flat = {(k + SCALAR_SUFFIX if k + SCALAR_SUFFIX in scalars else k): v
                    for k, v in flat.items()}
    if isinstance(module, nn.Module):
        if flat is None:
            if not weights.is_file():
                raise FileNotFoundError(f"no weights for module '{name}' in {d}")
            flat = load_safetensors(weights)
        load_flat(module, flat)
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

    def __init__(self, modules: Dict[str, ModuleHandle],
                 dataset_embeddings: Optional[Dict[str, np.ndarray]] = None):
        self.modules = modules
        #: "<label>_audio" / "<label>_text" / "_unconditional_audio" -> (dim,)
        self.dataset_embeddings = dataset_embeddings or {}

    @property
    def format(self):
        for h in self.modules.values():
            if h.module_type.startswith("format:"):
                return h.module
        return None

    # ---- device placement ------------------------------------------------
    def to(self, device=None, device_map: Optional[Dict[str, Any]] = None) -> "Pipeline":
        """Move each module with weights to ``device``, or to its entry of
        ``device_map`` (module name -> device, as "cuda:0" or "cpu"), in
        place (JAX pipeline.py:243-268). The format, which has no weights,
        runs where the UNet runs."""
        for name, h in self.modules.items():
            dev = (device_map or {}).get(name, device)
            if dev is not None and isinstance(h.module, nn.Module):
                if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
                    raise RuntimeError(f"no CUDA device for module '{name}'")
                h.module.to(torch.device(dev))
        return self

    def shard(self, model_axis: int, devices: Optional[Sequence[int]] = None) -> "Pipeline":
        """Tensor-parallel placement (JAX pipeline.py:270-296): every module's
        ``MPConv`` weights sharded out-channel-wise over a ``model_axis``-wide
        "model" axis of the process group's ranks (``devices``, all by
        default; one rank per device, each holding the pipeline on its own
        device), by the trainer's rule. Every rank then computes the same
        clip, each layer column-parallel over the group."""
        from ..parallel import MeshConfig, make_mesh, shard_train_state
        mesh = make_mesh(MeshConfig(data_axis=1, model_axis=model_axis), devices=devices)
        for h in self.modules.values():
            if isinstance(h.module, nn.Module):
                shard_train_state(mesh, h.module)
        return self

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
        if self.dataset_embeddings:
            save_safetensors({k: np.asarray(v) for k, v in self.dataset_embeddings.items()},
                             model_path / "dataset_embeddings.safetensors")

    @classmethod
    def from_pretrained(cls, model_path: Union[str, Path], device="cuda",
                        load_checkpoints: Union[bool, Dict[str, str]] = False,
                        load_emas: Optional[Dict[str, str]] = None) -> "Pipeline":
        """Load a model directory onto ``device``: the card unless the caller
        asks for the CPU (``device="cpu"``); without a card the default raises.

        ``load_checkpoints``: False loads the model root; True each module's
        latest ``<module>_checkpoint-<step>/``; a dict maps module name to
        "latest", "root", a step number or a checkpoint directory name (its
        own, or another module's that holds it, as the joint DAE + DDEC
        trainer's ``ddec_checkpoint-<step>/`` holds the DAE).
        ``load_emas`` maps module name -> EMA name: ``ema_<name>.safetensors``
        where it exists, else for ``phema_<std>`` the post-hoc EMA of that
        std reconstructed from ``<module>/ema_archive/``. The prompt
        embeddings of ``dataset_embeddings.safetensors`` are read when the
        directory has one.
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
        emb_path = model_path / "dataset_embeddings.safetensors"
        return cls(modules, load_safetensors(emb_path) if emb_path.is_file() else {})

    @classmethod
    def _checkpoint_dir(cls, model_path: Path, name: str, sel: str) -> Optional[Path]:
        if sel == "latest":
            ckpts = cls.get_checkpoints(model_path, name)
            return ckpts[-1] if ckpts else None
        cand = f"{name}_checkpoint-{sel}" if sel.isdigit() else sel
        # a joint trainer's checkpoint (``ddec_checkpoint-<step>/``) holds the
        # other module it trains beside its own
        joint = (re.fullmatch(r"\w+_checkpoint-\d+", cand) is not None
                 and (model_path / cand / name).is_dir())
        if not (joint or re.fullmatch(rf"{re.escape(name)}_checkpoint-\d+", cand)):
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

    @staticmethod
    def get_available_emas(model_path: Union[str, Path], module_name: str) -> List[str]:
        """The EMA names of ``<module>/ema_<name>.safetensors``, sorted."""
        d = Path(model_path) / module_name
        if not d.is_dir():
            return []
        return sorted(p.name[len("ema_"):-len(".safetensors")] for p in d.iterdir()
                      if p.name.startswith("ema_") and p.name.endswith(".safetensors"))

    # ---- prompt -> embedding ----------------------------------------------
    def get_prompt_embedding(self, prompt: Dict[str, float]) -> Optional[torch.Tensor]:
        """The weighted sum of the prompt's per-label audio and text
        embeddings, normalized, (1, dim) fp32 on the UNet's device; the
        unconditional audio embedding for a prompt with no known label; None
        without dataset embeddings (JAX pipeline.py:401-420)."""
        if not self.dataset_embeddings:
            return None
        device = (next(self.modules["unet"].module.parameters()).device
                  if "unet" in self.modules else None)
        total = None
        for label, weight in prompt.items():
            for kind in ("audio", "text"):
                v = self.dataset_embeddings.get(f"{label}_{kind}")
                if v is not None:
                    v = torch.as_tensor(np.asarray(v, np.float32), device=device) * weight
                    total = v if total is None else total + v
        if total is None:
            ua = self.dataset_embeddings.get("_unconditional_audio")
            if ua is None:
                return None
            total = torch.as_tensor(np.asarray(ua, np.float32), device=device)
        return normalize(total.reshape(1, -1), dim=-1)

    # ---- generation -------------------------------------------------------
    @torch.no_grad()
    def diffusion_decode(self, params: SampleParams, sample_shape: Optional[Tuple[int, ...]],
                         audio_embedding: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         init_noise: Optional[torch.Tensor] = None,
                         step_noise: Optional[Sequence[torch.Tensor]] = None,
                         module_name: str = "unet",
                         x_ref: Optional[torch.Tensor] = None,
                         init_sample: Optional[torch.Tensor] = None,
                         inpainting_mask: Optional[torch.Tensor] = None,
                         step_shifts: Optional[Sequence[int]] = None,
                         chunk_size: Optional[int] = None,
                         chunk_callback: Optional[Callable[[int, torch.Tensor], bool]] = None,
                         debug: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """EDM sampling with the named UNet, CFG-doubled when a prompt
        embedding is given (JAX pipeline.py:423-514). ``x_ref`` is the
        conditioning of a model with ``in_psd_freqs`` (the DDEC's PSD),
        doubled with the batch under CFG and passed through the sampler, so
        the seamless loop rolls it with the sample.

        ``init_sample`` enters the schedule part-way (img2img).
        ``inpainting_mask`` (broadcastable to (B, H, W, 1); 1 = generate, 0 =
        keep) substitutes ``unet_inpainting`` for "unet" where the pipeline
        has one. A UNet with ``out_channels + 1`` more inputs than outputs
        and no ``in_psd_freqs`` gets them as the reference
        ``init_sample * (1 - mask)`` and the thresholded mask, or zeros and
        an all-ones mask without a mask. ``sample_shape`` defaults to
        ``init_sample``'s."""
        if (inpainting_mask is not None and module_name == "unet"
                and "unet_inpainting" in self.modules):
            module_name = "unet_inpainting"
        h = self.modules[module_name]
        unet, ucfg = h.module, h.config
        device = next(unet.parameters()).device
        if init_sample is not None:
            init_sample = init_sample.to(device).float()
        if sample_shape is None:
            if init_sample is None:
                raise ValueError("sample_shape or init_sample is required")
            sample_shape = tuple(init_sample.shape)
        sample_shape = tuple(sample_shape)
        if ucfg.in_channels > ucfg.out_channels and ucfg.in_psd_freqs == 0 and x_ref is None:
            base = (init_sample if init_sample is not None
                    else torch.zeros(sample_shape, device=device))
            if inpainting_mask is not None:
                mask = (torch.as_tensor(inpainting_mask, device=device) > 0.5).float()
                mask = mask.expand(base.shape[:-1] + (1,))
            else:
                mask = torch.ones(base.shape[:-1] + (1,), device=device)
                base = torch.zeros_like(base)
            x_ref = torch.cat([base * (1.0 - mask), mask], dim=-1)
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

        def denoise(x, sigma, r=None):
            return unet(x, sigma, emb2, r)

        if generator is not None and generator.device != device:
            # the sampler runs where its noise is drawn; the module on its own device
            def denoise(x, sigma, r=None, run=denoise, at=device, home=generator.device):
                return run(x.to(at), sigma.to(at), None if r is None else r.to(at)).to(home)
            device = generator.device
            ref = None if ref is None else ref.to(device)
            init_sample = None if init_sample is None else init_sample.to(device)

        return edm_sample(denoise, sample_shape, params,
                          params.sigma_max or ucfg.sigma_max,
                          params.sigma_min or ucfg.sigma_min,
                          params.sigma_data or ucfg.sigma_data,
                          generator=generator, device=device, init_sample=init_sample,
                          init_noise=init_noise, step_noise=step_noise,
                          use_cfg=emb2 is not None, x_ref=ref, step_shifts=step_shifts,
                          chunk_size=chunk_size, chunk_callback=chunk_callback, debug=debug)

    @torch.no_grad()
    def encode_input_audio(self, input_audio, length: Optional[int] = None) -> torch.Tensor:
        """Raw audio (C, T) or (B, C, T), numpy or tensor, as an init sample
        for img2img and inpainting (JAX pipeline.py:516-544): cropped or
        zero-padded to the format's crop width, format-encoded, cropped to a
        multiple of the DAE's downsample ratio and DAE-encoded on the DAE's
        device (the format sample itself without a DAE). fp32, on the UNet's
        device."""
        fmt = self.format
        device = next(self.modules["unet"].module.parameters()).device
        audio = torch.as_tensor(input_audio, dtype=torch.float32, device=device)
        if audio.dim() == 2:
            audio = audio[None]
        want = fmt.get_raw_crop_width(length)
        t = audio.shape[-1]
        audio = (torch.nn.functional.pad(audio, (0, want - t)) if t < want
                 else audio[..., :want])
        sample = fmt.raw_to_sample(audio)
        dae_h = self.modules.get("dae")
        if dae_h is not None:
            ds = dae_h.module.downsample_ratio
            sample = sample[:, :, : sample.shape[2] // ds * ds]
            dae_device = next(dae_h.module.parameters()).device
            sample = dae_h.module.encode(sample.to(dae_device)).to(device)
        return sample.float()

    @torch.no_grad()
    def generate(self, params: SampleParams, generator: Optional[torch.Generator] = None,
                 prompt_embedding: Optional[torch.Tensor] = None, decode_mode: str = "auto",
                 input_audio=None, input_latents: Optional[torch.Tensor] = None,
                 inpainting_mask=None,
                 init_noise: Optional[torch.Tensor] = None,
                 step_noise: Optional[Sequence[torch.Tensor]] = None,
                 step_shifts: Optional[Sequence[int]] = None,
                 ddec_init_noise: Optional[torch.Tensor] = None,
                 ddec_step_noise: Optional[Sequence[torch.Tensor]] = None,
                 ddec_step_shifts: Optional[Sequence[int]] = None,
                 chunk_size: Optional[int] = None,
                 chunk_callback: Optional[Callable[[int, torch.Tensor], bool]] = None,
                 timings: Optional[Dict[str, float]] = None,
                 debug: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """Latent sampling -> DAE decode -> audio (JAX pipeline.py:546-657).

        ``decode_mode``: "fgla" (mel unscale + Griffin-Lim), "ddec" (the
        diffusion decoder samples MDCT coefficients conditioned on the mel's
        linear PSD, then the inverse MDCT; needs a "ddec" module and the
        ms_mdct_dual format), or "auto": "ddec" when the pipeline has a
        "ddec" module, else "fgla". The DDEC samples with the same
        ``params`` (the seamless loop included) and never with CFG or an
        init sample.

        img2img: ``input_audio`` (raw (C, T) / (B, C, T), through
        ``encode_input_audio``) or ``input_latents`` is the init sample,
        broadcast to the batch; ``params.img2img_strength`` sets how much of
        the schedule runs. ``inpainting_mask`` (1 = generate, 0 = keep; in
        latent space) adds the reference and mask channels, substitutes
        ``unet_inpainting`` where the pipeline has one and runs the whole
        schedule. ``params.seamless_loop`` samples on a torus and crossfades
        the audio's ends into a loop. ``chunk_callback(steps_done, sample)``
        is called after every ``chunk_size`` latent steps; True aborts the
        latent stage, whose partial sample is decoded.

        Noise comes from ``generator`` (default: seeded from
        ``params.seed``, else 0), drawn by the latent stage and then the
        DDEC stage, unless ``init_noise``/``step_noise``/``step_shifts``
        (latent stage) or their ``ddec_`` counterparts (DDEC stage) are
        given. ``timings``, when given, receives per-stage seconds (each
        stage ends in a device synchronize): encode (with ``input_audio``),
        sampler, dae_decode, then fgla or ddec and mdct_to_raw. ``debug``,
        when given, receives the latent stage's per-step values and, under
        "ddec", the DDEC stage's. Returns dict(raw, sample, latents): raw
        audio (B, C, T), the mel sample and the latents.
        """
        if decode_mode not in ("auto", "fgla", "ddec"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
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
        init = input_latents
        if init is None and input_audio is not None:
            init = self.encode_input_audio(input_audio, params.length)
            t0 = mark("encode", t0)
        if init is not None:
            init = init.to(device).float()
            if init.shape[0] < params.batch_size:
                init = init.expand((params.batch_size,) + tuple(init.shape[1:]))
        sample_params = params
        if inpainting_mask is not None:
            sample_params = dataclasses.replace(params, img2img_strength=1.0)
        stage_kw = dict(init_sample=init, inpainting_mask=inpainting_mask,
                        step_shifts=step_shifts, chunk_size=chunk_size,
                        chunk_callback=chunk_callback, debug=debug)
        mel_shape = fmt.get_sample_shape(params.batch_size, params.length)
        dae_h = self.modules.get("dae")
        latents = None
        if dae_h is not None:
            lat_shape = dae_h.module.get_latent_shape(mel_shape)
            if init is not None and tuple(init.shape[1:]) != tuple(lat_shape[1:]):
                raise ValueError(f"init sample shape {tuple(init.shape)} does not match the "
                                 f"latent shape {tuple(lat_shape)}")
            latents = self.diffusion_decode(sample_params, lat_shape, prompt_embedding,
                                            generator, init_noise, step_noise, **stage_kw)
            t0 = mark("sampler", t0)
            dae_device = next(dae_h.module.parameters()).device
            mel = dae_h.module.decode(latents.to(dae_device)).float().to(device)
            t0 = mark("dae_decode", t0)
        else:
            mel = self.diffusion_decode(sample_params, tuple(mel_shape), prompt_embedding,
                                        generator, init_noise, step_noise, **stage_kw)
            t0 = mark("sampler", t0)
        if decode_mode == "ddec":
            lin = fmt.mel_spec_to_linear(mel)
            mdct_shape = fmt.get_mdct_shape_for_mel_frames(params.batch_size, lin.shape[2])
            ddec_debug = {} if debug is not None else None
            coeffs = self.diffusion_decode(params, mdct_shape, generator=generator,
                                           init_noise=ddec_init_noise,
                                           step_noise=ddec_step_noise,
                                           module_name="ddec", x_ref=lin,
                                           step_shifts=ddec_step_shifts, debug=ddec_debug)
            if debug is not None:
                debug["ddec"] = ddec_debug
            t0 = mark("ddec", t0)
            raw = fmt.mdct_to_raw(coeffs)
            stage = "mdct_to_raw"
        else:
            # the format's FGLA decode where it has one (ms_mdct_dual's
            # sample_to_raw is the MDCT inverse); phase_init where it takes one
            decode = getattr(fmt, "sample_to_raw_fgla", fmt.sample_to_raw)
            kw = {}
            if params.fgla_phase_init and "phase_init" in inspect.signature(decode).parameters:
                kw["phase_init"] = params.fgla_phase_init
            raw = decode(mel, n_fgla_iters=params.num_fgla_iters, **kw)
            stage = "fgla"
        if params.seamless_loop:
            raw = seamless_loop_crossfade(raw, loop_hop_length(fmt.config))
        mark(stage, t0)
        return {"raw": raw, "sample": mel, "latents": latents}


def loop_hop_length(format_config) -> int:
    """The hop of the seamless-loop crossfade: the config's ``hop_length``,
    else its ``ms_hop_length``, else 256 (JAX pipeline.py:651-655)."""
    return getattr(format_config, "hop_length", getattr(format_config, "ms_hop_length", 256))
