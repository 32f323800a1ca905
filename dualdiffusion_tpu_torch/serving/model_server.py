"""Model server: a dedicated inference process with a shared-dict command
protocol (JAX: dualdiffusion_tpu/serving/model_server.py; reference:
src/sampling/model_server.py:43-146).

A separate process polls a ``multiprocessing.Manager().dict()`` at 10 Hz for
commands (``get_available_devices``, ``load_model``, ``compile_model``,
``generate`` with chunked step previews and an abort through the dict,
``get_inventory``, ``get_module_state_dict``, ``get_latent_shape``,
``shutdown``) and writes results and errors back into the dict. Clients talk
to it only through the dict, so the card stays in its own process; what it
writes there is numpy, never a tensor.

The server runs on the device it is given (``"cuda"`` unless the caller asks
for ``"cpu"``). Without a card, ``device="cuda"`` makes ``load_model`` write
its error to the dict; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing
import os
import time
import traceback
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger("model_server")


class GenerationAborted(Exception):
    """Raised from the chunk callback when the client sets ``generate_abort``:
    it ends ``generate`` before the decode, whose output would be dropped."""


def _np(x: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if x is None else x.detach().float().cpu().numpy()


class ModelServer:
    def __init__(self, state, device="cuda") -> None:
        self.state = state
        self.device = torch.device(device)
        self.pipeline = None
        self._init_logging()

    def _init_logging(self) -> None:
        from ..utils import DEBUG_PATH
        logger.setLevel(logging.DEBUG)
        if DEBUG_PATH:
            d = os.path.join(DEBUG_PATH, "model_server")
            os.makedirs(d, exist_ok=True)
            stamp = datetime.now().strftime("%Y-%m-%d_%H_%M_%S")
            self.log_path = os.path.join(d, f"model_server_{stamp}.log")
            logging.basicConfig(handlers=[logging.FileHandler(self.log_path),
                                          logging.StreamHandler()],
                                format="ModelServer: %(message)s")
        else:
            self.log_path = None

    # ---- commands -------------------------------------------------------
    def cmd_get_available_devices(self) -> None:
        if self.device.type == "cuda":
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            self.state["available_devices"] = [f"cuda:{i}" for i in range(n)]
        else:
            self.state["available_devices"] = [self.device.type]

    def cmd_load_model(self) -> None:
        from ..pipelines.pipeline import Pipeline
        from ..utils import MODELS_PATH
        name = self.state["model_name"]
        path = name if os.path.isdir(name) else os.path.join(MODELS_PATH or "", name)
        logger.info("loading pipeline from %s onto %s", path, self.device)
        self.pipeline = None                 # free the card before a reload
        if self.device.type == "cuda" and torch.cuda.is_available():
            torch.cuda.empty_cache()
        self.pipeline = Pipeline.from_pretrained(
            path, device=self.device, **self.state.get("model_load_options", {}))
        self.model_path = path
        fmt = self.pipeline.format
        self.state["format_config"] = dict(fmt.config.__dict__) if fmt else {}
        labels = sorted({k.rsplit("_", 1)[0]
                         for k in self.pipeline.dataset_embeddings
                         if not k.startswith("_")})
        self.state["prompt_labels"] = labels
        self.state["model_modules"] = list(self.pipeline.modules)

    def cmd_compile_model(self) -> None:
        """A 1-step warm-up generate, so the first real one is fast: it builds
        the CUDA kernels on a fresh checkout and warms cuDNN (reference
        :101-113)."""
        params = self._params(dict(self.state.get("sample_params", {}),
                                   steps=1, use_heun=False, num_fgla_iters=1))
        emb = self.pipeline.get_prompt_embedding(params.prompt)
        self.pipeline.generate(params, torch.Generator(device=self.device).manual_seed(0),
                               prompt_embedding=emb)
        logger.info("warm-up complete")

    def _params(self, overrides: Dict[str, Any]):
        from ..sampling import SampleParams
        fields = {f.name for f in dataclasses.fields(SampleParams)}
        return SampleParams(**{k: v for k, v in overrides.items() if k in fields})

    def cmd_generate(self) -> None:
        """One generation through ``Pipeline.generate`` (the DDEC decode,
        img2img, inpainting and the seamless loop included), with a latent
        preview every tenth of the steps and an abort through the dict
        (reference: model_server.py:111-113 + pipeline :540-546). An abort
        ends the request at the next preview, without a decode; one that
        comes after the last preview drops the decoded clip. Either way, and
        when the request fails, ``generate_output`` is None, so a client never
        takes the previous request's clip for this one's."""
        self.state["generate_output"] = None
        params = self._params(self.state.get("sample_params", {}))
        seed = params.seed or int(np.random.randint(100000, 999999))
        emb = self.pipeline.get_prompt_embedding(params.prompt)
        self.state["generate_step"] = 0
        self.state["generate_abort"] = False

        def chunk_cb(done, sample):
            self.state["generate_step"] = int(done)
            self.state["generate_latents"] = _np(sample)
            if self.state.get("generate_abort", False):
                raise GenerationAborted
            return False

        input_latents = self.state.get("input_latents")
        fmt = self.pipeline.format
        try:
            out = self.pipeline.generate(
                params, torch.Generator(device=self.device).manual_seed(seed),
                prompt_embedding=emb, decode_mode=self.state.get("decode_mode", "auto"),
                input_audio=self.state.get("input_audio"),
                input_latents=None if input_latents is None else torch.as_tensor(input_latents),
                inpainting_mask=self.state.get("inpainting_mask"),
                chunk_size=max(params.steps // 10, 1), chunk_callback=chunk_cb)
            if self.state.get("generate_abort", False):
                raise GenerationAborted
            self.state["generate_output"] = {
                "raw": _np(out["raw"]), "sample": _np(out["sample"]),
                "latents": _np(out["latents"]),
                "seed": seed, "sample_rate": fmt.config.sample_rate,
            }
        except GenerationAborted:
            logger.info("generate aborted at step %s", self.state.get("generate_step"))
        finally:
            self.state["generate_step"] = None
            self.state["generate_latents"] = None

    def cmd_get_inventory(self) -> None:
        """Checkpoint and EMA inventory per module (the UI's model explorer;
        reference: dual_diffusion_pipeline.py:190-215 + nicegui_app.py:
        84-221). ``params`` counts every saved leaf, the statistics buffers
        included, as the JAX package counts its variables."""
        from ..pipelines.pipeline import Pipeline
        inv = {}
        loaded = self.state.get("model_load_options", {})
        ck_sel = loaded.get("load_checkpoints", False)
        ema_sel = loaded.get("load_emas", {}) or {}
        for name, h in self.pipeline.modules.items():
            sel = (ck_sel.get(name) if isinstance(ck_sel, dict)
                   else ("latest" if ck_sel else None))
            inv[name] = {
                "type": h.module_type,
                "params": (sum(v.numel() for v in h.module.state_dict().values())
                           if isinstance(h.module, torch.nn.Module) else 0),
                "checkpoints": [p.name for p in
                                Pipeline.get_checkpoints(self.model_path, name)],
                "emas": Pipeline.get_available_emas(self.model_path, name),
                "loaded_checkpoint": sel or "root",
                "loaded_ema": ema_sel.get(name) or "none",
            }
        self.state["inventory"] = inv

    def cmd_get_module_state_dict(self) -> None:
        """The module's weights as the JAX package's flat dict: fp32 numpy
        under its '/'-joined keys, 0-d leaves as (1,) under ``#0d`` keys, as
        JAX ``_flatten`` writes them."""
        from ..weights import to_flat
        h = self.pipeline.modules[self.state.get("module_name", "unet")]
        self.state["module_state_dict"] = to_flat(h.module)

    def cmd_get_latent_shape(self) -> None:
        fmt = self.pipeline.format
        shape = fmt.get_sample_shape(1, self.state.get("audio_length"))
        dae_h = self.pipeline.modules.get("dae")
        if dae_h is not None:
            shape = dae_h.module.get_latent_shape(shape)
        self.state["latent_shape"] = tuple(int(s) for s in shape)

    # ---- loop -----------------------------------------------------------
    def run(self) -> None:
        logger.info("model server started on %s", self.device)
        while True:
            cmd = self.state.get("cmd")
            if cmd is None:
                time.sleep(0.1)
                continue
            if cmd == "shutdown":
                self.state["cmd"] = None
                logger.info("model server shutting down")
                return
            try:
                logger.debug("processing command '%s'", cmd)
                getattr(self, f"cmd_{cmd}")()
                self.state["error"] = None
            except Exception as e:
                err = f"error processing command '{cmd}': {e}"
                logger.error("%s\n%s", err, traceback.format_exc())
                self.state["error"] = err
            finally:
                self.state["cmd"] = None


def start_model_server(state, device="cuda") -> None:
    """Entry point of the server process."""
    ModelServer(state, device).run()


def launch(model_name: Optional[str] = None, device="cuda"):
    """Spawn the server process on ``device``; returns (process, shared state
    dict). With ``model_name``, the server's first command loads it."""
    # spawn both: a fork of a caller that holds CUDA or threads may deadlock
    ctx = multiprocessing.get_context("spawn")
    state = ctx.Manager().dict()
    proc = ctx.Process(target=start_model_server, args=(state, str(device)), daemon=True)
    proc.start()
    if model_name is not None:
        state["model_name"] = model_name
        state["cmd"] = "load_model"
    return proc, state
