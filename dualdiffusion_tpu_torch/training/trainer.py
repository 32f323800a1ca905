"""The training loop: epochs, checkpoint/resume, per-step logs
(JAX: dualdiffusion_tpu/training/trainer.py; reference: src/training/
trainer.py).

* config dataclasses with the JAX package's field names and defaults, and
  the module-trainer registry;
* checkpoints (``<module>_checkpoint-<step>/``): the module in model-directory
  format, every EMA profile (``<module>/ema_<name>.safetensors``), the
  optimizer, clip, sigma-pdf, counter and generator state (``train_state.pt``),
  ``trainer_state.json`` and a snapshot of the port's source
  (``src_snapshot/``), rotated by ``checkpoints_total_limit``; resume
  restores all of it, fast-forwards the epoch to its next batch and writes
  ``<model>/src_diff_<stamp>.txt`` when the source changed since. A state
  whose module is an ``nn.ModuleDict`` (the joint DAE + DDEC trainer) keeps
  each member in its own folder of the checkpoint, with its own EMA files
  and ``<member>_ema_archive/``;
* ``cpu_offload`` EMA profiles in host memory, updated each step by an
  ``AsyncHostEMA`` worker, seeded from the weights before the first step,
  checkpointed, restored and validated as the device ones;
* per-step scalars (loss, grad norm, lr, EMA betas, bucketed losses) to the
  log, ``Trainer.history`` and tensorboardX under ``<model>/logs/<module>``
  (where tensorboardX is installed: without it, to the log only), and their
  means at each epoch's end; per-sample losses to
  ``per_sample_losses.json``; bf16 EMA archives; SwitchEMA; validation over
  the train weights and the EMA profiles;
* a ``torch.profiler`` trace of the steps [start, stop) of
  ``profile_steps`` into ``profile_dir`` (default ``<model>/profiles``).
"""

from __future__ import annotations

import contextlib
import datetime
import difflib
import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..utils import load_json, load_safetensors, save_json, save_safetensors
from ..weights import flat_to_state, state_to_flat
from .ema import AsyncHostEMA, EMABank, power_function_beta, save_ema_archive, trained_tensors
from .optim import lr_schedule, normalize_mp_weights
from .train_state import TrainState

logger = logging.getLogger(__name__)

#: the port's package, whose source each checkpoint snapshots
SOURCE_ROOT = Path(__file__).resolve().parents[1]
SOURCE_SUFFIXES = (".py", ".cu", ".cuh")


@dataclass
class LRScheduleConfig:
    lr_schedule: str = "edm2"
    learning_rate: float = 3e-3
    lr_warmup_steps: int = 5000
    lr_reference_steps: int = 70000
    lr_decay_exponent: float = 1.0
    min_learning_rate: float = 0.0


@dataclass
class OptimizerConfig:
    optimizer: str = "adamw"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_epsilon: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 10.0
    dynamic_max_grad_norm_z: Optional[float] = 4.0
    muon_patterns: tuple = ("*w_mp*",)


@dataclass
class DataLoaderConfig:
    use_pre_encoded_latents: bool = True
    load_datatypes: tuple = ("latents", "audio_embeddings")
    dataloader_num_workers: int = 0
    prefetch_batches: int = 2
    raw_crop_width: int = 1408768
    latents_crop_width: int = 688
    filter_unnormalized_samples: bool = False


@dataclass
class LoggingConfig:
    logging_dir: Optional[str] = None
    tensorboard_http_port: Optional[int] = None
    per_sample_loss_logging: bool = True


@dataclass
class ParallelConfig:
    """Mesh layout of the JAX trainer; the port trains on one device."""
    model_axis: int = 1
    fsdp: bool = False
    num_dcn_slices: int = 1


@dataclass
class TrainerConfig:
    model_path: str = ""
    model_name: str = "model"
    module_name: str = "unet"            # which pipeline module is trained
    module_trainer: str = "unet"         # registry key
    module_trainer_config: dict = field(default_factory=dict)

    seed: int = 42
    device_batch_size: int = 8
    gradient_accumulation_steps: int = 8
    validation_device_batch_size: int = 8
    num_train_epochs: int = 500000
    max_train_steps: int = 1000000

    num_validation_epochs: int = 10      # validate every N epochs
    strict_checkpoint_time: bool = False
    min_checkpoint_time: int = 3600
    checkpoints_total_limit: int = 1
    enable_debug_mode: bool = False
    enable_anomaly_detection: bool = False
    profile_steps: Optional[tuple] = None
    profile_dir: Optional[str] = None

    lr_schedule: LRScheduleConfig = field(default_factory=LRScheduleConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    emas: Dict[str, dict] = field(default_factory=dict)


# module-trainer registry: name -> builder(pipeline, config, generator)
_MODULE_TRAINER_REGISTRY: Dict[str, Callable] = {}


def register_module_trainer(name: str):
    def deco(fn):
        _MODULE_TRAINER_REGISTRY[name] = fn
        return fn
    return deco


def get_module_trainer(name: str) -> Callable:
    if name not in _MODULE_TRAINER_REGISTRY:
        raise KeyError(f"unknown module trainer '{name}'; "
                       f"known: {sorted(_MODULE_TRAINER_REGISTRY)}")
    return _MODULE_TRAINER_REGISTRY[name]


class TrainLogger:
    """Accumulates channel -> running mean over an epoch (logged at its end)."""

    def __init__(self) -> None:
        self.channels: Dict[str, List[float]] = {}

    def add_logs(self, logs: Dict[str, Any]) -> None:
        for k, v in logs.items():
            v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            if v.ndim == 0:
                self.channels.setdefault(k, []).append(float(v))

    def get_logs(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self.channels.items() if v}

    def clear(self) -> None:
        self.channels.clear()


class Trainer:
    """The host-side loop around a train step."""

    def __init__(self, config: TrainerConfig, train_step: Callable, init_state: TrainState,
                 dataloader: Iterable, ema_bank: Optional[EMABank] = None,
                 validation_dataloader: Optional[Iterable] = None,
                 export_module_fn: Optional[Callable] = None,
                 eval_step: Optional[Callable] = None):
        """train_step(state, batch) -> logs, updating ``state`` in place.
        export_module_fn(path, module, global_step) writes the module in
        model-directory format. eval_step(module, batch, generator) -> loss
        enables validation over the train weights and every EMA profile."""
        self.config = config
        self.train_step = train_step
        self.state = init_state
        self.dataloader = dataloader
        self.validation_dataloader = validation_dataloader
        self.ema_bank = ema_bank
        self.export_module_fn = export_module_fn
        self.eval_step = eval_step
        self.train_logger = TrainLogger()
        self.history: List[Dict[str, float]] = []
        self.last_checkpoint_time = time.time()
        self.total_train_hours = 0.0
        self.epoch = 0
        # batches consumed in the current epoch (mid-epoch resume)
        self.epoch_batch_idx = 0
        self._resume_skip_batches = 0
        self._pending_sample_losses: Dict[str, float] = {}
        # the cpu_offload EMA profiles' worker; ``host_ema`` syncs it before a read
        self._async_host_ema: Optional[AsyncHostEMA] = None
        self._profiler = None
        self.trace_path: Optional[Path] = None
        self.writer = self._make_writer()
        lrc = config.lr_schedule
        self._lr_fn = lr_schedule(lrc.lr_schedule, lrc.learning_rate, lrc.lr_warmup_steps,
                                  lrc.lr_reference_steps, lrc.lr_decay_exponent,
                                  lrc.min_learning_rate)
        self.total_batch_size = config.device_batch_size * config.gradient_accumulation_steps
        if config.enable_anomaly_detection:
            torch.autograd.set_detect_anomaly(True)
            logger.info("anomaly detection enabled")

    # ---- observability ----------------------------------------------------
    def _make_writer(self):
        """A tensorboardX writer under ``logging.logging_dir``, else
        ``<model>/logs/<module>``; None without a directory or without
        tensorboardX."""
        logdir = self.config.logging.logging_dir
        if logdir is None and self.config.model_path:
            logdir = os.path.join(self.config.model_path, "logs", self.config.module_name)
        if logdir is None:
            return None
        try:
            from tensorboardX import SummaryWriter
            os.makedirs(logdir, exist_ok=True)
            return SummaryWriter(logdir)
        except Exception:
            logger.warning("tensorboard unavailable; metrics to log only")
            return None

    def _log_scalars(self, logs: Dict[str, float], step: int) -> None:
        if self.writer is not None:
            for k, v in logs.items():
                self.writer.add_scalar(k, v, step)

    def _maybe_profile(self, step: int) -> None:
        """A ``torch.profiler`` trace over the steps [start, stop) of
        ``profile_steps``, written when it stops."""
        cfg = self.config
        if cfg.profile_steps is None:
            return
        start, stop = cfg.profile_steps
        if step == start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profile_start = step
            logger.info("profiler trace started at step %d", step)
        elif step >= stop and self._profiler is not None:
            self._stop_profile(step)

    def _stop_profile(self, step: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        d = Path(self.config.profile_dir or os.path.join(self.config.model_path or ".",
                                                         "profiles"))
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{self.config.module_name}_steps_{self._profile_start}-{step}.trace.json"
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        self.trace_path = path
        logger.info("profiler trace stopped -> %s", path)

    @property
    def device(self) -> torch.device:
        return next(self.state.module.parameters()).device

    def _members(self) -> Dict[str, str]:
        """Each saved module's name -> its prefix in the state's keys: the
        trained module under ``module_name``, or each member of a
        ``ModuleDict`` under its own name."""
        module = self.state.module
        if isinstance(module, torch.nn.ModuleDict):
            return {name: f"{name}." for name in module}
        return {self.config.module_name: ""}

    @staticmethod
    def _part(tensors: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
        return {k[len(prefix):]: v for k, v in tensors.items() if k.startswith(prefix)}

    # ---- host-offloaded EMA profiles ------------------------------------------
    @property
    def host_ema(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """The ``cpu_offload`` profiles (fp32 CPU tensors), with every
        submitted step applied."""
        if self._async_host_ema is None:
            return None
        self._async_host_ema.sync()
        return self._async_host_ema.profiles

    @host_ema.setter
    def host_ema(self, value) -> None:
        if value is None and self._async_host_ema is None:
            return
        self._host_ema_worker().restore(value)

    def _host_ema_worker(self) -> AsyncHostEMA:
        if self._async_host_ema is None:
            self._async_host_ema = AsyncHostEMA(self.ema_bank, self.total_batch_size)
        return self._async_host_ema

    def _ema_profile(self, ema_name: str) -> Optional[Dict[str, torch.Tensor]]:
        """One EMA profile's current tensors, on the device or in host memory."""
        if ema_name in self.ema_bank.offloaded:
            host = self.host_ema
            return None if host is None else host.get(ema_name)
        return self.state.ema_state[ema_name]

    def _update_host_emas(self) -> None:
        """Submit the step just taken to the host profiles' worker; its beta
        uses the counters from before the step, as ``EMABank.update``."""
        if self.ema_bank is None or not self.ema_bank.offloaded:
            return
        st = self.state
        self._host_ema_worker().update(trained_tensors(st.module), st.total_samples_processed,
                                       st.global_step)

    # ---- checkpointing ------------------------------------------------------
    def _checkpoint_dir(self, step: int) -> Path:
        return Path(self.config.model_path) / f"{self.config.module_name}_checkpoint-{step}"

    def save_checkpoint(self) -> Path:
        st = self.state
        ckpt = self._checkpoint_dir(st.global_step)
        ckpt.mkdir(parents=True, exist_ok=True)
        if self.export_module_fn is not None:
            self.export_module_fn(ckpt, st.module, st.global_step)
        if self.ema_bank is not None:
            for ema_name, cfg in self.ema_bank.configs.items():
                profile = self._ema_profile(ema_name)
                if profile is None:
                    continue        # a host profile not seeded yet
                for name, prefix in self._members().items():
                    save_safetensors(state_to_flat(self._part(profile, prefix)),
                                     ckpt / name / f"ema_{ema_name}.safetensors",
                                     metadata={"std": str(cfg.std),
                                               "global_step": str(st.global_step)})
        torch.save({"optimizer": st.optimizer.state_dict(),
                    "sigma_pdf": st.sigma_pdf.cpu(),
                    "generator": st.generator.get_state(),
                    "global_step": st.global_step,
                    "total_samples_processed": st.total_samples_processed},
                   ckpt / "train_state.pt")
        save_json({"global_step": st.global_step, "epoch": self.epoch,
                   "epoch_batch_idx": self.epoch_batch_idx,
                   "total_samples_processed": st.total_samples_processed,
                   "total_train_hours": self.total_train_hours}, ckpt / "trainer_state.json")
        self._snapshot_source(ckpt / "src_snapshot")
        if self.writer is not None:
            self.writer.flush()
        self._rotate_checkpoints()
        self.last_checkpoint_time = time.time()
        logger.info("saved checkpoint %s", ckpt)
        return ckpt

    @staticmethod
    def _source_files(root: Path) -> List[Path]:
        return sorted(p for p in root.rglob("*") if p.suffix in SOURCE_SUFFIXES
                      and "build" not in p.relative_to(root).parts[:-1])

    def _snapshot_source(self, dst: Path) -> None:
        """Copy the port's source (Python and CUDA) into ``dst``."""
        for src in self._source_files(SOURCE_ROOT):
            out = dst / src.relative_to(SOURCE_ROOT)
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, out)

    def _write_src_diff(self, ckpt: Path) -> Optional[Path]:
        """A unified diff of the checkpoint's source snapshot against the
        package as it is now, in ``<model>/src_diff_<stamp>.txt``, when they
        differ."""
        snap = ckpt / "src_snapshot"
        if not snap.is_dir():
            return None
        diffs: List[str] = []
        for old in self._source_files(snap):
            rel = old.relative_to(snap)
            new = SOURCE_ROOT / rel
            new_lines = new.read_text().splitlines(keepends=True) if new.is_file() else []
            diffs += difflib.unified_diff(old.read_text().splitlines(keepends=True), new_lines,
                                          fromfile=f"snapshot/{rel}", tofile=f"worktree/{rel}")
        if not diffs:
            return None
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        out = Path(self.config.model_path) / f"src_diff_{stamp}.txt"
        out.write_text("".join(diffs))
        logger.info("source changed since the checkpoint; diff at %s", out)
        return out

    def _rotate_checkpoints(self) -> None:
        limit = self.config.checkpoints_total_limit
        if limit <= 0:
            return
        from ..pipelines.pipeline import Pipeline
        for old in Pipeline.get_checkpoints(self.config.model_path,
                                            self.config.module_name)[:-limit]:
            shutil.rmtree(old, ignore_errors=True)
            logger.info("rotated out checkpoint %s", old)

    @torch.no_grad()
    def load_checkpoint(self) -> bool:
        """Restore the latest checkpoint, if any: weights and buffers, EMA profiles,
        optimizer/clip/sigma-pdf/counter/generator state, epoch position."""
        from ..pipelines.pipeline import Pipeline
        ckpt = Pipeline.get_latest_checkpoint(self.config.model_path, self.config.module_name)
        if ckpt is None:
            return False
        st = self.state
        params = trained_tensors(st.module)
        for name, prefix in self._members().items():
            module_dir = ckpt / name
            part = self._part(params, prefix)
            for k, v in flat_to_state(part, load_safetensors(module_dir / f"{name}.safetensors")
                                      ).items():
                part[k].copy_(v)
            if self.ema_bank is not None:
                for ema_name in st.ema_state:
                    profile = self._part(st.ema_state[ema_name], prefix)
                    flat = load_safetensors(module_dir / f"ema_{ema_name}.safetensors")
                    for k, v in flat_to_state(profile, flat).items():
                        profile[k].copy_(v)
        if self.ema_bank is not None and self.ema_bank.offloaded:
            # the host profiles, as fp32 CPU tensors under the state's keys
            like = {k: v.detach().cpu().float() for k, v in params.items()}
            restored = {}
            for ema_name in self.ema_bank.offloaded:
                profile: Dict[str, torch.Tensor] = {}
                for name, prefix in self._members().items():
                    path = ckpt / name / f"ema_{ema_name}.safetensors"
                    if path.is_file():
                        part = flat_to_state(self._part(like, prefix), load_safetensors(path))
                        profile.update({prefix + k: v for k, v in part.items()})
                if profile:
                    restored[ema_name] = profile
            self.host_ema = restored or None
        ts = torch.load(ckpt / "train_state.pt", map_location="cpu")
        st.optimizer.load_state_dict(ts["optimizer"])
        st.sigma_pdf = ts["sigma_pdf"].to(st.sigma_pdf.device)
        st.generator.set_state(ts["generator"])
        st.global_step = int(ts["global_step"])
        st.total_samples_processed = int(ts["total_samples_processed"])
        meta = load_json(ckpt / "trainer_state.json")
        self.epoch = meta.get("epoch", 0)
        self.total_train_hours = meta.get("total_train_hours", 0.0)
        self.epoch_batch_idx = meta.get("epoch_batch_idx", 0)
        self._resume_skip_batches = self.epoch_batch_idx
        self._write_src_diff(ckpt)
        logger.info("resumed from %s at step %d (epoch %d, fast-forward %d batches)",
                    ckpt, st.global_step, self.epoch, self._resume_skip_batches)
        return True

    # ---- main loop -----------------------------------------------------------
    def train(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.config
        max_steps = max_steps or cfg.max_train_steps
        trigger = Path(cfg.model_path) / "_save_checkpoint" if cfg.model_path else None
        if self.ema_bank is not None and self.ema_bank.offloaded and self.host_ema is None:
            # seeded from the weights before the first step, as the device profiles
            self.host_ema = self.ema_bank.host_init(trained_tensors(self.state.module))
        try:
            return self._train(max_steps, trigger)
        finally:
            if self._profiler is not None:
                self._stop_profile(self.state.global_step)
            if self.writer is not None:
                self.writer.flush()

    def _train(self, max_steps: int, trigger: Optional[Path]) -> TrainState:
        cfg = self.config
        name = cfg.module_name
        while self.epoch < cfg.num_train_epochs:
            for batch in self._epoch_iter():
                t0 = time.perf_counter()
                paths = batch.pop("paths", None)
                self._maybe_profile(self.state.global_step)
                logs = self.train_step(self.state, batch)
                self.epoch_batch_idx += 1
                self._update_host_emas()
                step = self.state.global_step
                loss = float(logs["loss"])        # waits for the step's device work
                if not np.isfinite(loss):
                    logger.error("non-finite loss at step %d", step)
                seconds = time.perf_counter() - t0
                self.total_train_hours += seconds / 3600.0
                grad_norm = float(logs["grad_norm"])
                scalars = {f"loss/{name}": loss, f"grad_norm/{name}": grad_norm,
                           "perf/steps_per_sec": 1.0 / max(seconds, 1e-9),
                           "perf/total_train_hours": self.total_train_hours,
                           f"learn_rate/{name}": float(self._lr_fn(step))}
                for k, v in logs.items():
                    if k not in ("loss", "grad_norm") and v.dim() == 0:
                        scalars[f"{k}/{name}"] = float(v)
                if self.ema_bank is not None:
                    t, bs = max(self.state.total_samples_processed, 1), self.total_batch_size
                    for ema_name, ecfg in self.ema_bank.configs.items():
                        if ecfg.std is not None:
                            scalars[f"ema_betas/{ema_name}"] = power_function_beta(
                                ecfg.std, t + bs, bs)
                if step % 25 == 0 and self.device.type == "cuda":
                    scalars["device_stats/mem_used_mb"] = \
                        torch.cuda.memory_allocated(self.device) / 1e6
                if "bucket_sums" in logs:
                    sums = logs["bucket_sums"].cpu().numpy()
                    counts = logs["bucket_counts"].cpu().numpy()
                    for i in range(len(sums)):
                        if counts[i] > 0:
                            scalars[f"loss_buckets/{name}_{i}"] = float(sums[i] / counts[i])
                self.train_logger.add_logs(scalars)
                self._log_scalars(scalars, step)
                self.history.append({"step": step, "loss": loss, "grad_norm": grad_norm,
                                     "seconds": seconds})
                logger.info("step %d epoch %d loss %.6g grad_norm %.6g lr %.6g %.3f s", step,
                            self.epoch, loss, grad_norm, scalars[f"learn_rate/{name}"], seconds)

                if (paths is not None and cfg.logging.per_sample_loss_logging
                        and "sample_losses" in logs):
                    self._record_sample_losses(paths, logs["sample_losses"])
                self._maybe_archive_emas(step)

                should_ckpt = (cfg.strict_checkpoint_time and
                               time.time() - self.last_checkpoint_time > cfg.min_checkpoint_time)
                if trigger is not None and trigger.exists():
                    trigger.unlink()
                    should_ckpt = True
                if should_ckpt and cfg.model_path:
                    self.save_checkpoint()
                if step >= max_steps:
                    self._flush_sample_losses()
                    if cfg.model_path:
                        self.save_checkpoint()
                    return self.state

            self.epoch += 1
            self.epoch_batch_idx = 0
            self._flush_sample_losses()
            logger.info("epoch %d means: %s", self.epoch - 1,
                        {k: round(v, 6) for k, v in self.train_logger.get_logs().items()})
            self.train_logger.clear()
            if (self.eval_step is not None and self.validation_dataloader is not None
                    and self.epoch % max(cfg.num_validation_epochs, 1) == 0):
                self.validate()
            if self.ema_bank is not None:
                switched = self.ema_bank.maybe_switch(self.state.ema_state, self.state.module,
                                                      self.epoch, self.state.global_step,
                                                      normalize_mp_weights)
                if switched:
                    logger.info("switch EMA '%s' loaded into train weights", switched)
            if (cfg.model_path and not cfg.strict_checkpoint_time
                    and time.time() - self.last_checkpoint_time > cfg.min_checkpoint_time):
                self.save_checkpoint()
        return self.state

    def _epoch_iter(self):
        """One epoch's batches. A dataloader with ``epoch_iter(epoch,
        skip_batches)`` gets the epoch (its shuffle seed) and the mid-epoch
        fast-forward; a plain iterable restarts the epoch on resume."""
        dl = self.dataloader
        skip, self._resume_skip_batches = self._resume_skip_batches, 0
        if hasattr(dl, "epoch_iter"):
            return dl.epoch_iter(self.epoch, skip)
        if skip:
            logger.warning("dataloader has no epoch_iter(); cannot fast-forward %d batches — "
                           "this epoch restarts from its first batch", skip)
            self.epoch_batch_idx = 0
        return iter(dl)

    # ---- EMA archives, validation, per-sample losses ---------------------
    def _maybe_archive_emas(self, step: int) -> None:
        """bf16 EMA snapshots every ``num_archive_steps`` steps."""
        if self.ema_bank is None or not self.config.model_path or step == 0:
            return
        for ema_name, cfg in self.ema_bank.configs.items():
            n = cfg.num_archive_steps
            profile = self._ema_profile(ema_name) if n and step % n == 0 else None
            if profile is not None:
                for name, prefix in self._members().items():
                    path = (Path(self.config.model_path) / f"{name}_ema_archive"
                            / f"{step}_ema_{ema_name}.safetensors")
                    save_ema_archive(self._part(profile, prefix), path,
                                     step, self.state.total_samples_processed, cfg.std or 0.0)
                logger.info("archived ema '%s' at step %d", ema_name, step)

    @contextlib.contextmanager
    def _weights_of(self, profile: Optional[Dict[str, torch.Tensor]]):
        """The module with an EMA profile's weights in place of its own."""
        if profile is None:
            yield self.state.module
            return
        params = trained_tensors(self.state.module)
        saved = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(profile[k])
        try:
            yield self.state.module
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])

    def validate(self) -> Dict[str, float]:
        """Validation loss of the train weights and of every EMA profile
        marked include_in_validation, at a fixed seed."""
        candidates: Dict[str, Optional[Dict[str, torch.Tensor]]] = {"train": None}
        if self.ema_bank is not None:
            for ema_name in self.ema_bank.validation_emas():
                profile = self._ema_profile(ema_name)
                if profile is not None:
                    candidates[f"ema_{ema_name}"] = profile
        results: Dict[str, float] = {}
        for cand, profile in candidates.items():
            generator = torch.Generator(device=self.device).manual_seed(0)
            losses = []
            with self._weights_of(profile) as module:
                for batch in self.validation_dataloader:
                    batch = dict(batch)
                    batch.pop("paths", None)
                    losses.append(float(self.eval_step(module, batch, generator)))
            if losses:
                results[cand] = float(np.mean(losses))
        self._log_scalars({f"loss_validation/{k}": v for k, v in results.items()},
                          self.state.global_step)
        logger.info("validation @ step %d: %s", self.state.global_step,
                    {k: round(v, 4) for k, v in results.items()})
        return results

    def _record_sample_losses(self, paths, per_sample: torch.Tensor) -> None:
        if not self.config.model_path:
            return
        for p, v in zip(paths, per_sample.detach().cpu().reshape(-1).tolist()):
            self._pending_sample_losses[str(p)] = float(v)

    def _flush_sample_losses(self) -> None:
        if not self._pending_sample_losses or not self.config.model_path:
            return
        out = Path(self.config.model_path) / "per_sample_losses.json"
        data = load_json(out) if out.is_file() else {}
        data.update(self._pending_sample_losses)
        self._pending_sample_losses.clear()
        save_json(dict(sorted(data.items(), key=lambda kv: -kv[1])), out)
