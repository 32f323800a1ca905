"""Wiring: TrainerConfig + Pipeline -> (train step, TrainState, export fn,
EMA bank, batch adapter), selected by the module-trainer registry
(JAX: dualdiffusion_tpu/training/builders.py): "unet", "dae", "ddec" (the
pipeline's DAE a frozen teacher) and "dae_ddec" (both trained, the state's
module an ``nn.ModuleDict`` of "dae" and "ddec").

Each builder takes ``parallel``, the ``parallel.ParallelState`` of a
multi-process run (None on one process): the global batch then counts the
data-axis ranks, the optimizer averages gradients over them and the step
keeps this rank's rows of each draw. The trained module arrives already
made the same on every rank and sharded (``ParallelState.prepare``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import Axis
from ..utils import config_from_dict
from .ema import EMABank, EMAConfig
from .module_trainers import (DAETrainConfig, DDECTrainConfig, JointDAEDDECConfig,
                              make_dae_train_step, make_ddec_train_step,
                              make_joint_dae_ddec_train_step)
from .optim import Optimizer, build_optimizer, jax_param_paths, lr_schedule
from .sigma_sampler import SigmaSamplerConfig
from .train_state import UNetTrainConfig, init_train_state, make_unet_train_step
from .trainer import TrainerConfig, register_module_trainer


def make_optimizer(tconf: TrainerConfig, params, parallel=None) -> Optimizer:
    """The config's optimizer over ``params``, (JAX path, parameter) pairs
    (``jax_param_paths``) by which Muon routes; it averages the gradients
    over the data axis of ``parallel``."""
    lrc, oc = tconf.lr_schedule, tconf.optimizer
    lr = lr_schedule(lrc.lr_schedule, lrc.learning_rate, lrc.lr_warmup_steps,
                     lrc.lr_reference_steps, lrc.lr_decay_exponent, lrc.min_learning_rate)
    opt = build_optimizer(oc.optimizer, params, lr, betas=(oc.adam_beta1, oc.adam_beta2),
                          eps=oc.adam_epsilon, weight_decay=oc.weight_decay,
                          muon_patterns=tuple(oc.muon_patterns),
                          dynamic_clip_z=oc.dynamic_max_grad_norm_z,
                          max_grad_norm=oc.max_grad_norm)
    if parallel is not None:
        opt.axis = parallel.data
    return opt


def data_axis(parallel) -> Axis:
    return parallel.data if parallel is not None else Axis()


def total_batch(tconf: TrainerConfig, parallel=None) -> int:
    """Global batch = device batch x grad accum x data-axis width (JAX
    builders.py:61-64)."""
    return (tconf.device_batch_size * tconf.gradient_accumulation_steps
            * data_axis(parallel).size)


def make_ema_bank(tconf: TrainerConfig) -> Optional[EMABank]:
    if not tconf.emas:
        return None
    return EMABank([EMAConfig(name=k, **v) for k, v in tconf.emas.items()])


def export_fn(pipeline, module_name: str):
    from ..pipelines.pipeline import save_module

    def export(ckpt_dir, module, global_step: int = 0):
        h = pipeline.modules[module_name]
        save_module(ckpt_dir, module_name, h.module_type, h.config, module, global_step)
    return export


@register_module_trainer("unet")
def build_unet_trainer(pipeline, tconf: TrainerConfig, generator: torch.Generator,
                       parallel=None):
    """Latent-diffusion UNet training on pre-encoded latents."""
    model = pipeline.modules[tconf.module_name].module
    cfg = config_from_dict(UNetTrainConfig, dict(tconf.module_trainer_config))
    cfg.grad_accum_steps = tconf.gradient_accumulation_steps
    opt = make_optimizer(tconf, jax_param_paths(model), parallel)
    bank = make_ema_bank(tconf)
    step = make_unet_train_step(opt, bank, cfg, total_batch(tconf, parallel),
                                data=data_axis(parallel))
    state = init_train_state(model, opt, bank, cfg.sigma, generator)
    device = next(model.parameters()).device

    def batch_adapter(batch):
        # dataset latents are stored reference-layout (B, C, H, W); the
        # model is channel-last (B, H, W, C)
        lat = torch.as_tensor(batch["latents"], dtype=torch.float32).permute(0, 2, 3, 1)
        out = {"samples": lat.contiguous().to(device)}
        if "audio_embeddings" in batch:
            out["embeddings"] = torch.as_tensor(batch["audio_embeddings"],
                                                dtype=torch.float32).to(device)
        return out

    return step, state, export_fn(pipeline, tconf.module_name), bank, batch_adapter


@register_module_trainer("dae")
def build_dae_trainer(pipeline, tconf: TrainerConfig, generator: torch.Generator,
                      parallel=None):
    """DAE training on raw audio through the pipeline's format."""
    model = pipeline.modules[tconf.module_name].module
    cfg = config_from_dict(DAETrainConfig, dict(tconf.module_trainer_config))
    cfg.grad_accum_steps = tconf.gradient_accumulation_steps
    # the JAX DAE trainer's optimizer covers the "params" collection alone
    opt = make_optimizer(tconf, jax_param_paths(model, collection=False), parallel)
    bank = make_ema_bank(tconf)
    step = make_dae_train_step(pipeline.format, opt, bank, cfg, total_batch(tconf, parallel),
                               data_axis(parallel))
    state = init_train_state(model, opt, bank, SigmaSamplerConfig(), generator)
    device = next(model.parameters()).device
    return (step, state, export_fn(pipeline, tconf.module_name), bank,
            audio_batch_adapter(device))


def audio_batch_adapter(device):
    """Audio, and the audio embeddings where the batch has them, on ``device``."""
    def adapt(batch):
        out = {"audio": torch.as_tensor(batch["audio"], dtype=torch.float32).to(device)}
        if "audio_embeddings" in batch:
            out["audio_embeddings"] = torch.as_tensor(batch["audio_embeddings"],
                                                      dtype=torch.float32).to(device)
        return out
    return adapt


def _dae_of(pipeline, what: str):
    if "dae" not in pipeline.modules:
        raise ValueError(f"{what} needs a 'dae' module in the pipeline")
    return pipeline.modules["dae"]


@register_module_trainer("ddec")
def build_ddec_trainer(pipeline, tconf: TrainerConfig, generator: torch.Generator,
                       parallel=None):
    """DDEC training on raw audio; the pipeline's DAE is a frozen teacher,
    in neither the optimizer, the EMA nor the export."""
    model = pipeline.modules[tconf.module_name].module
    dae = _dae_of(pipeline, "ddec training").module
    dae.eval().requires_grad_(False)
    cfg = config_from_dict(DDECTrainConfig, dict(tconf.module_trainer_config))
    cfg.unet.grad_accum_steps = tconf.gradient_accumulation_steps
    opt = make_optimizer(tconf, jax_param_paths(model), parallel)
    bank = make_ema_bank(tconf)
    step = make_ddec_train_step(pipeline.format, dae, opt, bank, cfg,
                                total_batch(tconf, parallel), data_axis(parallel))
    step.teacher = dae          # the frozen DAE, for checks that it stays so
    state = init_train_state(model, opt, bank, cfg.unet.sigma, generator)
    device = next(model.parameters()).device
    return (step, state, export_fn(pipeline, tconf.module_name), bank,
            audio_batch_adapter(device))


@register_module_trainer("dae_ddec")
def build_joint_dae_ddec_trainer(pipeline, tconf: TrainerConfig, generator: torch.Generator,
                                 parallel=None):
    """Joint DAE + DDEC training: ``module_name`` names the DDEC, the DAE is
    the pipeline's "dae"; the checkpoints export both modules."""
    from ..pipelines.pipeline import save_module
    ddec_h = pipeline.modules[tconf.module_name]
    dae_h = _dae_of(pipeline, "joint training")
    module = torch.nn.ModuleDict({"dae": dae_h.module, "ddec": ddec_h.module})
    cfg = config_from_dict(JointDAEDDECConfig, dict(tconf.module_trainer_config))
    cfg.grad_accum_steps = tconf.gradient_accumulation_steps
    # JAX's joint tree: {"dae": the DAE's "params" collection, "ddec": its variables}
    opt = make_optimizer(tconf, jax_param_paths(dae_h.module, False, "dae/")
                         + jax_param_paths(ddec_h.module, True, "ddec/"), parallel)
    bank = make_ema_bank(tconf)
    step = make_joint_dae_ddec_train_step(pipeline.format, opt, bank, cfg,
                                          total_batch(tconf, parallel), data_axis(parallel))
    state = init_train_state(module, opt, bank, cfg.ddec.unet.sigma, generator)
    device = next(module.parameters()).device

    def export(ckpt_dir, module, global_step: int = 0):
        for h in (dae_h, ddec_h):
            save_module(ckpt_dir, h.name, h.module_type, h.config, module[h.name],
                        global_step)

    return step, state, export, bank, audio_batch_adapter(device)
