"""UNet, DAE and DDEC training (JAX: dualdiffusion_tpu/training): the train steps,
losses, sigma sampler, optimizer chain, EMA bank and the trainer loop.
Importing ``builders`` registers the module trainers."""
from .ema import EMABank, EMAConfig
from .module_trainers import (DAEMicroDraws, DAETrainConfig, DDECPrepareDraws,
                              DDECTrainConfig, JointDAEDDECConfig, JointMicroDraws,
                              JointStepDraws, ddec_sample_shape, draw_dae_step, draw_joint_step,
                              make_dae_train_step, make_ddec_eval_step, make_ddec_train_step,
                              make_joint_dae_ddec_train_step)
from .optim import build_optimizer, lr_schedule, normalize_mp_weights
from .sigma_sampler import SigmaSampler, SigmaSamplerConfig
from .train_state import (EvalDraws, MicroDraws, StepDraws, TrainState, UNetTrainConfig,
                          draw_unet_step, init_train_state, make_unet_eval_step,
                          make_unet_train_step)
from .trainer import Trainer, TrainerConfig, get_module_trainer
