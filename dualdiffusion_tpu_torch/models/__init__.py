from .dae import DAE, DAEConfig
from .unet import UNet, UNetConfig
