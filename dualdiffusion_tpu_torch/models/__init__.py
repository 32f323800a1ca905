from .dae import DAE, DAEConfig, tiled_encode, tiled_encode_plan, top_pca_components
from .unet import UNet, UNetConfig
from .discriminator import Discriminator, DiscriminatorConfig
from .vae import VAE, VAEConfig
