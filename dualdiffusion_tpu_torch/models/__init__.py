from . import mp
from .layers import (MPConv, MPFourier, AdaptiveGroupBalance, FilteredDownsample2D,
                     normalize_weight, filtered_downsample_1d, filtered_upsample_1d,
                     filtered_downsample_2d, filtered_upsample_2d, filtered_mp_silu_2d,
                     filtered_downsample_3d, filtered_upsample_3d, filtered_mp_silu_3d,
                     filtered_downsample_1d3, filtered_upsample_1d3, MP_WEIGHT_NAME,
                     RAW_WEIGHT_NAME)
from .dae import DAE, DAEConfig, tiled_encode, tiled_encode_plan, top_pca_components
from .unet import UNet, UNetConfig
from .discriminator import Discriminator, DiscriminatorConfig
from .vae import VAE, VAEConfig
