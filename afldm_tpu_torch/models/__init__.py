from .layers import (Attention, Downsample2D, KVHelper, ResnetBlock2D,
                     TimestepEmbedding, Upsample2D, WrappedActivation,
                     get_timestep_embedding)
from .unet2d import UNet2DConfig, UNet2DModel, UNetMidBlock2D
from .vae import (AutoencoderKL, AutoencoderKLConfig, gaussian_kl,
                  gaussian_sample)
from .discriminator import Discriminator, hinge_d_loss, hinge_g_loss
from .convert import from_flax

__all__ = [
    "Attention", "Downsample2D", "KVHelper", "ResnetBlock2D",
    "TimestepEmbedding", "Upsample2D", "WrappedActivation",
    "get_timestep_embedding", "UNet2DConfig", "UNet2DModel",
    "UNetMidBlock2D", "AutoencoderKL", "AutoencoderKLConfig",
    "gaussian_kl", "gaussian_sample", "Discriminator", "hinge_d_loss",
    "hinge_g_loss", "from_flax",
]
