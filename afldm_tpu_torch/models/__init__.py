from .layers import (Attention, Downsample2D, KVHelper, ResnetBlock2D,
                     TimestepEmbedding, Upsample2D, WrappedActivation,
                     get_timestep_embedding)
from .unet2d import UNet2DConfig, UNet2DModel, UNetMidBlock2D
from .vae import AutoencoderKL, AutoencoderKLConfig, gaussian_sample
from .convert import from_flax

__all__ = [
    "Attention", "Downsample2D", "KVHelper", "ResnetBlock2D",
    "TimestepEmbedding", "Upsample2D", "WrappedActivation",
    "get_timestep_embedding", "UNet2DConfig", "UNet2DModel",
    "UNetMidBlock2D", "AutoencoderKL", "AutoencoderKLConfig",
    "gaussian_sample", "from_flax",
]
