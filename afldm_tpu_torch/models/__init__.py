from .layers import (Attention, Downsample2D, KVHelper, ResnetBlock2D,
                     TimestepEmbedding, Upsample2D, WrappedActivation,
                     get_timestep_embedding)
from .unet2d import UNet2DConfig, UNet2DModel, UNetMidBlock2D
from .vae import (AutoencoderKL, AutoencoderKLConfig, gaussian_kl,
                  gaussian_sample)
from .discriminator import Discriminator, hinge_d_loss, hinge_g_loss
from .convert import from_flax, text_encoder_from_flax
from .attention_blocks import (BasicTransformerBlock, CrossAttention,
                               FeedForward, Transformer2DModel)
from .unet2d_condition import UNet2DConditionConfig, UNet2DConditionModel
from .controlnet import ControlNetConfig, ControlNetModel

__all__ = [
    "Attention", "Downsample2D", "KVHelper", "ResnetBlock2D",
    "TimestepEmbedding", "Upsample2D", "WrappedActivation",
    "get_timestep_embedding", "UNet2DConfig", "UNet2DModel",
    "UNetMidBlock2D", "AutoencoderKL", "AutoencoderKLConfig",
    "gaussian_kl", "gaussian_sample", "Discriminator", "hinge_d_loss",
    "hinge_g_loss", "from_flax", "text_encoder_from_flax",
    "BasicTransformerBlock", "CrossAttention",
    "FeedForward", "Transformer2DModel", "UNet2DConditionConfig",
    "UNet2DConditionModel", "ControlNetConfig", "ControlNetModel",
]
