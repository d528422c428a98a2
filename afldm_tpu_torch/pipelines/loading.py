"""Build a pipeline with random weights from a seed (the published
checkpoints are not in the repository). Weights are drawn on the CPU from
an explicit ``torch.Generator`` and then moved, so a seed gives the same
weights on every device."""

import math

import torch

from ..models.unet2d import UNet2DConfig, UNet2DModel
from ..models.unet2d_condition import (UNet2DConditionConfig,
                                       UNet2DConditionModel)
from ..models.vae import AutoencoderKL, AutoencoderKLConfig
from ..ops.ideal_lpf import set_af_precision
from ..schedulers.ddim import DDIMScheduler
from .interpolation import ImageInterpolationPipeline
from .ldm import LDMPipeline


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card. Without a card and without an explicit device it raises: the
    port never carries on on the CPU unless asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


@torch.no_grad()
def init_random_weights(module: torch.nn.Module, generator: torch.Generator):
    """LeCun-normal conv and linear weights (std 1/sqrt(fan_in)), zero
    biases, unit norm scales: the Flax initialisers the JAX package uses,
    drawn from ``generator`` in parameter order."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))


def init_random_pipeline(unet_config, vae_config, scheduler_config,
                         seed: int = 0, device=None) -> LDMPipeline:
    """Configs may be dataclasses or diffusers-style dicts (the UNet dict is
    read as alias-free, like the JAX package's loader). Sets exact float32
    (``set_af_precision("highest")``)."""
    return LDMPipeline(*_random_modules(UNet2DConfig, UNet2DModel,
                                        unet_config, vae_config, seed,
                                        device),
                       DDIMScheduler.from_config(scheduler_config))


def init_random_interp_pipeline(unet_config, vae_config, scheduler_config,
                                seed: int = 0,
                                device=None) -> ImageInterpolationPipeline:
    """The image-interpolation pipeline (SD-family conditioned UNet,
    AF-VAE) with random weights from ``seed``; the configs as for
    ``init_random_pipeline``."""
    vae, unet = _random_modules(UNet2DConditionConfig, UNet2DConditionModel,
                                unet_config, vae_config, seed, device)
    return ImageInterpolationPipeline(
        vae, unet, DDIMScheduler.from_config(scheduler_config))


def _random_modules(config_cls, unet_cls, unet_config, vae_config, seed,
                    device):
    """(vae, unet) with weights drawn from ``seed``, on ``device``."""
    device = resolve_device(device)
    set_af_precision("highest")
    if isinstance(unet_config, dict):
        unet_config = config_cls.from_diffusers(unet_config, alias_free=True)
    if isinstance(vae_config, dict):
        vae_config = AutoencoderKLConfig.from_diffusers(vae_config)
    gen = torch.Generator().manual_seed(seed)
    unet = unet_cls(unet_config)
    vae = AutoencoderKL(vae_config)
    init_random_weights(unet, gen)
    init_random_weights(vae, gen)
    return vae.to(device).eval(), unet.to(device).eval()
