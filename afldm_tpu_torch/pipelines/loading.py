"""Build a pipeline with random weights from a seed (the published
checkpoints are not in the repository), or load one that this port's
``LDMTrainer.save_pipeline`` wrote. Weights are drawn on the CPU from an
explicit ``torch.Generator`` and then moved, so a seed gives the same
weights on every device."""

import json
import math
import os

import torch

from ..models.controlnet import ControlNetConfig, ControlNetModel
from ..models.unet2d import UNet2DConfig, UNet2DModel
from ..models.unet2d_condition import (UNet2DConditionConfig,
                                       UNet2DConditionModel)
from ..models.vae import AutoencoderKL, AutoencoderKLConfig
from ..ops.ideal_lpf import set_af_precision
from ..schedulers.ddim import DDIMScheduler
from ..schedulers.i2sb import I2SBScheduler
from .i2sb import I2SBLDMPipeline
from .interpolation import ImageInterpolationPipeline
from .ldm import LDMPipeline
from .normal_control import NormControlPipeline
from .video_editing import VideoEquivEditingPipeline

# the FFHQ pipeline's DDIM, for a pipeline directory without a scheduler
DEFAULT_SCHEDULER = {
    "num_train_timesteps": 1000, "beta_schedule": "scaled_linear",
    "beta_start": 0.0015, "beta_end": 0.0195, "clip_sample": False,
    "set_alpha_to_one": False, "steps_offset": 1,
    "timestep_spacing": "leading"}


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
                         seed: int = 0, device=None,
                         cls=LDMPipeline) -> LDMPipeline:
    """Configs may be dataclasses or diffusers-style dicts (the UNet dict is
    read as alias-free, like the JAX package's loader). ``cls`` is
    ``LDMPipeline`` (DDIM) or ``I2SBLDMPipeline`` (``I2SBScheduler``, e.g.
    from ``configs/sr/i2sb_scheduler.json``). Sets exact float32
    (``set_af_precision("highest")``)."""
    sched_cls = I2SBScheduler if cls is I2SBLDMPipeline else DDIMScheduler
    return cls(*_random_modules(UNet2DConfig, UNet2DModel, unet_config,
                                vae_config, seed, device),
               sched_cls.from_config(scheduler_config))


def load_pipeline(pipeline_dir, cls=LDMPipeline, device=None,
                  scheduler_config=None) -> LDMPipeline:
    """A pipeline from a directory that this port's
    ``LDMTrainer.save_pipeline`` wrote: its config JSONs and the newest
    ``checkpoint-{step}`` (the EMA UNet where it was saved, else the UNet;
    the VAE). ``scheduler_config`` replaces the directory's
    ``scheduler_config.json`` (an I2SB pipeline passes its own). Raises
    when the directory holds no checkpoint or the checkpoint no weights:
    a wrong path never scores random weights. Orbax directories of the JAX
    package are not read."""
    from ..train.checkpoint import latest_checkpoint, restore_checkpoint

    def read(name):
        with open(os.path.join(pipeline_dir, name)) as f:
            return json.load(f)

    if scheduler_config is None:
        has = os.path.exists(os.path.join(pipeline_dir,
                                          "scheduler_config.json"))
        scheduler_config = (read("scheduler_config.json") if has
                            else DEFAULT_SCHEDULER)
    ckpt = latest_checkpoint(pipeline_dir)
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint-* directory under {pipeline_dir!r}")
    state = restore_checkpoint(ckpt)
    unet_state = state.get("unet_ema") or state.get("unet")
    if not unet_state or not state.get("vae"):
        raise FileNotFoundError(
            f"checkpoint {ckpt!r} holds no UNet or no VAE weights")
    pipe = init_random_pipeline(read("unet_config.json"),
                                read("vae_config.json"), scheduler_config,
                                device=device, cls=cls)
    pipe.unet.load_state_dict(unet_state, strict=True)
    pipe.vae.load_state_dict(state["vae"], strict=True)
    return pipe


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


def init_random_video_editing_pipeline(
        unet_config, vae_config, scheduler_config, seed: int = 0,
        device=None) -> VideoEquivEditingPipeline:
    """The video-editing pipeline (SD-family conditioned UNet, AF-VAE)
    with random weights from ``seed``; the configs as for
    ``init_random_pipeline``."""
    vae, unet = _random_modules(UNet2DConditionConfig, UNet2DConditionModel,
                                unet_config, vae_config, seed, device)
    return VideoEquivEditingPipeline(
        vae, unet, DDIMScheduler.from_config(scheduler_config))


def init_random_normal_pipeline(unet_config, vae_config, scheduler_config,
                                seed: int = 0, device=None,
                                zero_controls: bool = True
                                ) -> NormControlPipeline:
    """The normal-estimation pipeline (SD-family conditioned UNet, AF-VAE,
    the ControlNet of ``ControlNetConfig.from_unet_config``) with random
    weights from ``seed``; the configs as for ``init_random_pipeline``.
    ``zero_controls=False`` draws ``conv_in2`` and the residual convs like
    every other weight instead of zeroing them, so that the ControlNet's
    residuals are not all zero (checks of the residual path)."""
    vae, unet, cn = _random_modules(UNet2DConditionConfig,
                                    UNet2DConditionModel, unet_config,
                                    vae_config, seed, device,
                                    controlnet=True)
    if zero_controls:
        cn.zero_controls_()
    return NormControlPipeline(vae, unet, cn,
                               DDIMScheduler.from_config(scheduler_config))


def _random_modules(config_cls, unet_cls, unet_config, vae_config, seed,
                    device, controlnet: bool = False):
    """(vae, unet[, controlnet]) with weights drawn from ``seed`` (UNet,
    VAE, ControlNet in turn), on ``device``."""
    device = resolve_device(device)
    set_af_precision("highest")
    if isinstance(unet_config, dict):
        unet_config = config_cls.from_diffusers(unet_config, alias_free=True)
    if isinstance(vae_config, dict):
        vae_config = AutoencoderKLConfig.from_diffusers(vae_config)
    gen = torch.Generator().manual_seed(seed)
    modules = [unet_cls(unet_config), AutoencoderKL(vae_config)]
    if controlnet:
        modules.append(ControlNetModel(
            ControlNetConfig.from_unet_config(unet_config)))
    for m in modules:
        init_random_weights(m, gen)
    unet, vae, *rest = (m.to(device).eval() for m in modules)
    return (vae, unet, *rest)
