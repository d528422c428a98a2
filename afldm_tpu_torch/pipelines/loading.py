"""Build a pipeline with random weights from a seed (the published
checkpoints are not in the repository), or load one that this port's
trainers' ``save_pipeline`` or ``scripts/convert_reference_checkpoint.py``
wrote. Weights are drawn on the CPU from an
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
from ..ops import ideal_lpf
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


def _set_precision(level=None):
    """Set the circulant products' level where one is given, else re-apply
    the current one: either way TF32 goes off for matmuls and cuDNN."""
    ideal_lpf.set_af_precision(level or ideal_lpf.af_precision())


def init_random_pipeline(unet_config, vae_config, scheduler_config,
                         seed: int = 0, device=None, cls=LDMPipeline,
                         af_precision=None,
                         dtype=torch.float32) -> LDMPipeline:
    """Configs may be dataclasses or diffusers-style dicts (the UNet dict is
    read as alias-free, like the JAX package's loader). ``cls`` is
    ``LDMPipeline`` (DDIM) or ``I2SBLDMPipeline`` (``I2SBScheduler``, e.g.
    from ``configs/sr/i2sb_scheduler.json``). ``af_precision``
    ('highest' | 'high' | 'default') sets the circulant products' level;
    None leaves it as it is. TF32 is switched off either way. ``dtype``
    (float32 or bfloat16) is the UNet's and the VAE's compute dtype; the
    weights stay float32, drawn as at float32."""
    _set_precision(af_precision)
    sched_cls = I2SBScheduler if cls is I2SBLDMPipeline else DDIMScheduler
    return cls(*_random_modules(UNet2DConfig, UNet2DModel, unet_config,
                                vae_config, seed, device, dtype=dtype),
               sched_cls.from_config(scheduler_config))


def _read_json(pipeline_dir, name):
    with open(os.path.join(pipeline_dir, name)) as f:
        return json.load(f)


def _restore_latest(pipeline_dir, allow_random: bool):
    """The state of the newest ``checkpoint-{step}`` under
    ``pipeline_dir``, or None when there is none and ``allow_random``."""
    from ..train.checkpoint import latest_checkpoint, restore_checkpoint
    ckpt = latest_checkpoint(pipeline_dir)
    if ckpt is None:
        if not allow_random:
            raise FileNotFoundError(
                f"no checkpoint-* directory under {pipeline_dir!r}; pass "
                "allow_random=True to score random-initialized weights")
        return None, None
    return ckpt, restore_checkpoint(ckpt)


def _fail_on_missing(ckpt, missing, allow_random):
    if missing and not allow_random:
        raise FileNotFoundError(
            f"checkpoint {ckpt!r} holds no weights for {missing}; pass "
            "allow_random=True to keep random weights for those")


def load_pipeline(pipeline_dir, cls=LDMPipeline, device=None,
                  scheduler_config=None, use_ema: bool = True,
                  allow_random: bool = False, af_precision=None,
                  dtype=torch.float32) -> LDMPipeline:
    """A pipeline from a directory that this port's trainers'
    ``save_pipeline`` wrote: its config JSONs and the newest
    ``checkpoint-{step}`` (the EMA UNet where ``use_ema`` and it was
    saved, else the UNet; the VAE). ``scheduler_config`` replaces the
    directory's ``scheduler_config.json`` (an I2SB pipeline passes its
    own). A directory without a checkpoint, or a checkpoint without UNet
    or VAE weights, raises unless ``allow_random``, which keeps the random
    weights (seed 0) of what is missing: a wrong path never scores random
    weights unasked. Orbax directories of the JAX package are not read.
    ``af_precision`` ('highest' | 'high' | 'default') is the serving knob
    of the circulant products' level, as in the JAX package; None leaves
    the level as it is (a CLI may have set it). ``dtype`` is the compute
    dtype, as for ``init_random_pipeline``."""
    if scheduler_config is None:
        has = os.path.exists(os.path.join(pipeline_dir,
                                          "scheduler_config.json"))
        scheduler_config = (_read_json(pipeline_dir, "scheduler_config.json")
                            if has else DEFAULT_SCHEDULER)
    ckpt, state = _restore_latest(pipeline_dir, allow_random)
    pipe = init_random_pipeline(_read_json(pipeline_dir, "unet_config.json"),
                                _read_json(pipeline_dir, "vae_config.json"),
                                scheduler_config, device=device, cls=cls,
                                af_precision=af_precision, dtype=dtype)
    if state is None:
        return pipe
    key = "unet_ema" if use_ema and state.get("unet_ema") else "unet"
    _fail_on_missing(ckpt, [n for n, k in (("unet/unet_ema", key),
                                           ("vae", "vae"))
                            if not state.get(k)], allow_random)
    if state.get(key):
        pipe.unet.load_state_dict(state[key], strict=True)
    if state.get("vae"):
        pipe.vae.load_state_dict(state["vae"], strict=True)
    return pipe


def load_sd_components(pipeline_dir, device=None,
                       allow_random: bool = False) -> dict:
    """The SD-family components of a pipeline directory, the layout that
    ``scripts/convert_reference_checkpoint.py`` and the SD trainers'
    ``save_pipeline`` write: ``unet_config.json`` (a cross-attention UNet),
    ``vae_config.json``, an optional ``controlnet_config.json``, optional
    ``text_encoder/`` and ``tokenizer/`` folders, an optional
    ``scheduler_config.json`` and ``checkpoint-{step}``. The UNet is the
    EMA one where it was saved. Returns {"unet", "vae"[, "controlnet"][,
    "text_encoder"][, "scheduler_config"]}, the modules on ``device`` in
    eval mode. Raises as ``load_pipeline`` does on a missing checkpoint or
    missing weights unless ``allow_random``, which keeps those from seed
    0. The configs are read as written (``alias_free`` from the
    JSON, else off), as the JAX package reads them."""
    from ..models.text_encoder import TextEncoder
    device = resolve_device(device)
    _set_precision()
    ucfg = UNet2DConditionConfig.from_diffusers(
        _read_json(pipeline_dir, "unet_config.json"))
    vcfg = AutoencoderKLConfig.from_diffusers(
        _read_json(pipeline_dir, "vae_config.json"))
    out = {"unet": UNet2DConditionModel(ucfg), "vae": AutoencoderKL(vcfg)}
    if os.path.exists(os.path.join(pipeline_dir, "controlnet_config.json")):
        out["controlnet"] = ControlNetModel(ControlNetConfig.from_diffusers(
            _read_json(pipeline_dir, "controlnet_config.json")))
    ckpt, state = _restore_latest(pipeline_dir, allow_random)
    state = state or {}
    names = {"unet": "unet_ema" if state.get("unet_ema") else "unet",
             "vae": "vae", "controlnet": "controlnet"}
    if ckpt is not None:
        _fail_on_missing(ckpt, [k for k in out if not state.get(names[k])],
                         allow_random)
    gen = torch.Generator().manual_seed(0)
    for k, m in out.items():
        if state.get(names[k]):
            m.load_state_dict(state[names[k]], strict=True)
        else:  # random weights only where allow_random let them stay
            init_random_weights(m, gen)
            if k == "controlnet":
                m.zero_controls_()
        out[k] = m.to(device).eval()

    te_dir = os.path.join(pipeline_dir, "text_encoder")
    if os.path.isdir(te_dir):
        tok = os.path.join(pipeline_dir, "tokenizer")
        out["text_encoder"] = TextEncoder(
            pretrained_dir=te_dir, device=device,
            tokenizer_dir=tok if os.path.isdir(tok) else None)
    if os.path.exists(os.path.join(pipeline_dir, "scheduler_config.json")):
        out["scheduler_config"] = _read_json(pipeline_dir,
                                             "scheduler_config.json")
    return out


def init_random_interp_pipeline(unet_config, vae_config, scheduler_config,
                                seed: int = 0, device=None,
                                dtype=torch.float32
                                ) -> ImageInterpolationPipeline:
    """The image-interpolation pipeline (SD-family conditioned UNet,
    AF-VAE) with random weights from ``seed``; the configs and ``dtype``
    as for ``init_random_pipeline``."""
    vae, unet = _random_modules(UNet2DConditionConfig, UNet2DConditionModel,
                                unet_config, vae_config, seed, device,
                                dtype=dtype)
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
                    device, controlnet: bool = False, dtype=torch.float32):
    """(vae, unet[, controlnet]) with weights drawn from ``seed`` (UNet,
    VAE, ControlNet in turn), on ``device``; every module computes in
    ``dtype`` (float32 or bfloat16), its parameters float32."""
    device = resolve_device(device)
    _set_precision()
    if isinstance(unet_config, dict):
        unet_config = config_cls.from_diffusers(unet_config, alias_free=True)
    if isinstance(vae_config, dict):
        vae_config = AutoencoderKLConfig.from_diffusers(vae_config)
    gen = torch.Generator().manual_seed(seed)
    modules = [unet_cls(unet_config, dtype=dtype),
               AutoencoderKL(vae_config, dtype=dtype)]
    if controlnet:
        modules.append(ControlNetModel(
            ControlNetConfig.from_unet_config(unet_config), dtype=dtype))
    for m in modules:
        init_random_weights(m, gen)
    unet, vae, *rest = (m.to(device).eval() for m in modules)
    return (vae, unet, *rest)
