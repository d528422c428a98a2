"""Text-conditioned SD finetune: eps-MSE with CLIP text conditioning plus
the cross-frame-attention shift loss, on the alias-free SD UNet, with the
AF-VAE and the text encoder frozen. Counterpart of
``afldm_tpu/train/sd_text_trainer.py``.

The step is the LDM trainer's (``LDMTrainer``: the same draws, optimizer,
EMA and checkpoints) with the prompt embeddings passed to both UNet
passes. Prompt dropout draws from ``np.random.default_rng(global_step)``
as the JAX trainer does, so the same prompts are dropped.

``pretrained_model_name_or_path`` is, as in the JAX package, the text
encoder's directory. Where it is a pipeline directory instead (one holding
``unet_config.json``, as ``scripts/convert_reference_checkpoint.py`` or
``save_pipeline`` write it), the UNet's and the VAE's configs and weights
come from it, and the text encoder from its ``text_encoder/`` and
``tokenizer/``: the JAX trainer starts from a random SD-1.5 UNet there.
"""

import json
import os

import numpy as np

from ..models import (AutoencoderKL, AutoencoderKLConfig,
                      UNet2DConditionConfig, UNet2DConditionModel)
from ..models.text_encoder import TextEncoder
from ..schedulers import DDPMScheduler
from ..shift.shifters import ImageShifter
from .checkpoint import latest_checkpoint, save_checkpoint
from .ldm_trainer import LDMTrainer
from .trainer import load_json

# SD 1.5's noise schedule, the JAX trainer's default
SD_NOISE_SCHEDULER = {"num_train_timesteps": 1000,
                      "beta_schedule": "scaled_linear",
                      "beta_start": 0.00085, "beta_end": 0.012}


def sd_pipeline_dir(path):
    """``path`` when it is a pipeline directory (holds
    ``unet_config.json``), else None."""
    if path and os.path.exists(os.path.join(path, "unet_config.json")):
        return path
    return None


def sd_saved_params(pipeline_dir, prefer):
    """The first non-empty entry of ``prefer`` in the pipeline directory's
    newest checkpoint; raises when it has no checkpoint."""
    if latest_checkpoint(pipeline_dir) is None:
        raise FileNotFoundError(
            f"no checkpoint-* directory under {pipeline_dir!r}: a pipeline "
            "directory to train from must hold its weights")
    return LDMTrainer._load_saved_params(pipeline_dir, prefer)


class SDTextTrainer(LDMTrainer):
    SCALE_LR_BY_BATCH = False

    def init_modules(self, vae_config=None, unet_config=None,
                     scheduler_config=None, text_encoder=None):
        """Configs may be passed directly; else the VAE's is read from
        ``vae_path`` (or the pipeline directory) and the UNet's is SD
        1.5's (or the pipeline directory's). ``text_encoder``: anything
        with ``encode(list of prompts) -> (N, 77, D)``; built in
        ``prepare_modules`` when None."""
        cfg = self.cfg
        self.noise_scheduler = DDPMScheduler.from_config(
            scheduler_config or SD_NOISE_SCHEDULER)
        self.pipeline_dir = sd_pipeline_dir(
            cfg.pretrained_model_name_or_path)
        if vae_config is None:
            vae_config = load_json(
                os.path.join(self.pipeline_dir, "vae_config.json")
                if self.pipeline_dir
                else os.path.join(cfg.vae_path, "config.json"))
        if isinstance(vae_config, dict):
            vae_config = AutoencoderKLConfig.from_diffusers(vae_config)
        if unet_config is None:
            unet_config = (load_json(os.path.join(self.pipeline_dir,
                                                  "unet_config.json"))
                           if self.pipeline_dir else
                           UNet2DConditionConfig(alias_free=cfg.af_models))
        if isinstance(unet_config, dict):
            unet_config = UNet2DConditionConfig.from_diffusers(
                unet_config, alias_free=cfg.af_models)
        self.vae = AutoencoderKL(vae_config, dtype=self.weight_dtype)
        self.unet = UNet2DConditionModel(unet_config,
                                         dtype=self.weight_dtype)
        self.vae_config = vae_config
        self.unet_config = unet_config
        self.text_encoder = text_encoder
        self.shifter = ImageShifter("ideal", vae_config.downsample_ratio)

    def init_params(self, seed: int = 0, unet_state=None, vae_state=None):
        """``LDMTrainer.init_params``, the pipeline directory's weights
        (the EMA UNet where saved) taking the place of missing states."""
        if self.pipeline_dir:
            if unet_state is None:
                unet_state = sd_saved_params(self.pipeline_dir,
                                             ("unet_ema", "unet"))
            if vae_state is None:
                vae_state = sd_saved_params(self.pipeline_dir, ("vae",))
        super().init_params(seed, unet_state, vae_state)

    def prepare_modules(self, seed: int = 0, unet_state=None,
                        vae_state=None):
        super().prepare_modules(seed, unet_state, vae_state)
        if self.text_encoder is None:
            d = self.pipeline_dir
            if d:
                te = os.path.join(d, "text_encoder")
                tok = os.path.join(d, "tokenizer")
                self.text_encoder = TextEncoder(
                    te if os.path.isdir(te) else None, seed=seed,
                    device=self.device,
                    tokenizer_dir=tok if os.path.isdir(tok) else None)
            else:
                self.text_encoder = TextEncoder(
                    self.cfg.pretrained_model_name_or_path or None,
                    seed=seed, device=self.device)

    def prompts(self, global_step: int, batch) -> list:
        """The batch's captions ("" without them), each dropped to "" with
        probability ``prompt_dropout`` by ``default_rng(global_step)``."""
        n = len(batch["input"])
        prompts = list(batch.get("caption", [""] * n))
        p = self.base_cfg.prompt_dropout
        if p > 0:
            rng = np.random.default_rng(global_step)
            prompts = ["" if rng.random() < p else s for s in prompts]
        return prompts

    def training_step(self, global_step, batch, draws=None) -> dict:
        """One micro-batch as ``LDMTrainer.training_step``, conditioned on
        the frozen text encoder's embeddings of ``prompts``."""
        images = self._images(batch["input"])
        ehs = self.text_encoder.encode(self.prompts(global_step, batch))
        ehs = ehs.to(self.device).detach()
        if draws is None:
            draws = self.draw(global_step, images.shape[0])
        return self._update(*self.loss_fn(images, draws, (ehs,)))

    def make_pipeline(self, use_ema=None):
        raise NotImplementedError(
            "the SD text trainer has no sampling pipeline (nor has the JAX "
            "one); load its save_pipeline directory with "
            "pipelines.load_sd_components")

    def validate(self, global_step):
        return {}

    def save_pipeline(self, output_dir):
        """The JAX trainer's layout: ``unet_config.json``,
        ``vae_config.json`` and ``checkpoint-{step}`` with the unet,
        unet_ema and vae state dicts; ``load_sd_components`` reads it."""
        os.makedirs(output_dir, exist_ok=True)
        for name, c in (("unet_config.json", self.unet_config),
                        ("vae_config.json", self.vae_config)):
            with open(os.path.join(output_dir, name), "w") as f:
                json.dump(c.to_dict(), f, indent=2)
        ema = {}
        if self.ema is not None:
            ema = {k: e for (k, _), e in zip(self.unet.named_parameters(),
                                             self.ema.params)}
        save_checkpoint(output_dir, self.step, {
            "unet": self.unet.state_dict(), "unet_ema": ema,
            "vae": self.vae.state_dict()})
