"""I2SB super-resolution trainer: encode the HQ image and its 4x-degraded
LQ copy by the posterior mode (no gradient), bridge them with
``I2SBScheduler.add_noise``, regress ``compute_label``, plus the
cross-frame-attention shift loss when ``use_cfa``. Counterpart of
``afldm_tpu/train/i2sb_trainer.py``.

The step is the LDM trainer's (``LDMTrainer``: optimizer, EMA,
checkpoints, weights from ``vae_path`` / ``unet_path``) with the bridge in
place of the DDPM noising. ``draw`` gives the step's timesteps, the bridge
noise (when ``is_ode`` is off) and the two offsets; nothing is detached
that the JAX package does not stop.
"""

import os

import torch

from ..models import (AutoencoderKL, AutoencoderKLConfig, UNet2DConfig,
                      UNet2DModel)
from ..ops.superresolution import build_sr4x
from ..pipelines.i2sb import I2SBLDMPipeline
from ..schedulers import I2SBScheduler
from ..shift.metrics import mask_mse, psnr
from ..shift.shifters import ImageShifter, gen_valid_mask
from .ldm_trainer import LDMTrainer
from .trainer import load_json

_SR4X_CACHE = {}


def degrade_sr4x(images, sr_filter="bicubic"):
    """Fixed 4x degradation + nearest re-upsample of NCHW images, the
    operator cached per (image size, filter)."""
    key = (images.shape[-2], sr_filter)
    if key not in _SR4X_CACHE:
        _SR4X_CACHE[key] = build_sr4x(sr_filter, images.shape[-2],
                                      images.shape[1])
    return _SR4X_CACHE[key](images)


class I2SBTrainer(LDMTrainer):
    SCALE_LR_BY_BATCH = False

    def init_modules(self, vae_config=None, unet_config=None,
                     scheduler_config=None):
        """Configs may be passed directly or read from the paths in cfg,
        as the JAX trainer reads them."""
        cfg = self.cfg
        if scheduler_config is None:
            scheduler_config = load_json(cfg.scheduler_path)
        self.noise_scheduler = I2SBScheduler.from_config(scheduler_config)
        if vae_config is None:
            p = os.path.join(cfg.vae_path, "vae", "config.json")
            if not os.path.exists(p):
                p = os.path.join(cfg.vae_path, "vae_config.json")
            if not os.path.exists(p):
                p = os.path.join(cfg.vae_path, "config.json")
            vae_config = load_json(p)
        if isinstance(vae_config, dict):
            vae_config = AutoencoderKLConfig.from_diffusers(vae_config)
        if unet_config is None:
            unet_config = load_json(cfg.unet_config)
        if isinstance(unet_config, dict):
            unet_config = UNet2DConfig.from_diffusers(
                unet_config, alias_free=cfg.af_models)
        self.vae = AutoencoderKL(vae_config, dtype=self.weight_dtype)
        self.unet = UNet2DModel(unet_config, dtype=self.weight_dtype)
        self.vae_config = vae_config
        self.unet_config = unet_config
        self.shifter = ImageShifter("ideal", vae_config.downsample_ratio)

    def draw(self, global_step: int, batch_size: int) -> dict:
        """The step's random draws, from a CPU generator seeded by
        (seed, step): the offsets, the bridge noise (None when ``is_ode``)
        and the timesteps."""
        seed = self.base_cfg.seed or 0
        gen = torch.Generator().manual_seed(seed * 2 ** 32 + global_step)
        vc = self.vae_config
        res = self.base_cfg.resolution
        lat = (batch_size, vc.latent_channels, res // vc.downsample_ratio,
               res // vc.downsample_ratio)
        max_off = int(res * 0.75 // 2)
        ti, tj = (int(torch.randint(-max_off, max_off + 1, (),
                                    generator=gen)) / vc.downsample_ratio
                  for _ in range(2))
        noise = None if self.cfg.is_ode else torch.randn(lat, generator=gen)
        return {"noise": noise, "ti": ti, "tj": tj,
                "t": torch.randint(0, self.noise_scheduler.num_train_timesteps,
                                   (batch_size,), generator=gen)}

    def loss_fn(self, images, draws):
        """images: NCHW in [-1, 1] on the trainer's device. Returns
        (loss, {train_loss, mse_loss, shift_loss} as tensors)."""
        cfg, sched = self.cfg, self.noise_scheduler
        dev = images.device
        scaling = self.vae_config.scaling_factor
        with torch.no_grad():  # the posterior mode of HQ and LQ
            x0 = self.vae.encode(images)[0] * scaling
            x1 = self.vae.encode(degrade_sr4x(images))[0] * scaling
        t_host = draws["t"]  # the scheduler's tables are read on the host
        t = t_host.to(dev)
        ti, tj = draws["ti"], draws["tj"]
        xt = sched.add_noise(x0, x1, t_host, is_ode=cfg.is_ode,
                             noise=draws["noise"])
        label = sched.compute_label(t_host, x0, xt)

        pred0, kv = self.unet_apply(xt, t)
        mse_loss = torch.mean((pred0.float() - label.float()) ** 2)
        shift_loss = torch.zeros((), device=dev)
        if cfg.use_cfa:
            mask = gen_valid_mask(xt.shape, ti, tj, dev)
            xt_s, _ = self.shifter.shift(xt, ti, tj)
            target, _ = self.shifter.shift(pred0, ti, tj)
            pred_s, _ = self.unet_apply(xt_s, t, kv)
            shift_loss = mask_mse(pred_s.float(), target.float(), mask)
        loss = mse_loss + shift_loss
        return loss, {"train_loss": loss.detach(),
                      "mse_loss": mse_loss.detach(),
                      "shift_loss": shift_loss.detach()}

    def make_pipeline(self, use_ema=None) -> I2SBLDMPipeline:
        """The I2SB pipeline over the frozen VAE and the UNet, or a copy of
        it carrying the EMA weights."""
        return I2SBLDMPipeline(self.vae, self._pipeline_unet(use_ema),
                               self.noise_scheduler)

    def validate(self, global_step, images=None, num_steps=20):
        """PSNR of the super-resolved ``images`` (NCHW in [-1, 1]) against
        themselves, from their 4x degradation; {} without images."""
        if images is None:
            return {}
        images = images.to(self.device)
        out = self.make_pipeline()(degrade_sr4x(images),
                                   num_inference_steps=num_steps,
                                   output_type="pt")
        return {"val_psnr": float(psnr(out, images))}
