"""LDM trainer: eps-MSE plus the cross-frame-attention shift-equivariance
loss, with a frozen VAE encoder. Counterpart of
``afldm_tpu/train/ldm_trainer.py``.

The loss is split from its random draws: ``loss_fn(images, draws)`` takes
the encoder's posterior noise, the diffusion noise, the timesteps and the
two shift offsets explicitly, and ``training_step`` draws them from a
generator seeded by (seed, step), so a resumed run draws what an unbroken
one would. Pass 1 of the UNet returns the maps each self-attention layer
stored; pass 2, on the shifted latent, reads them as K/V (CFA LOAD).
Nothing is detached that the JAX package does not stop: gradient flows
through pass 1's prediction, the shifted target and the stored maps.
"""

import copy
import json
import os

import torch

from ..models import (AutoencoderKL, AutoencoderKLConfig, UNet2DConfig,
                      UNet2DModel)
from ..pipelines.ldm import LDMPipeline
from ..pipelines.loading import init_random_weights
from ..schedulers import DDIMScheduler, DDPMScheduler
from ..shift.metrics import mask_mse
from ..shift.shifters import ImageShifter, gen_valid_mask
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .ema import EMA
from .trainer import Trainer, TrainOptimizer, checkpointed, load_json


class LDMTrainer(Trainer):
    # ``scale_lr`` multiplies the lr by the batch too (the JAX LDM trainer
    # passes it to ``make_optimizer``; its I2SB and SD trainers do not)
    SCALE_LR_BY_BATCH = True

    def init_modules(self, vae_config=None, unet_config=None,
                     scheduler_config=None):
        """Configs may be passed directly or read from the paths in cfg, as
        the JAX trainer reads them."""
        cfg = self.cfg
        if cfg.is_vqvae:
            raise NotImplementedError(
                "is_vqvae: the VQ autoencoder (models/vq.py) is not ported "
                "yet (ROADMAP Queue 1 item 9)")
        if scheduler_config is None:
            scheduler_config = load_json(cfg.scheduler_path)
        self.noise_scheduler = DDPMScheduler.from_config(scheduler_config)
        self.noise_scheduler.prediction_type = cfg.prediction_type

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
            if cfg.unet_path:
                p = os.path.join(cfg.unet_path, "unet_config.json")
                if not os.path.exists(p):
                    p = os.path.join(cfg.unet_path, "config.json")
                unet_config = load_json(p)
            else:
                unet_config = load_json(cfg.unet_config)
        if isinstance(unet_config, dict):
            unet_config = UNet2DConfig.from_diffusers(
                unet_config, alias_free=cfg.af_models)
        self.vae = AutoencoderKL(vae_config, dtype=self.weight_dtype)
        self.unet = UNet2DModel(unet_config, dtype=self.weight_dtype)
        self.vae_config = vae_config
        self.unet_config = unet_config
        self.shifter = ImageShifter("ideal", vae_config.downsample_ratio)

    def init_optimizers(self, total_steps=None):
        self.total_steps = total_steps

    @staticmethod
    def _load_saved_params(path, prefer):
        """The first non-empty entry of ``prefer`` in the latest checkpoint
        under ``path`` (a ``save_pipeline`` directory of this port), or
        None when there is no checkpoint."""
        ckpt = latest_checkpoint(path)
        if ckpt is None:
            return None
        state = restore_checkpoint(ckpt)
        for k in prefer:
            if state.get(k):
                return state[k]
        return None

    def init_params(self, seed: int = 0, unet_state=None, vae_state=None):
        """Saved weights where given or found (``vae_state`` /
        ``unet_state`` state dicts, else the checkpoints under
        ``cfg.vae_path`` / ``cfg.unet_path``), random ones from ``seed``
        (LeCun-normal, drawn on the CPU, the VAE's first) for the rest."""
        cfg = self.cfg
        if vae_state is None and cfg.vae_path and os.path.isdir(cfg.vae_path):
            # a VAE-trainer save (vae/model_ema) or an LDM run's (vae)
            vae_state = self._load_saved_params(cfg.vae_path,
                                                ("model_ema", "vae"))
        unet_path = getattr(cfg, "unet_path", None)
        if unet_state is None and unet_path and os.path.isdir(unet_path):
            unet_state = self._load_saved_params(unet_path, ("unet",))
        gen = torch.Generator().manual_seed(seed)
        for module, state in ((self.vae, vae_state), (self.unet, unet_state)):
            if state is None:
                init_random_weights(module, gen)
            else:
                module.load_state_dict(state, strict=True)

    def prepare_modules(self, seed: int = 0, unet_state=None,
                        vae_state=None):
        """Weights (``init_params``), then the frozen VAE, the optimizer
        over the UNet, the EMA and the UNet's apply (checkpointed when
        ``gradient_checkpointing``)."""
        self.init_params(seed, unet_state, vae_state)
        base = self.base_cfg
        self.vae.to(self.device).eval().requires_grad_(False)
        self.unet.to(self.device).train()
        self.opt = TrainOptimizer(
            self.unet.parameters(), self.cfg, self.total_steps,
            grad_accum=base.gradient_accumulation_steps,
            train_batch_size=(base.train_batch_size
                              if self.SCALE_LR_BY_BATCH else 1))
        self.ema = EMA(self.unet.parameters()) if self.cfg.use_ema else None
        self.step = 0
        if base.gradient_checkpointing:
            self.unet_apply = checkpointed(self.unet, base.remat_policy)
        else:
            self.unet_apply = self.unet

    # -- the step ----------------------------------------------------------

    def draw(self, global_step: int, batch_size: int) -> dict:
        """The step's random draws, from a CPU generator seeded by
        (seed, step): the same on every device."""
        seed = self.base_cfg.seed or 0
        gen = torch.Generator().manual_seed(seed * 2 ** 32 + global_step)
        vc, uc = self.vae_config, self.unet_config
        res = self.base_cfg.resolution
        lat = (batch_size, vc.latent_channels, res // vc.downsample_ratio,
               res // vc.downsample_ratio)
        # integer image-pixel offsets up to resolution * 0.75 / 2, in
        # latent pixels (the reference's +-96 at 256 px)
        max_off = int(res * 0.75 // 2)
        ti, tj = (int(torch.randint(-max_off, max_off + 1, (),
                                    generator=gen)) / vc.downsample_ratio
                  for _ in range(2))
        return {
            "enc_eps": torch.randn(lat, generator=gen),
            "noise": torch.randn(lat[:1] + (uc.in_channels,) + lat[2:],
                                 generator=gen),
            "t": torch.randint(0, self.noise_scheduler.num_train_timesteps,
                               (batch_size,), generator=gen),
            "ti": ti, "tj": tj,
        }

    def loss_fn(self, images, draws, cond=()):
        """images: NCHW in [-1, 1] on the trainer's device; ``cond``: the
        UNet's inputs after the timesteps (a conditioned UNet's prompt
        embeddings). Returns (loss, {train_loss, mse_loss, shift_loss} as
        tensors). At bf16 the draws are rounded to the dtype JAX draws them
        in (the latents'), and both losses are taken in float32."""
        cfg = self.cfg
        dev = images.device
        with torch.no_grad():
            mean, logvar = self.vae.encode(images)
            eps = draws["enc_eps"].to(dev, mean.dtype)
            latents = ((mean + torch.exp(0.5 * logvar) * eps)
                       * self.vae_config.scaling_factor)
        noise = draws["noise"].to(dev, latents.dtype)
        t = draws["t"].to(dev)
        ti, tj = draws["ti"], draws["tj"]
        noisy = self.noise_scheduler.add_noise(latents, noise, t)

        pred0, kv = self.unet_apply(noisy, t, *cond)
        if not (cfg.use_shift_loss and cfg.use_cross_attn):
            kv = None
        shift_loss = torch.zeros((), device=dev)
        if cfg.use_shift_loss:
            mask = gen_valid_mask(noisy.shape, ti, tj, dev)
            cache = self.shifter.precompute(noisy)
            shifted_noisy, _ = self.shifter.shift(noisy, ti, tj, cache=cache)
            target, _ = self.shifter.shift(pred0, ti, tj)
            pred_s, _ = self.unet_apply(shifted_noisy, t, *cond, kv)
            if getattr(cfg, "use_stop_grad", False):
                pred_s = pred_s.detach()
            shift_loss = mask_mse(pred_s.float(), target.float(), mask)
        mse_loss = torch.mean((pred0.float() - noise.float()) ** 2)
        loss = mse_loss + shift_loss
        return loss, {"train_loss": loss.detach(),
                      "mse_loss": mse_loss.detach(),
                      "shift_loss": shift_loss.detach()}

    def training_step(self, global_step, batch, draws=None) -> dict:
        """One micro-batch: loss, backward, optimizer (every
        ``gradient_accumulation_steps`` micro-batches), EMA (every call, as
        the JAX step updates it). ``batch["input"]``: NHWC in [-1, 1];
        ``draws`` (as ``draw`` returns them) replace the step's own."""
        images = self._images(batch["input"])
        if draws is None:
            draws = self.draw(global_step, images.shape[0])
        return self._update(*self.loss_fn(images, draws))

    def _images(self, nhwc):
        """A batch's NHWC images as NCHW float32 on the trainer's device."""
        images = torch.as_tensor(nhwc).permute(0, 3, 1, 2)
        return images.to(self.device, torch.float32).contiguous()

    def _update(self, loss, logs) -> dict:
        """Backward, the optimizer (every ``gradient_accumulation_steps``
        micro-batches) and the EMA; the logs as floats."""
        loss.backward()
        self.opt.step()
        if self.ema is not None:
            self.ema.update(self.unet.parameters())
        self.step += 1
        return {k: float(v) for k, v in logs.items()}

    # -- checkpoints ---------------------------------------------------------

    def state_for_checkpoint(self) -> dict:
        return {"unet": self.unet.state_dict(),
                "optimizer": self.opt.state_dict(),
                "ema": self.ema.state_dict() if self.ema else {},
                "step": self.step}

    def load_state(self, state: dict):
        self.unet.load_state_dict(state["unet"], strict=True)
        self.opt.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.step = int(state["step"])

    # -- validation / export -------------------------------------------------

    def _pipeline_unet(self, use_ema=None):
        """The UNet, or a copy of it carrying the EMA weights."""
        use_ema = self.cfg.use_ema if use_ema is None else use_ema
        unet = self.unet
        if use_ema and self.ema is not None:
            unet = copy.deepcopy(self.unet)
            with torch.no_grad():
                torch._foreach_copy_(list(unet.parameters()),
                                     self.ema.params)
        return unet

    def make_pipeline(self, use_ema=None) -> LDMPipeline:
        """A DDIM pipeline over the frozen VAE and the UNet, or a copy of it
        carrying the EMA weights."""
        unet = self._pipeline_unet(use_ema)
        ddim = DDIMScheduler(
            **{k: v for k, v in self.noise_scheduler.config.items()
               if k in ("num_train_timesteps", "beta_start", "beta_end",
                        "beta_schedule", "clip_sample", "steps_offset",
                        "timestep_spacing")},
            set_alpha_to_one=False)
        return LDMPipeline(self.vae, unet, ddim)

    def validate(self, global_step, num_images=4, num_steps=20):
        """20-step DDIM samples from the EMA weights, NHWC in [0, 1]."""
        pipe = self.make_pipeline()
        gen = torch.Generator(self.device).manual_seed(self.cfg.valid_seed)
        imgs = pipe(batch_size=num_images, generator=gen,
                    num_inference_steps=num_steps)
        return {"samples": imgs}

    def save_pipeline(self, output_dir):
        """unet/scheduler/vae config JSONs and ``checkpoint-{step}`` with
        the unet, unet_ema and vae state dicts, the JAX trainer's layout in
        this port's format."""
        os.makedirs(output_dir, exist_ok=True)
        for name, obj in (("unet_config.json", self.unet_config.to_dict()),
                          ("scheduler_config.json",
                           self.noise_scheduler.config),
                          ("vae_config.json", self.vae_config.to_dict())):
            with open(os.path.join(output_dir, name), "w") as f:
                json.dump(obj, f, indent=2)
        ema = {}
        if self.ema is not None:
            ema = {k: e for (k, _), e in zip(self.unet.named_parameters(),
                                             self.ema.params)}
        save_checkpoint(output_dir, self.step, {
            "unet": self.unet.state_dict(), "unet_ema": ema,
            "vae": self.vae.state_dict()})
