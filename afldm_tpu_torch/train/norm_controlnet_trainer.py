"""Normal-estimation ControlNet trainer. Counterpart of
``afldm_tpu/train/norm_controlnet_trainer.py``.

YOSO step: the input latent is zero with probability ``zero_input_prob``,
else noise, at t = 999; the target is the normal map's latent (posterior
mean times the scaling factor), the condition the image's latent through
the latent ControlNet, whose residuals enter the UNet. The shift loss
shifts the condition, the input latent and the first prediction, and the
second pass reads the first pass's stored maps (CFA LOAD), the gradient
flowing back through them.

Two optimizers: the UNet's trains only ``up_blocks.*``, ``conv_norm_out.*``
and ``conv_out.*`` (the rest has ``requires_grad`` off, so it stays bit
for bit; the global-norm clip spans the trainable subset, as the JAX
package's ``optax.multi_transform`` applies its chain to that subset
alone); the ControlNet's is a second, independent chain. No EMA.

``pretrained_model_name_or_path`` is the pipeline directory whose
``vae_config.json`` the JAX trainer reads; this one also takes the UNet's
config and weights (and the ControlNet's, where saved) from it when it
holds ``unet_config.json`` and a checkpoint.
"""

import json
import os

import torch

from ..models import (AutoencoderKL, AutoencoderKLConfig, ControlNetConfig,
                      ControlNetModel, UNet2DConditionConfig,
                      UNet2DConditionModel)
from ..pipelines.loading import init_random_weights
from ..shift.metrics import mask_mse
from ..shift.shifters import ImageShifter, gen_valid_mask
from .checkpoint import save_checkpoint
from .ldm_trainer import LDMTrainer
from .sd_text_trainer import sd_pipeline_dir, sd_saved_params
from .trainer import Trainer, TrainOptimizer, load_json

YOSO_TIMESTEP = 999
# the UNet's trainable parameters: the names' first component
TRAINABLE = ("up_blocks.", "conv_norm_out.", "conv_out.")


class NormControlNetTrainer(Trainer):

    def init_modules(self, vae_config=None, unet_config=None,
                     text_encoder=None):
        """Configs may be passed directly; else read from the pipeline
        directory ``pretrained_model_name_or_path`` (the UNet's: SD 1.5's
        when the directory has none). ``text_encoder``: anything with
        ``encode(list of prompts) -> (N, 77, D)``; without one every
        prompt is the zero embedding, as in the JAX trainer."""
        cfg = self.cfg
        src = cfg.pretrained_model_name_or_path
        self.pipeline_dir = sd_pipeline_dir(src)
        if vae_config is None:
            vae_config = load_json(os.path.join(src, "vae_config.json"))
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
        self.vae_config, self.unet_config = vae_config, unet_config
        self.controlnet_config = ControlNetConfig.from_unet_config(
            unet_config)
        self.vae = AutoencoderKL(vae_config, dtype=self.weight_dtype)
        self.unet = UNet2DConditionModel(unet_config,
                                         dtype=self.weight_dtype)
        self.controlnet = ControlNetModel(self.controlnet_config,
                                          dtype=self.weight_dtype)
        self.text_encoder = text_encoder
        self.shifter = ImageShifter("ideal", vae_config.downsample_ratio)

    def init_optimizers(self, total_steps=None):
        self.total_steps = total_steps

    def prepare_modules(self, seed: int = 0, unet_state=None,
                        vae_state=None, controlnet_state=None):
        """The given states or the pipeline directory's, random weights
        from ``seed`` for the rest (the ControlNet's zero-started convs at
        zero); then the frozen VAE, the UNet's trainable subset and both
        optimizers (``make_optimizer``'s chain without accumulation, as
        the JAX trainer builds both)."""
        if self.pipeline_dir:
            d = self.pipeline_dir
            if unet_state is None:
                unet_state = sd_saved_params(d, ("unet",))
            if vae_state is None:
                vae_state = sd_saved_params(d, ("vae",))
            if controlnet_state is None:
                controlnet_state = LDMTrainer._load_saved_params(
                    d, ("controlnet",))
        gen = torch.Generator().manual_seed(seed)
        for m, st in ((self.vae, vae_state), (self.unet, unet_state),
                      (self.controlnet, controlnet_state)):
            if st is None:
                init_random_weights(m, gen)
            else:
                m.load_state_dict(st, strict=True)
        if controlnet_state is None:
            self.controlnet.zero_controls_()
        self.vae.to(self.device).eval().requires_grad_(False)
        self.unet.to(self.device).train().requires_grad_(False)
        self.controlnet.to(self.device).train()
        trainable = [p for n, p in self.unet.named_parameters()
                     if n.startswith(TRAINABLE)]
        for p in trainable:
            p.requires_grad_(True)
        self.opt = TrainOptimizer(trainable, self.cfg, self.total_steps)
        self.cn_opt = TrainOptimizer(self.controlnet.parameters(), self.cfg,
                                     self.total_steps)
        self.step = 0

    # -- the step ----------------------------------------------------------

    def draw(self, global_step: int, batch_size: int) -> dict:
        """The step's random draws, from a CPU generator seeded by
        (seed, step): the two offsets, which samples start from zero, and
        the noise of the others."""
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
        zero = torch.rand((batch_size,), generator=gen) \
            < self.cfg.zero_input_prob
        return {"ti": ti, "tj": tj, "zero": zero,
                "noise": torch.randn(lat, generator=gen)}

    def forward(self, lat, cond, ehs, t, kv_in=None):
        """The ControlNet's residuals of ``cond``, then the UNet with them:
        (prediction, the UNet's stored maps)."""
        down, mid, _ = self.controlnet(lat, t, ehs, cond)
        return self.unet(lat, t, ehs, kv_in=kv_in,
                         down_block_residuals=down, mid_block_residual=mid)

    def prompt_embeds(self, n: int):
        if self.text_encoder is not None:
            return self.text_encoder.encode([""] * n).to(self.device)
        return torch.zeros((n, 77, self.unet_config.cross_attention_dim),
                           device=self.device)

    def loss_fn(self, images, normals, ehs, draws):
        """images, normals: NCHW in [-1, 1] on the trainer's device.
        Returns (loss, {train_loss, mse_loss, shift_loss} as tensors)."""
        dev = images.device
        scaling = self.vae_config.scaling_factor
        with torch.no_grad():
            cond = self.vae.encode(images)[0] * scaling
            target = self.vae.encode(normals)[0] * scaling
        noise = draws["noise"].to(dev, cond.dtype)  # JAX draws it so
        zero = draws["zero"].to(dev).reshape(-1, 1, 1, 1)
        lat = torch.where(zero, torch.zeros_like(noise), noise)
        t = torch.full((cond.shape[0],), YOSO_TIMESTEP, device=dev)
        ti, tj = draws["ti"], draws["tj"]

        pred0, kv = self.forward(lat, cond, ehs, t)
        mse_loss = torch.mean((pred0.float() - target.float()) ** 2)
        shift_loss = torch.zeros((), device=dev)
        if self.cfg.use_shift_loss:
            mask = gen_valid_mask(cond.shape, ti, tj, dev)
            cond_s, _ = self.shifter.shift(cond, ti, tj)
            lat_s, _ = self.shifter.shift(lat, ti, tj)
            tgt_s, _ = self.shifter.shift(pred0, ti, tj)
            pred_s, _ = self.forward(lat_s, cond_s, ehs, t, kv_in=kv)
            shift_loss = mask_mse(pred_s.float(), tgt_s.float(), mask)
        loss = mse_loss + shift_loss
        return loss, {"train_loss": loss.detach(),
                      "mse_loss": mse_loss.detach(),
                      "shift_loss": shift_loss.detach()}

    def training_step(self, global_step, batch, draws=None) -> dict:
        """One step: ``batch["input"]`` the images and ``batch["normal"]``
        their normal maps (the images themselves without), NHWC in
        [-1, 1]; ``draws`` (as ``draw`` returns them) replace the step's
        own."""
        def nchw(a):
            t = torch.as_tensor(a).permute(0, 3, 1, 2)
            return t.to(self.device, torch.float32).contiguous()
        images = nchw(batch["input"])
        normals = nchw(batch.get("normal", batch["input"]))
        if draws is None:
            draws = self.draw(global_step, images.shape[0])
        loss, logs = self.loss_fn(images, normals,
                                  self.prompt_embeds(images.shape[0]), draws)
        loss.backward()
        self.opt.step()
        self.cn_opt.step()
        self.step += 1
        return {k: float(v) for k, v in logs.items()}

    # -- checkpoints and export ---------------------------------------------

    def state_for_checkpoint(self) -> dict:
        return {"unet": self.unet.state_dict(),
                "controlnet": self.controlnet.state_dict(),
                "optimizer": self.opt.state_dict(),
                "cn_optimizer": self.cn_opt.state_dict(), "step": self.step}

    def load_state(self, state: dict):
        self.unet.load_state_dict(state["unet"], strict=True)
        self.controlnet.load_state_dict(state["controlnet"], strict=True)
        self.opt.load_state_dict(state["optimizer"])
        self.cn_opt.load_state_dict(state["cn_optimizer"])
        self.step = int(state["step"])

    def save_pipeline(self, output_dir):
        """``unet_config.json``, ``controlnet_config.json``,
        ``vae_config.json`` (which the JAX trainer does not write) and
        ``checkpoint-{step}`` with the unet, controlnet and vae state
        dicts: what ``load_sd_components`` reads."""
        os.makedirs(output_dir, exist_ok=True)
        for name, c in (("unet_config.json", self.unet_config),
                        ("controlnet_config.json", self.controlnet_config),
                        ("vae_config.json", self.vae_config)):
            with open(os.path.join(output_dir, name), "w") as f:
                json.dump(c.to_dict(), f, indent=2)
        save_checkpoint(output_dir, self.step, {
            "unet": self.unet.state_dict(),
            "controlnet": self.controlnet.state_dict(),
            "vae": self.vae.state_dict()})
