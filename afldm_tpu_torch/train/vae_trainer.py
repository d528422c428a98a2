"""AF-VAE trainer: MSE + perceptual + KL + the encoder/decoder shift losses,
with an optional hinge-GAN discriminator that alternates with the
generator by step parity and an adaptive generator weight
``|grad(rec)| / |grad(g)|`` at the decoder's output conv. Counterpart of
``afldm_tpu/train/vae_trainer.py``.

As in the LDM trainer, the loss is split from its random draws:
``loss_fn(images, draws)`` takes the posterior noises and the integer shift
offsets explicitly, and ``training_step`` draws them from a generator
seeded by (seed, step). Gradients stop where the JAX package stops them:
at the latents and the reconstruction that the shifted passes are held
against, at the reconstruction the discriminator step sees, and at the
adaptive weight.
"""

import copy
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..models import (AutoencoderKL, AutoencoderKLConfig, Discriminator,
                      gaussian_kl, gaussian_sample)
from ..pipelines.loading import init_random_weights
from ..shift.metrics import mask_mse, psnr
from ..shift.shifters import ImageShifter
from . import perceptual
from .checkpoint import save_checkpoint
from .ema import EMA
from .trainer import Trainer, TrainOptimizer, checkpointed, load_json


class VAETrainer(Trainer):

    def init_modules(self, vae_config=None, disc_config=None):
        """Configs may be passed directly or read from ``cfg.model_cfg`` /
        ``cfg.disc_cfg``, as the JAX trainer reads them."""
        cfg = self.cfg
        if vae_config is None:
            vae_config = load_json(cfg.model_cfg)
        if isinstance(vae_config, dict):
            vae_config = AutoencoderKLConfig.from_diffusers(vae_config)
        self.vae_config = vae_config
        self.vae = AutoencoderKL(vae_config,
                                 remat=self.base_cfg.gradient_checkpointing)
        self.disc = None
        if cfg.use_disc:
            if disc_config is None:
                disc_config = load_json(cfg.disc_cfg) if cfg.disc_cfg else {}
            disc_config = {k: v for k, v in disc_config.items()
                           if not k.startswith("_")}
            self.disc = Discriminator(
                **{"in_channels": vae_config.in_channels, **disc_config})
        d = vae_config.downsample_ratio
        self.img_shifter = ImageShifter("ideal_crop", 1)
        self.latent_shifter = ImageShifter("ideal_crop", d)
        self.d_factor = d
        if cfg.lpips_vgg_path:
            perceptual.load_lpips_vgg_features(cfg.lpips_vgg_path)

    def init_optimizers(self, total_steps=None):
        self.total_steps = total_steps

    def prepare_modules(self, seed: int = 0, vae_state=None,
                        disc_state=None):
        """Random weights from ``seed`` (LeCun-normal, drawn on the CPU) or
        the given state dicts, then the optimizers (the generator's with
        ``cfg.gradient_accumulation_steps``), the EMA and the
        (checkpointed when ``gradient_checkpointing``) encode and decode."""
        cfg, base = self.cfg, self.base_cfg
        gen = torch.Generator().manual_seed(seed)
        init_random_weights(self.vae, gen)
        if vae_state is not None:
            self.vae.load_state_dict(vae_state, strict=True)
        self.vae.to(self.device).train()
        self.opt = TrainOptimizer(
            self.vae.parameters(), cfg, self.total_steps,
            grad_accum=cfg.gradient_accumulation_steps,
            train_batch_size=base.train_batch_size)
        self.ema = EMA(self.vae.parameters()) if cfg.use_ema else None
        self.disc_opt = None
        if self.disc is not None:
            init_random_weights(self.disc, gen)
            if disc_state is not None:
                self.disc.load_state_dict(disc_state, strict=True)
            self.disc.to(self.device).train()
            self.disc_opt = TrainOptimizer(self.disc.parameters(), cfg,
                                           self.total_steps)
        self.step = self.disc_step = 0
        if base.gradient_checkpointing:
            # the outer level: each encode / decode holds only its input
            # until the backward pass (the inner level is the model's remat)
            self.encode = checkpointed(self.vae.encode, base.remat_policy)
            self.decode = checkpointed(self.vae.decode, base.remat_policy)
        else:
            self.encode, self.decode = self.vae.encode, self.vae.decode

    # -- the step ----------------------------------------------------------

    def draw(self, global_step: int, batch_size: int) -> dict:
        """The step's random draws, from a CPU generator seeded by
        (seed, step): the posterior noise of the reconstruction
        (``eps``), of the shifted encode (``eps_shift``) and of the
        discriminator step (``eps_disc``), and the integer image offsets
        ``ti``, ``tj`` up to resolution * 0.75 / 2."""
        seed = self.base_cfg.seed or 0
        gen = torch.Generator().manual_seed(seed * 2 ** 32 + global_step)
        vc = self.vae_config
        res = self.base_cfg.resolution
        lat = (batch_size, vc.latent_channels, res // vc.downsample_ratio,
               res // vc.downsample_ratio)
        max_off = int(res * 0.75 // 2)
        ti, tj = (int(torch.randint(-max_off, max_off + 1, (), generator=gen))
                  for _ in range(2))
        return {"eps": torch.randn(lat, generator=gen),
                "eps_shift": torch.randn(lat, generator=gen),
                "eps_disc": torch.randn(lat, generator=gen),
                "ti": ti, "tj": tj}

    def loss_fn(self, images, draws):
        """images: NCHW in [-1, 1] on the trainer's device. Returns (loss,
        terms): loss = rec_total + shift_loss + kl_weight * kl_loss, and
        ``terms`` the tensors mse_loss, perceptual_loss, kl_loss,
        shift_loss, disc_loss (the generator's GAN term, 0 without a
        discriminator) and rec_total, with their graphs."""
        cfg = self.cfg
        dev = images.device
        zero = torch.zeros((), device=dev)
        mean, logvar = self.encode(images)
        latents = gaussian_sample(mean, logvar, noise=draws["eps"].to(dev))
        recon = self.decode(latents)
        mse = torch.mean((images - recon) ** 2)
        p_loss = (perceptual.perceptual_loss(images, recon)
                  if cfg.perceptual_weight else zero)
        kl = gaussian_kl(mean, logvar)

        shift_loss = zero
        if cfg.use_shift_loss:
            ti, tj, d = draws["ti"], draws["tj"], self.d_factor
            # encoder: E(T x) against T E(x)
            t_f_x, mask = self.latent_shifter.shift(latents.detach(),
                                                    ti / d, tj / d)
            t_x, _ = self.img_shifter.shift(images, ti, tj)
            m2, lv2 = self.encode(t_x)
            f_t_x = gaussian_sample(m2, lv2,
                                    noise=draws["eps_shift"].to(dev))
            enc_loss = mask_mse(f_t_x, t_f_x, mask)
            # decoder: D(T z) against T D(z); T z is the shifted latent
            # above (the same shift of the same detached latents)
            t_f_x2, mask2 = self.img_shifter.shift(recon.detach(), ti, tj)
            f_t_x2 = self.decode(t_f_x)
            dec_loss = mask_mse(f_t_x2, t_f_x2, mask2)
            shift_loss = enc_loss + dec_loss

        disc_loss = -torch.mean(self.disc(recon)) if cfg.use_disc else zero
        rec_total = mse + cfg.perceptual_weight * p_loss
        loss = rec_total + shift_loss + cfg.kl_weight * kl
        return loss, {"mse_loss": mse, "perceptual_loss": p_loss,
                      "kl_loss": kl, "shift_loss": shift_loss,
                      "disc_loss": disc_loss, "rec_total": rec_total}

    def adaptive_weight(self, images, draws):
        """|grad(rec_total)| / (|grad(disc_loss)| + 1e-4) at the decoder's
        output conv weight, clipped to [0, 1e4], times ``disc_weight``; no
        gradient flows through it. From a reconstruction pass of its own,
        as the JAX step takes it, so that the loss's pass is differentiated
        once (selective checkpointing allows no second backward)."""
        mean, logvar = self.vae.encode(images)
        recon = self.vae.decode(gaussian_sample(
            mean, logvar, noise=draws["eps"].to(images.device)))
        rec = torch.mean((images - recon) ** 2)
        if self.cfg.perceptual_weight:
            rec = rec + self.cfg.perceptual_weight * \
                perceptual.perceptual_loss(images, recon)
        w = self.vae.decoder.conv_out.weight
        nll_g, = torch.autograd.grad(rec, w, retain_graph=True)
        gan_g, = torch.autograd.grad(-torch.mean(self.disc(recon)), w)
        d_weight = (torch.linalg.vector_norm(nll_g)
                    / (torch.linalg.vector_norm(gan_g) + 1e-4))
        return d_weight.clamp(0.0, 1e4).detach() * self.cfg.disc_weight

    def generator_backward(self, images, draws) -> dict:
        """The generator's loss, with the adaptive GAN term when there is a
        discriminator, and its backward pass into the VAE's ``.grad``
        (the discriminator gets none). Returns the logged terms."""
        if self.disc is not None:
            self.disc.requires_grad_(False)
        d_weight = (self.adaptive_weight(images, draws) if self.cfg.use_disc
                    else None)
        loss, terms = self.loss_fn(images, draws)
        logs = {k: v.detach() for k, v in terms.items()}
        if d_weight is not None:
            loss = loss + d_weight * terms["disc_loss"]
            logs["d_weight"] = d_weight
        loss.backward()
        logs["train_loss"] = loss.detach()
        return logs

    def disc_loss_fn(self, images, draws):
        """Hinge loss of the discriminator on the images against their
        reconstruction, which carries no gradient to the VAE."""
        with torch.no_grad():
            mean, logvar = self.vae.encode(images)
            recon = self.vae.decode(gaussian_sample(
                mean, logvar, noise=draws["eps_disc"].to(images.device)))
        real, fake = self.disc(images), self.disc(recon)
        return torch.mean(F.relu(1 + fake) + F.relu(1 - real)) * 0.5

    def disc_backward(self, images, draws) -> dict:
        """The discriminator's loss and its backward pass into the
        discriminator's ``.grad``."""
        self.disc.requires_grad_(True)
        loss = self.disc_loss_fn(images, draws)
        loss.backward()
        return {"train_loss_disc": loss.detach()}

    def is_generator_step(self, global_step: int) -> bool:
        """The generator and the discriminator alternate every
        ``gradient_accumulation_steps`` micro-batches."""
        return (not self.cfg.use_disc
                or (global_step // self.cfg.gradient_accumulation_steps)
                % 2 == 0)

    def training_step(self, global_step, batch, draws=None) -> dict:
        """One micro-batch of the generator (loss, backward, optimizer every
        ``gradient_accumulation_steps`` micro-batches, EMA every call) or of
        the discriminator. ``batch["input"]``: NHWC in [-1, 1]; ``draws``
        (as ``draw`` returns them) replace the step's own."""
        images = torch.as_tensor(batch["input"]).permute(0, 3, 1, 2)
        images = images.to(self.device, torch.float32).contiguous()
        if draws is None:
            draws = self.draw(global_step, images.shape[0])
        if self.is_generator_step(global_step):
            logs = self.generator_backward(images, draws)
            self.opt.step()
            if self.ema is not None:
                self.ema.update(self.vae.parameters())
            self.step += 1
        else:
            logs = self.disc_backward(images, draws)
            self.disc_opt.step()
            self.disc_step += 1
        return {k: float(v) for k, v in logs.items()}

    # -- checkpoints ---------------------------------------------------------

    def state_for_checkpoint(self) -> dict:
        state = {"vae": self.vae.state_dict(),
                 "optimizer": self.opt.state_dict(),
                 "ema": self.ema.state_dict() if self.ema else {},
                 "step": self.step}
        if self.disc is not None:
            state.update(disc=self.disc.state_dict(),
                         disc_optimizer=self.disc_opt.state_dict(),
                         disc_step=self.disc_step)
        return state

    def load_state(self, state: dict):
        self.vae.load_state_dict(state["vae"], strict=True)
        self.opt.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.step = int(state["step"])
        if self.disc is not None:
            self.disc.load_state_dict(state["disc"], strict=True)
            self.disc_opt.load_state_dict(state["disc_optimizer"])
            self.disc_step = int(state["disc_step"])

    # -- validation / export -------------------------------------------------

    def _ema_state(self) -> dict:
        if self.ema is None:
            return {}
        return {n: e for (n, _), e in zip(self.vae.named_parameters(),
                                          self.ema.params)}

    def eval_model(self) -> AutoencoderKL:
        """The VAE with the EMA weights when ``use_ema``, else itself."""
        if self.ema is None:
            return self.vae
        model = copy.deepcopy(self.vae)
        model.load_state_dict(self._ema_state(), strict=True)
        return model

    def _batch_metrics(self, model, x):
        """mse, perceptual distance, PSNR and the last stage's mean
        features of the images and of their reconstruction, from one pass
        of the perceptual bank per image."""
        rx = model(x)[0]
        bank = perceptual._filters()
        is_vgg = perceptual._is_vgg(bank)
        a, b = ((perceptual._lpips_scale(x), perceptual._lpips_scale(rx))
                if is_vgg else (x, rx))
        fa = perceptual._features(a, bank, max_pool=is_vgg)
        fb = perceptual._features(b, bank, max_pool=is_vgg)
        perc = sum(torch.mean((u - v) ** 2) for u, v in zip(fa, fb))
        return (torch.mean((x - rx) ** 2), perc, psnr(x, rx),
                fa[-1].mean(dim=(2, 3)), fb[-1].mean(dim=(2, 3)))

    @torch.no_grad()
    def validate(self, global_step, images=None) -> dict:
        """Reconstruction of the first (up to 5) training images, or of
        ``images`` (NHWC); with ``valid_data_dir`` also the valid set's
        mean MSE, perceptual distance, PSNR and the Frechet distance of
        the perceptual features of images and reconstructions."""
        if images is None and getattr(self, "dataset", None) is not None:
            images = np.stack([self.dataset[i]["input"]
                               for i in range(min(5, len(self.dataset)))])
        if images is None:
            return {}
        x = torch.as_tensor(images).permute(0, 3, 1, 2).to(self.device,
                                                          torch.float32)
        model = self.eval_model()
        recon = model(x)[0]
        out = {"val_mse": float(torch.mean((recon - x) ** 2)),
               "recon": recon.permute(0, 2, 3, 1).cpu().numpy()}
        vdir = self.base_cfg.valid_data_dir
        if vdir and os.path.isdir(vdir):
            from ..utils.metric_utils import FeatureStats, frechet_distance
            from .data import ImageFolderDataset, epoch_batches
            vds = ImageFolderDataset(vdir, resolution=self.base_cfg.resolution,
                                     random_flip=False)
            st_real = FeatureStats(capture_mean_cov=True)
            st_recon = FeatureStats(capture_mean_cov=True)
            tot_mse = tot_p = tot_psnr = n = 0.0
            for b in epoch_batches(vds, min(4, len(vds)), seed=0):
                xb = torch.from_numpy(b["input"]).permute(0, 3, 1, 2).to(
                    self.device)
                mse, perc, p, px, prx = self._batch_metrics(model, xb)
                k = xb.shape[0]
                tot_mse += float(mse) * k
                tot_p += float(perc) * k
                tot_psnr += float(p) * k
                st_real.append(px)
                st_recon.append(prx)
                n += k
            if n:
                out.update(valid_mse=tot_mse / n, valid_perceptual=tot_p / n,
                           valid_psnr=tot_psnr / n,
                           valid_recon_ffd=frechet_distance(st_real,
                                                            st_recon))
        return out

    def save_pipeline(self, output_dir):
        """``vae_config.json`` and ``checkpoint-{step}`` with the ``vae``
        and ``model_ema`` state dicts: the layout ``LDMTrainer`` reads
        from ``vae_path``."""
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "vae_config.json"), "w") as f:
            json.dump(self.vae_config.to_dict(), f, indent=2)
        save_checkpoint(output_dir, self.step,
                        {"vae": self.vae.state_dict(),
                         "model_ema": self._ema_state()})
