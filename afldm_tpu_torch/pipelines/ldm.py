"""Unconditional latent-diffusion pipeline, NCHW. Counterpart of
``afldm_tpu/pipelines/ldm.py``: the denoising loop is a Python loop over
(t, t_prev), and cross-frame attention is an explicit per-step list of the
maps each attention layer stored (STORE) or reads (LOAD).
"""

import numpy as np
import torch

from ..models.unet2d import UNet2DModel
from ..models.vae import AutoencoderKL, gaussian_sample
from ..schedulers.ddim import DDIMScheduler


class LDMPipeline:
    """Bundles (vae, unet, scheduler); all methods run under
    ``torch.inference_mode`` on the device of the UNet's parameters."""

    # anything with ``encode(list of prompts) -> (n, 77, D)``; a pipeline of
    # a cross-attention UNet without one embeds every prompt as zeros
    text_encoder = None

    def __init__(self, vae: AutoencoderKL, unet: UNet2DModel,
                 scheduler: DDIMScheduler, scaling_factor: float = None):
        self.vae = vae
        self.unet = unet
        self.scheduler = scheduler
        self.scaling_factor = (scaling_factor if scaling_factor is not None
                               else vae.config.scaling_factor)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def prompt_embeds(self, batch: int = 1, prompt: str = ""):
        """(batch, 77, D) embeddings of ``prompt`` for a cross-attention
        UNet: the text encoder's, or zeros without one."""
        if self.text_encoder is not None:
            e = self.text_encoder.encode([prompt]).to(self.device)
        else:
            e = torch.zeros((1, 77, self.unet.config.cross_attention_dim),
                            device=self.device)
        return e.expand(batch, -1, -1)

    # -- VAE -------------------------------------------------------------------

    @torch.inference_mode()
    def encode(self, images, generator=None):
        """image -> scaled latent; samples the posterior when a generator
        is given, else takes its mean."""
        mean, logvar = self.vae.encode(images)
        z = gaussian_sample(mean, logvar, generator) \
            if generator is not None else mean
        return z * self.scaling_factor

    @torch.inference_mode()
    def decode(self, latents):
        """scaled latent -> image."""
        return self.vae.decode(latents / self.scaling_factor)

    # -- denoising loops -------------------------------------------------------

    def _eps(self, x, t, **kv):
        """The UNet's (noise prediction, stored maps) at (x, t); ``kv``
        are its cross-frame-attention inputs and the conditioning passed to
        ``denoise`` or ``ddim_inversion``. A conditioned pipeline applies
        its conditioning here."""
        return self.unet(x, t, **kv)

    def _schedule(self, num_steps: int):
        ts = self.scheduler.set_timesteps(num_steps)
        # fixed here, never derived from scheduler state inside the loop
        ts_prev = ts - self.scheduler.num_train_timesteps // num_steps
        return [int(t) for t in ts], [int(t) for t in ts_prev]

    def _step(self, eps, t: int, t_prev: int, x):
        """One sampler update x_t -> x_{t_prev} (DDIM here)."""
        return self.scheduler.step(eps, t, x, prev_timestep=t_prev)[0]

    def _walk(self, x, ts, ts_prev, update, kv_traj, kv_traj2, alpha,
              collect_kv, conditioning):
        """The loop of ``denoise`` and ``ddim_inversion``: one ``_eps`` and
        one ``update(eps, t, t_prev, x)`` a step."""
        traj = [] if (collect_kv and kv_traj is None) else None
        if alpha is not None:  # moved to the device once, not per layer
            alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                    device=x.device)
        for i, (t, pt) in enumerate(zip(ts, ts_prev)):
            kv_in = None if kv_traj is None else kv_traj[i]
            kv_in2 = None if kv_traj2 is None else kv_traj2[i]
            eps, stored = self._eps(x, t, kv_in=kv_in, kv_in2=kv_in2,
                                    alpha=alpha, **conditioning)
            # a bf16 model's eps is promoted to the latents' dtype: the
            # sampler's arithmetic stays in it, as in the JAX package
            x = update(eps.to(torch.promote_types(eps.dtype, x.dtype)), t,
                       pt, x)
            if traj is not None:
                traj.append(stored)
        return x, traj

    @torch.inference_mode()
    def denoise(self, latents, num_inference_steps: int = 50, kv_traj=None,
                kv_traj2=None, alpha=None, collect_kv: bool = False,
                start_step: int = 0, **conditioning):
        """Full DDIM denoise, or its last steps from ``start_step`` on (the
        img2img truncation). Without ``kv_traj`` (STORE) returns (latents,
        per-step stored maps if ``collect_kv`` else None); with a
        trajectory from a STORE pass (LOAD) each step reads its maps; with
        two (interp) each step blends the attention over both with
        ``alpha`` (a scalar or one per frame). LOAD and interp return
        (latents, None). ``conditioning`` goes to ``_eps``."""
        ts, ts_prev = self._schedule(num_inference_steps)
        return self._walk(latents, ts[start_step:], ts_prev[start_step:],
                          self._step, kv_traj, kv_traj2, alpha, collect_kv,
                          conditioning)

    @torch.inference_mode()
    def ddim_inversion(self, latents, num_inference_steps: int = 50,
                       kv_traj=None, collect_kv: bool = False,
                       start_step: int = 0, **conditioning):
        """Closed-form DDIM inversion, from x_0 up the schedule (up its
        steps from ``start_step`` on, reversed), the first step from
        timestep -1. STORE and LOAD, the return value and ``conditioning``
        as in ``denoise``."""
        ts, _ = self._schedule(num_inference_steps)
        ts_up = ts[start_step:][::-1]
        ts_prev = [-1] + ts_up[:-1]

        def update(eps, t, t_prev, x):
            return self.scheduler.inversion_step(eps, t_prev, t, x)
        return self._walk(latents, ts_up, ts_prev, update, kv_traj, None,
                          None, collect_kv, conditioning)

    # -- generation ------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, batch_size: int = 1, generator=None, latents=None,
                 num_inference_steps: int = 50, output_type: str = "np"):
        """Sample images: "np" gives NHWC numpy in [0, 1], "latent" the
        latents, anything else the decoded NCHW tensor."""
        cfg = self.unet.config
        if latents is None:
            if generator is None:
                raise ValueError("pass latents or a generator")
            latents = torch.randn(
                (batch_size, cfg.in_channels, cfg.sample_size,
                 cfg.sample_size), generator=generator, device=self.device)
        latents = latents * self.scheduler.init_noise_sigma
        latents, _ = self.denoise(latents, num_inference_steps)
        if output_type == "latent":
            return latents
        image = self.decode(latents)
        if output_type == "np":
            img = image.permute(0, 2, 3, 1).float().cpu().numpy()
            return np.clip(img / 2 + 0.5, 0, 1)
        return image
