"""DDIM scheduler: the subset of diffusers' DDIMScheduler the protocol uses
(sampling step, closed-form inversion, add_noise). Counterpart of
``afldm_tpu/schedulers/ddim.py``.

Timesteps are Python integers (the samplers are Python loops), so every
schedule value is a float32 scalar read from the numpy table on the host.
"""

import numpy as np
import torch

from .common import make_betas, rescale_zero_terminal_snr, spaced_timesteps


class DDIMScheduler:
    init_noise_sigma = 1.0
    order = 1

    def __init__(self,
                 num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001,
                 beta_end: float = 0.02,
                 beta_schedule: str = "linear",
                 trained_betas=None,
                 clip_sample: bool = True,
                 set_alpha_to_one: bool = True,
                 steps_offset: int = 0,
                 prediction_type: str = "epsilon",
                 thresholding: bool = False,
                 clip_sample_range: float = 1.0,
                 timestep_spacing: str = "leading",
                 rescale_betas_zero_snr: bool = False,
                 **unused):
        self.config = dict(
            num_train_timesteps=num_train_timesteps, beta_start=beta_start,
            beta_end=beta_end, beta_schedule=beta_schedule,
            clip_sample=clip_sample, set_alpha_to_one=set_alpha_to_one,
            steps_offset=steps_offset, prediction_type=prediction_type,
            clip_sample_range=clip_sample_range,
            timestep_spacing=timestep_spacing,
            rescale_betas_zero_snr=rescale_betas_zero_snr,
        )
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self.final_alpha_cumprod = (np.float32(1.0) if set_alpha_to_one
                                    else self.alphas_cumprod[0])
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.num_inference_steps = None
        self.timesteps = np.arange(num_train_timesteps)[::-1].copy()

    @classmethod
    def from_config(cls, config: dict):
        return cls(**{k: v for k, v in config.items()
                      if not k.startswith("_")})

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Returns the descending timestep array (also stored)."""
        self.num_inference_steps = num_inference_steps
        self.timesteps = spaced_timesteps(
            self.num_train_timesteps, num_inference_steps,
            self.config["timestep_spacing"], self.config["steps_offset"])
        return self.timesteps

    def _alpha(self, t) -> np.float32:
        """alphas_cumprod[t]; t < 0 gives final_alpha_cumprod."""
        t = int(t)
        if t < 0:
            return np.float32(self.final_alpha_cumprod)
        return self.alphas_cumprod[min(t, self.num_train_timesteps - 1)]

    def _pred_x0_eps(self, model_output, sample, alpha_prod_t):
        beta_prod_t = np.float32(1) - alpha_prod_t
        sa, sb = float(alpha_prod_t ** 0.5), float(beta_prod_t ** 0.5)
        p = self.prediction_type
        if p == "epsilon":
            x0 = (sample - sb * model_output) / sa
            eps = model_output
        elif p == "sample":
            x0 = model_output
            eps = (sample - sa * x0) / sb
        elif p == "v_prediction":
            x0 = sa * sample - sb * model_output
            eps = sa * model_output + sb * sample
        else:
            raise ValueError(p)
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range,
                             self.clip_sample_range)
        return x0, eps

    def step(self, model_output, timestep, sample, prev_timestep=None):
        """One deterministic (eta = 0) DDIM update x_t -> x_{t-Δ}. Returns
        (prev_sample, pred_original_sample). Samplers pass
        ``prev_timestep``, fixed when they are built."""
        if prev_timestep is None:
            if self.num_inference_steps is None:
                raise RuntimeError("call set_timesteps first")
            prev_timestep = int(timestep) - (self.num_train_timesteps
                                             // self.num_inference_steps)
        alpha_prod_t = self._alpha(timestep)
        alpha_prod_prev = self._alpha(prev_timestep)
        x0, eps = self._pred_x0_eps(model_output, sample, alpha_prod_t)
        dir_xt = float((np.float32(1) - alpha_prod_prev) ** 0.5) * eps
        prev = float(alpha_prod_prev ** 0.5) * x0 + dir_xt
        return prev, x0

    def inversion_step(self, model_output, timestep_prev, timestep, latent):
        """Closed-form DDIM inversion x_{t-Δ} -> x_t: recover x0 under
        (mu_prev, sigma_prev) and re-noise under (mu, sigma)."""
        a = self._alpha(timestep)
        a_prev = self._alpha(timestep_prev)
        mu, mu_prev = float(a ** 0.5), float(a_prev ** 0.5)
        sigma = float((np.float32(1) - a) ** 0.5)
        sigma_prev = float((np.float32(1) - a_prev) ** 0.5)
        pred_x0 = (latent - sigma_prev * model_output) / mu_prev
        return mu * pred_x0 + sigma * model_output

    def add_noise(self, original_samples, noise, timesteps):
        """sqrt(a_t) x0 + sqrt(1 - a_t) noise, one timestep per sample."""
        ts = np.atleast_1d(np.asarray(timesteps))
        a = torch.tensor([self._alpha(t) for t in ts], dtype=torch.float32,
                         device=original_samples.device)
        a = a.reshape(-1, *([1] * (original_samples.ndim - 1)))
        return a ** 0.5 * original_samples + (1 - a) ** 0.5 * noise
