"""DDPM scheduler: the training-side subset the LDM trainer uses (add_noise,
get_velocity and the ancestral step), diffusers DDPMScheduler semantics,
loaded from the same JSON configs. Counterpart of
``afldm_tpu/schedulers/ddpm.py``.

Timesteps may be Python integers or integer tensors (one per batch row);
schedule values are read from the float32 numpy tables.
"""

import numpy as np
import torch

from .common import make_betas, rescale_zero_terminal_snr, spaced_timesteps


class DDPMScheduler:
    init_noise_sigma = 1.0
    order = 1

    def __init__(self,
                 num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001,
                 beta_end: float = 0.02,
                 beta_schedule: str = "linear",
                 trained_betas=None,
                 variance_type: str = "fixed_small",
                 clip_sample: bool = True,
                 prediction_type: str = "epsilon",
                 clip_sample_range: float = 1.0,
                 timestep_spacing: str = "leading",
                 steps_offset: int = 0,
                 rescale_betas_zero_snr: bool = False,
                 **unused):
        self.config = dict(
            num_train_timesteps=num_train_timesteps, beta_start=beta_start,
            beta_end=beta_end, beta_schedule=beta_schedule,
            trained_betas=(None if trained_betas is None
                           else list(np.asarray(trained_betas, np.float64))),
            variance_type=variance_type, clip_sample=clip_sample,
            prediction_type=prediction_type,
            clip_sample_range=clip_sample_range,
            timestep_spacing=timestep_spacing, steps_offset=steps_offset,
            rescale_betas_zero_snr=rescale_betas_zero_snr,
        )
        if variance_type not in ("fixed_small", "fixed_large"):
            # learned / learned_range need a 2x-channel model output split
            # that neither package implements: fail at load, not sampling
            raise NotImplementedError(
                f"variance_type={variance_type!r} (supported: fixed_small, "
                f"fixed_large)")
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas
        self.alphas = (1.0 - betas).astype(np.float32)
        self.alphas_cumprod = np.cumprod(self.alphas).astype(np.float32)
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.variance_type = variance_type
        self.num_inference_steps = None
        self.timesteps = np.arange(num_train_timesteps)[::-1].copy()
        self._acp = {}

    @classmethod
    def from_config(cls, config: dict):
        return cls(**{k: v for k, v in config.items()
                      if not k.startswith("_")})

    def scale_model_input(self, sample, timestep=None):
        return sample

    def set_timesteps(self, num_inference_steps: int):
        self.num_inference_steps = num_inference_steps
        self.timesteps = spaced_timesteps(
            self.num_train_timesteps, num_inference_steps,
            self.config["timestep_spacing"], self.config["steps_offset"])
        return self.timesteps

    def _alpha(self, t, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] (1 for t < 0), shaped to broadcast over
        ``like`` from its first dims."""
        dev = like.device
        if dev not in self._acp:
            with torch.inference_mode(False):  # see ideal_lpf._op
                self._acp[dev] = torch.from_numpy(
                    self.alphas_cumprod).to(dev)
        t = torch.as_tensor(t, device=dev)
        a = self._acp[dev][t.clamp(0, self.num_train_timesteps - 1)]
        a = torch.where(t >= 0, a, torch.ones_like(a))
        return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))

    def add_noise(self, original_samples, noise, timesteps):
        a = self._alpha(timesteps, original_samples)
        return a ** 0.5 * original_samples + (1 - a) ** 0.5 * noise

    def get_velocity(self, sample, noise, timesteps):
        a = self._alpha(timesteps, sample)
        return a ** 0.5 * noise - (1 - a) ** 0.5 * sample

    def step(self, model_output, timestep, sample, generator=None):
        """Ancestral DDPM update. Returns (prev_sample,
        pred_original_sample); noise is added when a generator is given."""
        num_inference_steps = (self.num_inference_steps
                               or self.num_train_timesteps)
        dt = self.num_train_timesteps // num_inference_steps
        t = torch.as_tensor(timestep, device=sample.device)

        alpha_prod_t = self._alpha(t, sample)
        alpha_prod_prev = self._alpha(t - dt, sample)
        beta_prod_t = 1 - alpha_prod_t
        beta_prod_prev = 1 - alpha_prod_prev
        current_alpha = alpha_prod_t / alpha_prod_prev
        current_beta = 1 - current_alpha

        p = self.prediction_type
        if p == "epsilon":
            x0 = ((sample - beta_prod_t ** 0.5 * model_output)
                  / alpha_prod_t ** 0.5)
        elif p == "sample":
            x0 = model_output
        elif p == "v_prediction":
            x0 = (alpha_prod_t ** 0.5 * sample
                  - beta_prod_t ** 0.5 * model_output)
        else:
            raise ValueError(p)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)

        pred_coef = alpha_prod_prev ** 0.5 * current_beta / beta_prod_t
        cur_coef = current_alpha ** 0.5 * beta_prod_prev / beta_prod_t
        prev = pred_coef * x0 + cur_coef * sample

        if self.variance_type == "fixed_large":
            # diffusers _get_variance: fixed_large uses the current beta_t
            variance = current_beta
        else:
            variance = (beta_prod_prev / beta_prod_t
                        * current_beta).clamp(min=1e-20)
        if generator is not None:
            noise = torch.randn(sample.shape, generator=generator,
                                device=sample.device, dtype=sample.dtype)
            std = torch.where(t.reshape(t.shape + (1,) * (
                sample.ndim - t.ndim)) > 0, variance ** 0.5,
                torch.zeros_like(variance))
            prev = prev + std * noise
        return prev, x0
