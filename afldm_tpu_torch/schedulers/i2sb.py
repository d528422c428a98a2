"""I2SB (image-to-image Schrödinger bridge) scheduler. Counterpart of
``afldm_tpu/schedulers/i2sb.py``: the forward/backward marginal stds and
the bridge posterior coefficients are float64 numpy tables cast to float32;
timesteps are Python integers (the sampler is a Python loop), so each
coefficient is a float32 scalar read from a table on the host.

Noise comes from an explicit ``noise`` tensor or a ``torch.Generator``.
"""

import numpy as np
import torch

from .common import make_betas, rescale_zero_terminal_snr, spaced_timesteps


def compute_gaussian_product_coef(sigma1, sigma2):
    """p1*p2 = N(coef1*x0 + coef2*x1, var) for p1 = N(x_t|x0, s1^2),
    p2 = N(x_t|x1, s2^2)."""
    denom = sigma1 ** 2 + sigma2 ** 2
    coef1 = sigma2 ** 2 / denom
    coef2 = sigma1 ** 2 / denom
    var = (sigma1 ** 2 * sigma2 ** 2) / denom
    return coef1, coef2, var


class I2SBScheduler:
    init_noise_sigma = 1.0
    order = 1

    def __init__(self,
                 num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001,
                 beta_end: float = 0.02,
                 beta_schedule: str = "linear",
                 trained_betas=None,
                 clip_sample: bool = True,
                 prediction_type: str = "epsilon",
                 thresholding: bool = False,
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
            clip_sample=clip_sample, prediction_type=prediction_type,
            clip_sample_range=clip_sample_range,
            timestep_spacing=timestep_spacing, steps_offset=steps_offset,
            rescale_betas_zero_snr=rescale_betas_zero_snr,
        )
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule, trained_betas)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.betas = betas

        std_fwd = np.sqrt(np.cumsum(betas))
        std_bwd = np.sqrt(np.cumsum(betas[::-1])[::-1])
        mu_x0, mu_x1, var = compute_gaussian_product_coef(std_fwd, std_bwd)
        self.std_fwd = std_fwd.astype(np.float32)
        self.std_bwd = std_bwd.astype(np.float32)
        self.std_sb = np.sqrt(var).astype(np.float32)
        self.mu_x0 = mu_x0.astype(np.float32)
        self.mu_x1 = mu_x1.astype(np.float32)

        self.num_train_timesteps = num_train_timesteps
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.num_inference_steps = None
        self.timesteps = np.arange(num_train_timesteps)[::-1].copy()

    @classmethod
    def from_config(cls, config: dict):
        return cls(**{k: v for k, v in config.items()
                      if not k.startswith("_")})

    def scale_model_input(self, sample, timestep=None):
        return sample

    def set_timesteps(self, num_inference_steps=None, timesteps=None):
        """Equal spacing, or custom descending ``timesteps``. Returns the
        descending timestep array (also stored)."""
        if (num_inference_steps is not None) == (timesteps is not None):
            raise ValueError(
                "pass exactly one of num_inference_steps / timesteps")
        if timesteps is not None:
            ts = np.asarray(timesteps, dtype=np.int64)
            if np.any(np.diff(ts) >= 0):
                raise ValueError("custom timesteps must be descending")
            if ts[0] >= self.num_train_timesteps:
                raise ValueError("timesteps must start below "
                                 f"{self.num_train_timesteps}")
            self.num_inference_steps = None
            self.custom_timesteps = True
        else:
            ts = spaced_timesteps(self.num_train_timesteps,
                                  num_inference_steps,
                                  self.config["timestep_spacing"],
                                  self.config["steps_offset"])
            self.num_inference_steps = num_inference_steps
            self.custom_timesteps = False
        self.timesteps = ts
        return ts

    def _at(self, table, t) -> np.float32:
        """table[t], t clamped to the table."""
        return table[min(max(int(t), 0), self.num_train_timesteps - 1)]

    def _per_sample(self, table, timesteps, like: torch.Tensor):
        """table[t] for one timestep per sample (or one for all), shaped to
        broadcast over ``like``."""
        ts = np.clip(np.atleast_1d(np.asarray(timesteps)), 0,
                     self.num_train_timesteps - 1)
        v = torch.as_tensor(table[ts], device=like.device)
        return v.reshape(-1, *([1] * (like.ndim - 1)))

    def step(self, model_output, timestep, prev_timestep, sample,
             is_ode=False, generator=None, noise=None):
        """Posterior step between two bridge times, ``prev_timestep``
        explicit (-1 after the last step gives ``std_fwd_prev = 0``). Off
        the ODE, the noise comes from ``noise`` or is drawn from
        ``generator``; with neither the step is deterministic. Returns
        (prev_sample, pred_original_sample)."""
        std_fwd = self._at(self.std_fwd, timestep)
        std_fwd_prev = (self._at(self.std_fwd, prev_timestep)
                        if int(prev_timestep) >= 0 else np.float32(0))
        std_delta = np.sqrt(np.maximum(std_fwd ** 2 - std_fwd_prev ** 2,
                                       np.float32(0)))

        pred_x0 = sample - float(std_fwd) * model_output
        if self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -self.clip_sample_range,
                                  self.clip_sample_range)

        mu_x0, mu_xt, var = compute_gaussian_product_coef(std_fwd_prev,
                                                          std_delta)
        prev = float(mu_x0) * pred_x0 + float(mu_xt) * sample

        if not is_ode and (noise is not None or generator is not None):
            if noise is None:
                noise = torch.randn(sample.shape, generator=generator,
                                    device=generator.device,
                                    dtype=sample.dtype)
            if int(timestep) > 0:
                prev = prev + float(np.sqrt(var)) * noise.to(sample.device)
        return prev, pred_x0

    def add_noise(self, x0, x1, timesteps, is_ode=False, noise=None,
                  generator=None):
        """Bridge marginal x_t = mu_x0 x0 + mu_x1 x1 (+ std_sb eps), one
        timestep per sample (or one for all)."""
        mu_x0 = self._per_sample(self.mu_x0, timesteps, x0)
        mu_x1 = self._per_sample(self.mu_x1, timesteps, x0)
        xt = mu_x0 * x0 + mu_x1 * x1
        if not is_ode:
            if noise is None:
                if generator is None:
                    raise ValueError("pass noise or a generator")
                noise = torch.randn(xt.shape, generator=generator,
                                    device=generator.device, dtype=xt.dtype)
            noise = noise.to(xt.device)
            xt = xt + self._per_sample(self.std_sb, timesteps, x0) * noise
        return xt

    def compute_label(self, timesteps, x0, xt):
        """Training target (xt - x0) / std_fwd."""
        return (xt - x0) / self._per_sample(self.std_fwd, timesteps, x0)

    def __len__(self):
        return self.num_train_timesteps
