"""Latent I2SB super-resolution pipeline. Counterpart of
``afldm_tpu/pipelines/i2sb.py``: encode the degraded image (posterior
mean) as the bridge start x1, run the I2SB posterior in ODE mode over the
pairs (t_i, t_{i+1}) for i < n-1 (the final step is skipped: n-1 UNet
passes), decode. STORE and LOAD work as in ``LDMPipeline.denoise``; interp
mode has no I2SB counterpart and raises.
"""

import numpy as np
import torch

from ..schedulers.i2sb import I2SBScheduler
from .ldm import LDMPipeline


class I2SBLDMPipeline(LDMPipeline):
    scheduler: I2SBScheduler

    def _schedule(self, num_steps: int):
        ts = [int(t) for t in self.scheduler.set_timesteps(num_steps)]
        return ts[:-1], ts[1:]

    def _step(self, eps, t: int, t_prev: int, x):
        return self.scheduler.step(eps, t, t_prev, x, is_ode=True)[0]

    def denoise(self, latents, num_inference_steps: int = 50, kv_traj=None,
                kv_traj2=None, alpha=None, collect_kv: bool = False):
        if kv_traj2 is not None:
            raise ValueError("I2SB pipeline has no 'interp' mode")
        return super().denoise(latents, num_inference_steps, kv_traj=kv_traj,
                               collect_kv=collect_kv)

    @torch.inference_mode()
    def __call__(self, lq_images, num_inference_steps: int = 50,
                 output_type: str = "np"):
        """Super-resolve degraded NCHW images, already at the target
        resolution (e.g. ``degrade_sr4x``: 4x-bicubic-degraded, then
        re-upsampled). "np" gives NHWC numpy in [0, 1], "latent" the
        latents, anything else the decoded NCHW tensor."""
        x1 = self.encode(lq_images.to(self.device))  # the posterior mean
        latents, _ = self.denoise(x1, num_inference_steps)
        if output_type == "latent":
            return latents
        image = self.decode(latents)
        if output_type == "np":
            img = image.permute(0, 2, 3, 1).float().cpu().numpy()
            return np.clip(img / 2 + 0.5, 0, 1)
        return image
