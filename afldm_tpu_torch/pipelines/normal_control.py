"""Normal estimation with the latent ControlNet, and its shift sweep, NCHW.
Counterpart of ``afldm_tpu/pipelines/normal_control.py``: the YOSO mode
predicts the normal latent in one step at t = 999 from a zero (or random)
start latent, conditioned on the encoded input image; the multi-step mode
denoises from noise with DDIM, optionally with classifier-free guidance
and guess mode. The sweep shifts both the start latent and the condition
latent by k/8 latent px (k px of the image), runs the base and every shift
as one batch, and scores the masked PSNR of each shifted output against
the bilinear pixel shift of the base output.

The gaussian start latent is passed in (``noise``) or drawn on the CPU
from an explicit ``torch.Generator``, so a seed gives the same normals on
every device.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..shift.metrics import mask_psnr
from ..shift.shifters import ImageShifter
from ._frames import DECODE_CHUNK, decode_chunked
from .ldm import LDMPipeline

YOSO_TIMESTEP = 999


@dataclass
class NormalEstimationResult:
    normals: np.ndarray      # (1 + num_shift_steps, H, W, 3), NHWC
    psnrs: np.ndarray        # (num_shift_steps,)

    @property
    def mean_psnr(self):
        return float(self.psnrs.mean())


class NormControlPipeline(LDMPipeline):
    """(vae, SD-family ``UNet2DConditionModel``, ``ControlNetModel``,
    scheduler). Without a ``text_encoder`` (anything with ``encode(list of
    prompts) -> (n, 77, D)``) every prompt is the zero embedding."""

    def __init__(self, vae, unet, controlnet, scheduler, text_encoder=None,
                 scaling_factor=None):
        super().__init__(vae, unet, scheduler, scaling_factor)
        self.controlnet = controlnet
        self.text_encoder = text_encoder

    def _eps(self, x, t, ehs, cond, guidance_scale: float = 1.0,
             guess_mode: bool = False, **kv):
        """The UNet's (noise prediction, stored maps) at (x, t) with the
        ControlNet's residuals of the condition latent ``cond``. With
        guidance above 1 the batch is doubled against the [uncond, cond]
        halves of ``ehs`` and combined; guess mode then runs the
        ControlNet on the conditional half only, its residuals zero for the
        unconditional half."""
        if guidance_scale <= 1.0:
            down, mid, _ = self.controlnet(x, t, ehs, cond,
                                           guess_mode=guess_mode)
            return self.unet(x, t, ehs, down_block_residuals=down,
                             mid_block_residual=mid, **kv)
        inp = torch.cat([x, x])
        if guess_mode:
            down, mid, _ = self.controlnet(x, t, ehs.chunk(2)[1], cond,
                                           guess_mode=True)
            down = tuple(torch.cat([torch.zeros_like(r), r]) for r in down)
            mid = torch.cat([torch.zeros_like(mid), mid])
        else:
            down, mid, _ = self.controlnet(inp, t, ehs,
                                           torch.cat([cond, cond]))
        eps, stored = self.unet(inp, t, ehs, down_block_residuals=down,
                                mid_block_residual=mid, **kv)
        eps_u, eps_c = eps.chunk(2)
        return eps_u + guidance_scale * (eps_c - eps_u), stored

    def _start_latent(self, shape, noise, generator):
        if noise is None:
            if generator is None:
                raise ValueError("a random start latent needs noise or a "
                                 "generator")
            noise = torch.randn(shape, generator=generator)
        return noise.to(self.device)

    @torch.inference_mode()
    def __call__(self, image, num_shift_steps: int = 16,
                 from_zero: bool = True, noise=None, generator=None,
                 prompt: str = "", is_yoso: bool = True,
                 num_inference_steps: int = 20, guidance_scale: float = 1.0,
                 guess_mode: bool = False,
                 negative_prompt: str = "") -> NormalEstimationResult:
        """Normals of a (1, 3, H, W) image in [-1, 1] and of its
        ``num_shift_steps`` shifts, as the decoder gives them (NHWC, about
        [-1, 1]), with the masked PSNR of each shift. The start latent is
        zero (YOSO with ``from_zero``), else ``noise`` or a draw from
        ``generator``, times ``init_noise_sigma`` in the multi-step
        branch."""
        ratio = self.vae.config.downsample_ratio
        shifter = ImageShifter("ideal_crop", upsample_ratio=ratio)
        cond0 = self.encode(image.to(self.device))
        if not is_yoso:
            lat0 = (self._start_latent(cond0.shape, noise, generator)
                    * self.scheduler.init_noise_sigma)
        elif from_zero:
            lat0 = torch.zeros_like(cond0)
        else:
            lat0 = self._start_latent(cond0.shape, noise, generator)

        # base + every shift in one batch; the start latent shifts with the
        # condition (zeros are shift-invariant)
        cache_c, cache_l = shifter.precompute(cond0), shifter.precompute(lat0)
        conds, lats, masks = [cond0], [lat0], [torch.ones_like(cond0)]
        for k in range(1, num_shift_steps + 1):
            c, m = shifter.shift(cond0, 0.0, k / ratio, cache=cache_c)
            lat, _ = shifter.shift(lat0, 0.0, k / ratio, cache=cache_l)
            conds.append(c)
            lats.append(lat)
            masks.append(m)
        conds, lats = torch.cat(conds), torch.cat(lats)
        masks = torch.cat(masks)
        del cache_c, cache_l

        n = conds.shape[0]
        ehs = self.prompt_embeds(n, prompt)
        if is_yoso:
            t = torch.full((n,), YOSO_TIMESTEP, device=self.device)
            preds = self._eps(lats, t, ehs, conds)[0]  # maps freed now
        else:
            if guidance_scale > 1.0:
                ehs = torch.cat([self.prompt_embeds(n, negative_prompt), ehs])
            preds, _ = self.denoise(lats, num_inference_steps, ehs=ehs,
                                    cond=conds, guidance_scale=guidance_scale,
                                    guess_mode=guess_mode)
        normals = decode_chunked(self.decode, preds * masks, DECODE_CHUNK)

        img_shifter = ImageShifter()
        base = normals[0:1]
        psnrs = []
        for k in range(1, num_shift_steps + 1):
            gt, m = img_shifter.shift(base, 0.0, float(k))
            psnrs.append(mask_psnr(normals[k:k + 1], gt, m))
        psnrs = torch.stack(psnrs) if psnrs else torch.zeros(0)
        return NormalEstimationResult(
            normals=normals.permute(0, 2, 3, 1).float().cpu().numpy(),
            psnrs=psnrs.float().cpu().numpy())
