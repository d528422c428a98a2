"""Video editing with cross-frame attention, NCHW. Counterpart of
``afldm_tpu/pipelines/video_editing.py``: every frame is edited with SD
and classifier-free guidance while each self-attention takes its K/V from
frame 0's trajectory, so that the edit stays consistent across frames.

1. start latents: SDEdit (the encoded frames noised to the first step of
   the strength-truncated schedule) or a DDIM inversion up that schedule,
   frame 0 alone storing its maps and the other frames loading them;
2. STORE: frame 0 denoised at CFG batch 2 ([uncond, cond]), collecting the
   maps of every step;
3. LOAD: all frames denoised together at CFG batch 2N ([uncond x N,
   cond x N]), each step reading the maps frame 0 stored at that step (a
   stored map of batch 2 serves each half);
4. a frame-chunked decode.

The SDEdit noise is passed in or drawn on the CPU from an explicit
``torch.Generator``, so a seed gives the same frames on every device.
Frame sharding over several cards is not ported.
"""

import numpy as np
import torch

from ._frames import DECODE_CHUNK, decode_chunked
from .ldm import LDMPipeline


class VideoEquivEditingPipeline(LDMPipeline):
    """(vae, SD-family ``UNet2DConditionModel``, DDIM scheduler). Without a
    ``text_encoder`` (anything with ``encode(list of prompts) -> (n, 77,
    D)``) every prompt is the zero embedding."""

    def __init__(self, vae, unet, scheduler, text_encoder=None,
                 scaling_factor=None):
        super().__init__(vae, unet, scheduler, scaling_factor)
        self.text_encoder = text_encoder

    def encode_prompt(self, prompt: str, negative_prompt: str = "",
                      batch: int = 1):
        """(uncond, cond) embeddings, ``batch`` rows each."""
        return (self.prompt_embeds(batch, negative_prompt),
                self.prompt_embeds(batch, prompt))

    def get_timesteps(self, num_inference_steps: int, strength: float):
        """The last ``strength`` share of the schedule (diffusers' img2img
        truncation), as Python ints, descending."""
        ts = self.scheduler.set_timesteps(num_inference_steps)
        init_t = min(int(num_inference_steps * strength),
                     num_inference_steps)
        if init_t < 1:
            raise ValueError(
                f"strength={strength} with num_inference_steps="
                f"{num_inference_steps} truncates to ZERO denoise steps; "
                f"raise strength to at least 1/num_inference_steps")
        return [int(t) for t in ts[num_inference_steps - init_t:]]

    @staticmethod
    def _cfg(eps, guidance_scale: float, guidance_rescale: float):
        """The CFG combine of the [uncond, cond] halves; with
        ``guidance_rescale`` the guided noise's per-sample (population) std
        is pulled toward the conditional prediction's."""
        eps_u, eps_c = eps.chunk(2)
        g = eps_u + guidance_scale * (eps_c - eps_u)
        if not guidance_rescale:
            return g
        dims = tuple(range(1, g.ndim))
        std_c = eps_c.std(dim=dims, keepdim=True, correction=0)
        std_g = g.std(dim=dims, keepdim=True, correction=0)
        rescaled = g * (std_c / (std_g + 1e-8))
        return guidance_rescale * rescaled + (1 - guidance_rescale) * g

    def _eps(self, x, t, ehs, guidance=None, **kv):
        """The UNet at (x, t) on the embeddings ``ehs``; with ``guidance``
        = (scale, rescale), at the doubled batch [x, x] against the
        [uncond, cond] halves of ``ehs``, combined by ``_cfg``."""
        if guidance is None:
            return self.unet(x, t, ehs, **kv)
        eps, stored = self.unet(torch.cat([x, x]), t, ehs, **kv)
        return self._cfg(eps, *guidance), stored

    @torch.inference_mode()
    def __call__(self, frames, prompt: str = "", negative_prompt: str = "",
                 inversion_prompt: str = "", strength: float = 0.7,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 guidance_rescale: float = 0.0, use_inversion: bool = False,
                 noise=None, generator=None, output_type: str = "np"):
        """Edit (N, 3, H, W) frames in [-1, 1]. SDEdit takes ``noise`` of
        the latents' shape or draws it from ``generator``; inversion takes
        neither. "np" gives NHWC numpy in [0, 1], anything else the decoded
        NCHW tensor. Frames are encoded and decoded ``DECODE_CHUNK`` at a
        time."""
        dev = self.device
        n = frames.shape[0]
        latents = decode_chunked(self.encode, frames.to(dev), DECODE_CHUNK)
        ts = self.get_timesteps(num_inference_steps, strength)
        steps = dict(num_inference_steps=num_inference_steps,
                     start_step=num_inference_steps - len(ts))

        if use_inversion:
            inv_c = self.prompt_embeds(1, inversion_prompt)
            init, inv_kv = self.ddim_inversion(latents[0:1], collect_kv=True,
                                               ehs=inv_c, **steps)
            if n > 1:
                rest, _ = self.ddim_inversion(
                    latents[1:], kv_traj=inv_kv,
                    ehs=inv_c.expand(n - 1, -1, -1), **steps)
                init = torch.cat([init, rest])
            del inv_kv
        else:
            if noise is None:
                if generator is None:
                    raise ValueError("SDEdit needs noise or a generator")
                noise = torch.randn(latents.shape, generator=generator)
            init = self.scheduler.add_noise(latents, noise.to(dev),
                                            [ts[0]] * n)

        # frame 0's edit trajectory (STORE), then every frame loading it
        guidance = (guidance_scale, guidance_rescale)
        _, kv_traj = self.denoise(
            init[0:1], collect_kv=True, guidance=guidance,
            ehs=torch.cat(self.encode_prompt(prompt, negative_prompt)),
            **steps)
        out, _ = self.denoise(
            init, kv_traj=kv_traj, guidance=guidance,
            ehs=torch.cat(self.encode_prompt(prompt, negative_prompt, n)),
            **steps)
        del kv_traj
        images = decode_chunked(self.decode, out, DECODE_CHUNK)
        if output_type == "np":
            img = images.permute(0, 2, 3, 1).float().cpu().numpy()
            return np.clip(img / 2 + 0.5, 0, 1)
        return images
