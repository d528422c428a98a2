"""Image interpolation by flow-warped noise and cross-frame-attention
blending, NCHW. Counterpart of ``afldm_tpu/pipelines/interpolation.py``:

1. optical flow between the two stills, given or from ``flow_fn``
   (``(img0, img1) -> (fwd_flow, fwd_occ, bwd_flow, bwd_occ)``, e.g.
   ``shift.simple_flow.predict_flow``);
2. DDIM inversion of both endpoint latents;
3. endpoint 0's inverted noise upsampled 8x (ideal or variance-preserving),
   warped along the alpha-scaled flow for each frame, disocclusions filled
   with a fixed random background, decimated; optionally slerped toward
   endpoint 1's inversion;
4. a STORE denoise of each endpoint, then one interp denoise of all frames
   together, each frame's self-attention blending the two stored
   trajectories with its own alpha.

The gaussian draws (``bg``, one ``fresh`` per frame, ``z`` for
``noise_mode="noise"``) are passed in or drawn on the CPU from an explicit
``torch.Generator``, so a seed gives the same frames on every device.
"""

import numpy as np
import torch

from ..ops.ideal_lpf import upsample_rfft
from ..shift.flow import (collect_noise_pixel, flow_warp,
                          get_intermediate_warp_mask, upsample_noise)
from ._frames import decode_chunked
from .ldm import LDMPipeline


def slerp(a, b, t):
    """Spherical interpolation between two batches of noise, one ``t`` per
    row."""
    af, bf = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    dot = (af * bf).sum(-1) / (torch.linalg.vector_norm(af, dim=-1)
                               * torch.linalg.vector_norm(bf, dim=-1))
    omega = torch.arccos(torch.clamp(dot, -1 + 1e-7, 1 - 1e-7))
    so = torch.sin(omega)
    c1 = (torch.sin((1 - t) * omega) / so).reshape(-1, 1, 1, 1)
    c2 = (torch.sin(t * omega) / so).reshape(-1, 1, 1, 1)
    return c1 * a + c2 * b


def interp_draws(generator, latent_shape, num_frames, noise_ratio=8,
                 noise_mode="ideal"):
    """The gaussian draws of ``warp_noise``, on the CPU from ``generator``:
    ``bg`` of the latent's shape, ``fresh`` (num_frames, C, h·r, w·r) and,
    for ``noise_mode="noise"``, ``z`` (1, C, h·r, w·r)."""
    n, c, h, w = latent_shape
    hi = (n, c, h * noise_ratio, w * noise_ratio)
    draws = {"bg": torch.randn(latent_shape, generator=generator),
             "fresh": torch.randn((num_frames,) + hi[1:],
                                  generator=generator)}
    if noise_mode != "ideal":
        draws["z"] = torch.randn(hi, generator=generator)
    return draws


class ImageInterpolationPipeline(LDMPipeline):
    """(vae, SD-family ``UNet2DConditionModel``, scheduler). The UNet is
    conditioned on zero text embeddings of shape (1, 77, cross-attention
    dim), broadcast over the frames: the port has no text encoder."""

    def __init__(self, vae, unet, scheduler, flow_fn=None,
                 scaling_factor=None):
        super().__init__(vae, unet, scheduler, scaling_factor)
        self.flow_fn = flow_fn

    def _eps(self, x, t, **kv):
        return self.unet(x, t, self.prompt_embeds(), **kv)

    @torch.inference_mode()
    def warp_noise(self, inv0, fwd_flow, fwd_occ, alphas, draws,
                   noise_mode: str = "ideal", noise_ratio: int = 8):
        """One warped noise per alpha from endpoint 0's inverted latent
        (1, C, h, w); the flows are at h·r × w·r. Returns (frames, C, h,
        w)."""
        dev = inv0.device
        if noise_mode == "ideal":
            hi = upsample_rfft(inv0, up=noise_ratio)
        else:
            hi = upsample_noise(inv0, noise_ratio, z=draws["z"].to(dev))
        bg = draws["bg"].to(dev)
        noises = []
        for i, a in enumerate(alphas):
            bwd_flow, bwd_occ = get_intermediate_warp_mask(fwd_flow, fwd_occ,
                                                           float(a))
            low = collect_noise_pixel(flow_warp(hi, bwd_flow), bwd_occ,
                                      noise_ratio,
                                      fresh=draws["fresh"][i:i + 1].to(dev))
            occ_low = bwd_occ[:, :, ::noise_ratio, ::noise_ratio]
            noises.append(low * (1 - occ_low) + bg * occ_low)
        return torch.cat(noises)

    @torch.inference_mode()
    def __call__(self, img0, img1, num_frames: int = 17,
                 num_inference_steps: int = 50, generator=None, draws=None,
                 flows=None, use_slerp: bool = True,
                 noise_mode: str = "ideal", output_type: str = "np",
                 decode_chunk: int | None = None):
        """Interpolate ``num_frames`` frames (alphas evenly from 0 to 1)
        between two (1, 3, H, W) images in [-1, 1]. "np" gives NHWC numpy
        in [0, 1], anything else the decoded NCHW tensor."""
        if flows is None:
            if self.flow_fn is None:
                # zero flow would turn the noise warp into a silent no-op
                raise ValueError(
                    "ImageInterpolationPipeline needs optical flow: pass "
                    "flows=(fwd, fwd_occ, bwd, bwd_occ) or construct the "
                    "pipeline with a flow_fn (e.g. shift.simple_flow."
                    "predict_flow). To interpolate without warping, pass "
                    "zero flows explicitly.")
            flows = self.flow_fn(img0, img1)
        dev = self.device
        img0, img1 = img0.to(dev), img1.to(dev)
        fwd_flow, fwd_occ = (f.to(dev) for f in flows[:2])
        alphas = np.linspace(0.0, 1.0, num_frames)
        a = torch.tensor(alphas, dtype=torch.float32, device=dev)

        inv0, _ = self.ddim_inversion(self.encode(img0), num_inference_steps)
        inv1, _ = self.ddim_inversion(self.encode(img1), num_inference_steps)
        if draws is None:
            if generator is None:
                raise ValueError("pass draws or a generator")
            draws = interp_draws(generator, inv0.shape, num_frames,
                                 noise_mode=noise_mode)
        noises = self.warp_noise(inv0, fwd_flow, fwd_occ, alphas, draws,
                                 noise_mode=noise_mode)
        if use_slerp:
            noises = slerp(noises, inv1.expand_as(noises), a)

        _, kv0 = self.denoise(inv0, num_inference_steps, collect_kv=True)
        _, kv1 = self.denoise(inv1, num_inference_steps, collect_kv=True)
        out, _ = self.denoise(noises, num_inference_steps, kv_traj=kv0,
                              kv_traj2=kv1, alpha=a[:, None, None])
        del kv0, kv1
        images = decode_chunked(self.decode, out, decode_chunk)
        if output_type == "np":
            img = images.permute(0, 2, 3, 1).float().cpu().numpy()
            return np.clip(img / 2 + 0.5, 0, 1)
        return images
