"""Shift-equivariance evaluation, the FFHQ-256 protocol. Counterpart of
``afldm_tpu/pipelines/shift_eval.py``: denoise a latent with cross-frame
attention in STORE mode, denoise its fractionally shifted copies with
LOAD (together in ONE batched pass, or one at a time as the reference
does), decode, and score each against a bilinear pixel shift of the
reference decode under a validity mask.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..shift.metrics import mask_psnr
from ..shift.shifters import ImageShifter
from ._frames import decode_chunked


@dataclass
class ShiftEvalResult:
    """NHWC numpy arrays, as the JAX package returns them."""
    psnrs: np.ndarray          # (num_shift_steps,) masked PSNR per shift
    outputs: np.ndarray        # (num_shift_steps, H, W, 3) decoded shifted
    targets: np.ndarray        # (num_shift_steps, H, W, 3) GT-shifted recon
    masks: np.ndarray          # (num_shift_steps, H, W, 1)

    @property
    def mean_psnr(self):
        return float(self.psnrs.mean())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


@torch.inference_mode()
def shift_equivariance_eval(pipeline, generator=None,
                            num_inference_steps: int = 50,
                            num_shift_steps: int = 16, init_latent=None,
                            input_image=None, batch_shifts: bool = True,
                            decode_chunk: int | None = None
                            ) -> ShiftEvalResult:
    """``init_latent`` is (1, C, h, w); without it the latent comes from
    ``input_image`` (encode + DDIM inversion) or from ``generator``.
    ``batch_shifts=False`` denoises and decodes each shift on its own;
    ``decode_chunk`` decodes the batched shifts that many at a time."""
    cfg = pipeline.unet.config
    ratio = pipeline.vae.config.downsample_ratio
    device = pipeline.device

    if init_latent is None:
        if input_image is not None:
            z = pipeline.encode(input_image, generator=generator)
            init_latent, _ = pipeline.ddim_inversion(z, num_inference_steps)
        else:
            if generator is None:
                raise ValueError("pass init_latent, input_image or a "
                                 "generator")
            init_latent = torch.randn(
                (1, cfg.in_channels, cfg.sample_size, cfg.sample_size),
                generator=generator, device=device)
    if init_latent.shape[0] != 1:
        raise ValueError(
            f"shift_equivariance_eval scores ONE image per call (got batch "
            f"{init_latent.shape[0]}); loop over images instead")
    init_latent = init_latent.to(device)

    # STORE pass + reference reconstruction
    denoised, kv_traj = pipeline.denoise(init_latent, num_inference_steps,
                                         collect_kv=True)
    # images in float32 from here on (a bf16 VAE decodes to bf16): the
    # ground-truth shift and the masked PSNR run in float32
    rec_img = pipeline.decode(denoised).float()

    # all fractional shifts tj = k/ratio, k = 1..num_shift_steps
    latent_shifter = ImageShifter("ideal_crop", upsample_ratio=ratio)
    cache = latent_shifter.precompute(init_latent)
    pairs = [latent_shifter.shift(init_latent, 0.0, k / ratio, cache=cache)
             for k in range(1, num_shift_steps + 1)]
    shifted = torch.cat([s for s, _ in pairs])
    lat_masks = torch.cat([m for _, m in pairs])

    if batch_shifts:
        den_shifted, _ = pipeline.denoise(shifted, num_inference_steps,
                                          kv_traj=kv_traj)
        outputs = decode_chunked(pipeline.decode, den_shifted * lat_masks,
                                 decode_chunk).float()
    else:  # one LOAD pass and one decode a shift, as the reference runs
        outs = []
        for i in range(num_shift_steps):
            d, _ = pipeline.denoise(shifted[i:i + 1], num_inference_steps,
                                    kv_traj=kv_traj)
            outs.append(pipeline.decode(d * lat_masks[i:i + 1]))
        outputs = torch.cat(outs).float()

    # ground truth: pixel-space bilinear shift of the reference decode
    image_shifter = ImageShifter()
    targets, img_masks, psnrs = [], [], []
    for k in range(1, num_shift_steps + 1):
        gt, m = image_shifter.shift(rec_img, 0.0, float(k))
        targets.append(gt)
        img_masks.append(m)
        psnrs.append(mask_psnr(outputs[k - 1:k], gt, m))

    return ShiftEvalResult(
        psnrs=torch.stack(psnrs).float().cpu().numpy(),
        outputs=_nhwc(outputs),
        targets=_nhwc(torch.cat(targets)),
        masks=_nhwc(torch.cat(img_masks)),
    )
