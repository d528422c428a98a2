"""Image/latent shifter in its ``ideal``, ``ideal_crop`` and ``bilinear``
modes, with validity masks, NCHW. Counterpart of
``afldm_tpu/shift/shifters.py`` (``gen_valid_mask`` and ``ImageShifter``).
Offsets are Python numbers.
"""

import math

import torch

from ..ops.ideal_lpf import upsample_rfft
from .flow import flow_warp

FILTER_CHOICES = ["bilinear", "ideal", "ideal_crop"]


def gen_valid_mask(shape, ti, tj, device=None):
    """1 where a (ti, tj)-shift keeps valid content, 0 in the band that
    wrapped in. ``shape`` is (N, C, H, W)."""
    _, _, h, w = shape
    i1, i2 = (0.0, math.ceil(ti)) if ti >= 0 else (h + math.floor(ti), h)
    j1, j2 = (0.0, math.ceil(tj)) if tj >= 0 else (w + math.floor(tj), w)
    ridx = torch.arange(h, dtype=torch.float32, device=device)
    cidx = torch.arange(w, dtype=torch.float32, device=device)
    row_ok = ~((ridx >= i1) & (ridx < i2))
    col_ok = ~((cidx >= j1) & (cidx < j2))
    mask = (row_ok[:, None] & col_ok[None, :]).float()
    return mask[None, None].expand(shape)


class ImageShifter:
    """``ideal``: ideal upsample (cacheable with ``precompute``), integer
    roll at the upsampled rate, decimate; periodic, so its mask is all ones
    (the training shift loss's shifter). ``ideal_crop``: the same, with the
    wrapped band cropped. ``bilinear``: backward bilinear warp with zero
    padding."""

    def __init__(self, filter: str | None = None,
                 upsample_ratio: int | None = None):
        filter = filter or "bilinear"
        if filter not in FILTER_CHOICES:
            raise ValueError(f"filter {filter!r} not in {FILTER_CHOICES}")
        self.filter = filter
        if filter in ("ideal", "ideal_crop"):
            if upsample_ratio is None:
                raise ValueError(f"{filter} needs upsample_ratio")
            self.upsample_ratio = upsample_ratio

    def precompute(self, img):
        """The ideal-mode upsample cache (None for bilinear)."""
        if self.filter == "bilinear":
            return None
        return upsample_rfft(img, up=self.upsample_ratio)

    def shift(self, img, ti, tj, cache=None):
        """Returns (warped, mask); ti shifts H, tj shifts W."""
        n, _, h, w = img.shape
        if self.filter in ("ideal", "ideal_crop"):
            up = self.upsample_ratio
            if cache is None:
                cache = self.precompute(img)
            si, sj = round(ti * up), round(tj * up)
            warped = torch.roll(cache, shifts=(si, sj), dims=(2, 3))
            if self.filter == "ideal":
                warped = warped[:, :, ::up, ::up]
                return warped, torch.ones_like(warped)
            warped = warped * gen_valid_mask(warped.shape, si, sj,
                                             img.device)
            warped = warped[:, :, ::up, ::up]
            return warped, gen_valid_mask(warped.shape, ti, tj, img.device)
        flow = torch.tensor([-ti, -tj], dtype=torch.float32,
                            device=img.device).reshape(1, 2, 1, 1)
        warped, mask = flow_warp(img, flow.expand(n, 2, h, w), True)
        return warped, mask[:, None].float()
