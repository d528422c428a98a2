"""Image and latent shifters in six filter modes, with validity masks,
and the up- and downsamplers of the shift tooling, NCHW. Counterpart of
the JAX package's ``shift/shifters.py``. Offsets are Python numbers; every
random draw comes from an explicit ``torch.Generator`` or is passed in.
"""

import math
from enum import Enum

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ideal_lpf import downsample_rfft, lpf_recon_rfft, upsample_rfft
from ..ops.upfirdn2d import upfirdn2d
from .equivariance import apply_fractional_translation
from .flow import color_background, flow_warp, translation_flow

FILTER_CHOICES = ["bilinear", "lanczos", "ideal", "ideal_crop", "fourier",
                  "fourier_crop"]


class BgType(Enum):
    NO_BG = 0
    RANDN = 1
    FULL_COLOR = 2
    ORIGINAL_IMG = 3


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


def gen_random_offset(max_offset_i, max_offset_j, int_offset, int_stride,
                      bs=1, min_offset_i=0, min_offset_j=0, generator=None,
                      draws=None):
    """Random offsets (ti, tj), each a float32 tensor of ``bs``: on the
    ``int_stride`` grid within ±(max - min) when ``int_offset``, else
    uniform in ±(max - min); then shifted by the minimum. ``draws`` = (di,
    dj) replaces the draws from ``generator``: integers in [-range, range]
    or uniforms in [0, 1)."""
    len_i = max_offset_i - min_offset_i
    len_j = max_offset_j - min_offset_j
    if int_offset:
        range_i = int(len_i // int_stride)
        range_j = int(len_j // int_stride)
        if draws is None:
            draws = (torch.randint(-range_i, range_i + 1, (bs,),
                                   generator=generator),
                     torch.randint(-range_j, range_j + 1, (bs,),
                                   generator=generator))
        oi = torch.as_tensor(draws[0]).float() * int_stride
        oj = torch.as_tensor(draws[1]).float() * int_stride
    else:
        if draws is None:
            draws = (torch.rand((bs,), generator=generator),
                     torch.rand((bs,), generator=generator))
        oi = (torch.as_tensor(draws[0]).float() * 2 - 1) * len_i
        oj = (torch.as_tensor(draws[1]).float() * 2 - 1) * len_j
    return oi + min_offset_i, oj + min_offset_j


def fourier_shift_batch(image, shift_i, shift_j):
    """Exact periodic fractional shift by an FFT phase ramp: H by
    ``shift_i``, W by ``shift_j``."""
    N, C, H, W = image.shape
    X = torch.fft.fft2(image.float(), dim=(2, 3))
    u = torch.fft.fftfreq(H, device=image.device)
    v = torch.fft.fftfreq(W, device=image.device)
    arg = (torch.tensor(shift_i, dtype=torch.float32) * u[:, None]
           + torch.tensor(shift_j, dtype=torch.float32) * v[None, :])
    phase = torch.exp(-2j * np.pi * arg)
    out = torch.fft.ifft2(X * phase, dim=(2, 3)).real
    return out.to(image.dtype)


def _background(bg_type, img, generator):
    if bg_type == BgType.RANDN:
        return torch.randn(img.shape, generator=generator, dtype=img.dtype,
                           device=img.device)
    if bg_type == BgType.FULL_COLOR:
        return color_background(img, generator)
    if bg_type == BgType.ORIGINAL_IMG:
        return img
    if bg_type == BgType.NO_BG:
        return None
    raise ValueError(f"No such background type {bg_type}")


class ImageShifter:
    """Six modes. ``bilinear``: backward bilinear warp, zero padding.
    ``lanczos``: separable Lanczos-3 taps. ``ideal``: ideal upsample
    (cacheable with ``precompute``), integer roll at the upsampled rate,
    decimate; periodic, so its mask is all ones. ``ideal_crop``: the same,
    the wrapped band cropped. ``fourier`` / ``fourier_crop``: an FFT phase
    ramp, periodic / cropped."""

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
        """The ideal modes' upsample cache (None for the other modes)."""
        if self.filter not in ("ideal", "ideal_crop"):
            return None
        return upsample_rfft(img, up=self.upsample_ratio)

    def shift(self, img, ti, tj, cache=None):
        """Returns (warped, mask); ti shifts H, tj shifts W."""
        n, _, h, w = img.shape
        if self.filter == "lanczos":
            warped, mask = apply_fractional_translation(img, tj / w, ti / h)
            return warped, mask[:, 0:1]
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
        if self.filter in ("fourier", "fourier_crop"):
            warped = fourier_shift_batch(img, ti, tj)
            if self.filter == "fourier":
                return warped, torch.ones_like(warped)
            mask = gen_valid_mask(warped.shape, ti, tj, img.device)
            return warped * mask, mask
        warped, mask = flow_warp(img, translation_flow(ti, tj, n, h, w,
                                                       img.device), True)
        return warped, mask[:, None].float()

    def translate_with_occ_bg(self, img, ti, tj, bg_type: BgType, mask=None,
                              return_mask=False, cache=None, generator=None,
                              background=None):
        """Shift and fill the disoccluded pixels with a background: gaussian
        noise (RANDN), one uniform colour in [-1, 1) an image and channel
        (FULL_COLOR), the image itself (ORIGINAL_IMG) or none (NO_BG).
        ``background`` replaces the draw from ``generator``."""
        if background is None:
            background = _background(bg_type, img, generator)
        warped, translate_mask = self.shift(img, ti, tj, cache=cache)
        if mask is None:
            mask = translate_mask
        if bg_type != BgType.NO_BG:
            warped = warped * mask + background * (1 - mask)
        if return_mask:
            return warped, mask
        return warped

    def image_latent_random_translate(self, img, latent, max_offset_i,
                                      max_offset_j, batch_size=1,
                                      int_offset=False, align_latent=False,
                                      generator=None, offset=None,
                                      backgrounds=None):
        """Shift an image (bilinear) and its latent (this shifter) by one
        random offset, tiled ``batch_size`` times; the image's disocclusion
        gets a uniform colour, the latent's another. ``offset`` = (ti, tj)
        in image pixels and ``backgrounds`` = (image's, latent's), each
        (n, C, 1, 1), replace the draws from ``generator``. Returns
        (warped image, warped latent, image mask, latent mask)."""
        n, _, h, w = img.shape
        n2, _, h2, w2 = latent.shape
        if n != n2 or h * w2 != w * h2 or h % h2:
            raise ValueError("the latent must match the image's batch and "
                             "divide its size")
        ratio = h // h2

        img = img.repeat(batch_size, 1, 1, 1)
        latent = latent.repeat(batch_size, 1, 1, 1)
        n *= batch_size

        if offset is None:
            oi, oj = gen_random_offset(max_offset_i, max_offset_j,
                                       int_offset,
                                       ratio if align_latent else 1,
                                       generator=generator)
            offset = (float(oi[0]), float(oj[0]))
        ti, tj = offset
        if backgrounds is None:
            backgrounds = (_background(BgType.FULL_COLOR, img, generator),
                           _background(BgType.FULL_COLOR, latent, generator))

        warped_img, bwd_mask = flow_warp(
            img, translation_flow(ti, tj, n, h, w, img.device), True)
        bwd_mask = bwd_mask[:, None].float()
        warped_img = warped_img * bwd_mask + backgrounds[0] * (1 - bwd_mask)

        latent_mask = bwd_mask[:, :, ::ratio, ::ratio]
        warped_latent = self.translate_with_occ_bg(
            latent, ti / ratio, tj / ratio, BgType.FULL_COLOR, latent_mask,
            background=backgrounds[1])
        return warped_img, warped_latent, bwd_mask, latent_mask


def get_blur_kernel(length=4):
    """The normalised 2-D binomial blur kernel of 4 or 5 taps a side (a
    float32 tensor on the CPU)."""
    if length == 4:
        k = (1, 3, 3, 1)
    elif length == 5:
        k = (1, 3, 6, 3, 1)
    else:
        raise ValueError(length)
    k = np.asarray(k, dtype=np.float32)
    k2 = np.outer(k, k)
    return torch.from_numpy(k2 / k2.sum())


def upsample_pad_zero(x, scale):
    """Zero-stuffing upsample: each pixel at the top left of its scale x
    scale cell, zeros elsewhere."""
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, h, scale, w, scale))
    out[:, :, :, 0, :, 0] = x
    return out.reshape(n, c, h * scale, w * scale)


def _resize(x, size, mode):
    """The JAX package's ``image.resize`` in ``nearest`` (half-pixel
    centres: ``nearest-exact``) and ``bilinear`` (anti-aliased when it
    shrinks) modes."""
    if mode == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    if mode == "bilinear":
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False, antialias=True)
    raise ValueError(f"resize mode {mode!r} not in ('nearest', 'bilinear')")


class ImageUpsampler:
    """nearest / bilinear / ideal / blur upsampling by ``scale``. The
    learned mode, which has a parameter, is ``LearnedUpsampler``."""

    def __init__(self, scale=2, mode="nearest"):
        self.scale = scale
        self.mode = mode
        if mode == "blur":
            self.blur_kernel = get_blur_kernel(4)

    def low_pass(self, x):
        if self.mode == "blur":
            return upfirdn2d(x, self.blur_kernel * 4, up=2,
                             padding=(2, 1, 2, 1))
        if self.mode == "ideal":
            return lpf_recon_rfft(x, cutoff=1 / self.scale)
        return _resize(x, (x.shape[2] * self.scale, x.shape[3] * self.scale),
                       self.mode)

    def upsample(self, x):
        if self.mode == "blur":
            return upfirdn2d(x, self.blur_kernel * self.scale ** 2,
                             up=self.scale, padding=(2, 1, 2, 1))
        if self.mode == "ideal":
            return upsample_rfft(x, up=self.scale)
        return _resize(x, (x.shape[2] * self.scale, x.shape[3] * self.scale),
                       self.mode)


class LearnedUpsampler(torch.nn.Module):
    """The learned upsampler: ConvTranspose(1, 1, 4, stride=scale, pad=1)
    as ``upfirdn2d(up=scale, padding=(2, 1, 2, 1))`` of one 4x4 parameter
    ``kernel``, started at the binomial blur kernel * scale²."""

    def __init__(self, scale=2):
        super().__init__()
        self.scale = scale
        self.kernel = torch.nn.Parameter(get_blur_kernel(4) * scale ** 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, up=self.scale, padding=(2, 1, 2, 1))

    upsample = forward


class ImageDownsampler:
    """nearest / bilinear / ideal / blur downsampling by ``scale``; ideal
    is the ideal low-pass at cutoff 1/scale, then decimation."""

    def __init__(self, scale=2, mode="nearest"):
        self.scale = scale
        self.mode = mode
        if mode == "blur":
            self.blur_kernel = get_blur_kernel(4)

    def downsample(self, x):
        if self.mode == "blur":
            return upfirdn2d(x, self.blur_kernel, down=self.scale,
                             padding=(2, 1, 2, 1))
        if self.mode == "ideal":
            return downsample_rfft(x, down=self.scale)
        return _resize(x, (x.shape[2] // self.scale,
                           x.shape[3] // self.scale), self.mode)
