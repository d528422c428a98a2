"""Optical-flow utilities, NCHW. Flow is (N, 2, H, W) with channel 0 the
row offset di and channel 1 the column offset dj. Counterpart of the JAX
package's ``shift/flow.py``: the backward warp is the same four-tap gather
with zero padding and align_corners semantics (not ``grid_sample``, whose
corner conventions differ); the forward splats are ``scatter_add_`` sums,
whose order moves only rounding; the noise draws and backgrounds are
passed in or taken from an explicit ``torch.Generator``. The ``flow_fn``
wrappers take any ``flow_fn(img0, img1) -> (fwd, fwd_occ, bwd, bwd_occ)``,
such as ``shift.simple_flow.predict_flow``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ideal_lpf import upsample_rfft
from .equivariance import apply_fractional_translation


def coords_grid(b, h, w, device=None):
    """(B, 2, H, W) grid of (i, j) pixel coordinates."""
    i = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    grid = torch.stack([i.expand(h, w), j.expand(h, w)], dim=0)
    return grid[None].expand(b, 2, h, w)


def bilinear_sample(img, coords, return_mask=False):
    """Sample ``img`` (N, C, H, W) at ``coords`` (N, 2, H', W') in (i, j)
    pixel units. Corner taps outside the image contribute zero; the
    optional mask (N, H', W') is True where the sample point lies inside.
    Coordinates and the weighted sum are float32."""
    N, C, H, W = img.shape
    ci = coords[:, 0].float()
    cj = coords[:, 1].float()
    i0 = torch.floor(ci)
    j0 = torch.floor(cj)
    wi = ci - i0
    wj = cj - j0
    flat = img.reshape(N, C, H * W)

    def tap(ii, jj, w):
        valid = (ii >= 0) & (ii <= H - 1) & (jj >= 0) & (jj <= W - 1)
        idx = (ii.clamp(0, H - 1).long() * W + jj.clamp(0, W - 1).long())
        idx = idx.reshape(N, 1, -1).expand(N, C, -1)
        vals = torch.gather(flat, 2, idx).reshape(N, C, *ii.shape[1:])
        return vals.float() * (w * valid)[:, None]

    out = (tap(i0, j0, (1 - wi) * (1 - wj))
           + tap(i0 + 1, j0, wi * (1 - wj))
           + tap(i0, j0 + 1, (1 - wi) * wj)
           + tap(i0 + 1, j0 + 1, wi * wj)).to(img.dtype)
    if return_mask:
        mask = (ci >= 0) & (ci <= H - 1) & (cj >= 0) & (cj <= W - 1)
        return out, mask
    return out


def flow_warp(feature, flow, mask=False):
    """out[i, j] = feature[i + di, j + dj], bilinear."""
    b, _, h, w = feature.shape
    grid = coords_grid(b, h, w, feature.device) + flow.float()
    return bilinear_sample(feature, grid, return_mask=mask)


def translation_flow(ti, tj, n, h, w, device=None):
    """The constant backward flow (n, 2, h, w) of a (ti, tj) translation."""
    flow = torch.tensor([-ti, -tj], dtype=torch.float32, device=device)
    return flow.reshape(1, 2, 1, 1).expand(n, 2, h, w)


def color_background(img, generator=None):
    """One uniform colour in [-1, 1) an image and channel, (n, C, 1, 1)."""
    n, c = img.shape[:2]
    return torch.rand((n, c, 1, 1), generator=generator, dtype=img.dtype,
                      device=img.device) * 2 - 1


def _nearest_index(flow, H, W):
    """(N, H*W) flat index of round(i + di), round(j + dj) (half to even),
    clamped to the image."""
    i = torch.arange(H, device=flow.device)[:, None]
    j = torch.arange(W, device=flow.device)[None, :]
    ti = torch.round(i + flow[:, 0]).clamp(0, H - 1).long()
    tj = torch.round(j + flow[:, 1]).clamp(0, W - 1).long()
    return (ti * W + tj).reshape(flow.shape[0], H * W)


def flow_warp_nearest(img, bwd_flow):
    """Nearest backward warp with clamped indices: out[i, j] =
    img[round(i + di), round(j + dj)]."""
    N, C, H, W = img.shape
    idx = _nearest_index(bwd_flow, H, W)[:, None].expand(N, C, H * W)
    return torch.gather(img.reshape(N, C, H * W), 2, idx).reshape(N, C, H, W)


def flow_warp_splat_nearest(img, fwd_flow, fwd_occ=None):
    """Nearest forward splat: out[round(i + di), round(j + dj)] +=
    img[i, j] (clamped); sources where ``fwd_occ`` is 1 are dropped."""
    if fwd_occ is not None:
        img = img * (1 - fwd_occ)
    N, C, H, W = img.shape
    idx = _nearest_index(fwd_flow, H, W)[:, None].expand(N, C, H * W)
    out = torch.zeros((N, C, H * W), dtype=img.dtype, device=img.device)
    out.scatter_add_(2, idx, img.reshape(N, C, H * W))
    return out.reshape(N, C, H, W)


def get_intermediate_warp_mask(fwd_flow, fwd_occ, alpha):
    """Invert the forward flow scaled by ``alpha`` into a backward flow by
    a nearest splat; a target pixel hit by other than exactly one
    non-occluded source is occluded (``bwd_occ`` 1). Returns (bwd_flow
    (N, 2, H, W), bwd_occ (N, 1, H, W)).

    Where the count is 1 the one write is unique, so the result does not
    depend on the order of the scatter. Where it is not, the JAX package
    keeps whichever write landed last (its value is masked downstream);
    here the backward flow is set to 0 there, so the output is the same on
    every device and finite where it is multiplied by zero."""
    fwd = fwd_flow * alpha
    N, _, H, W = fwd.shape
    idx = _nearest_index(fwd, H, W)
    keep = fwd_occ[:, 0].reshape(N, H * W) == 0

    cnt = torch.zeros((N, H * W), dtype=torch.int32, device=fwd.device)
    cnt.scatter_add_(1, idx, keep.int())
    unique = cnt == 1
    # occluded sources write to a dummy column H*W, dropped afterwards
    idx_set = torch.where(keep, idx, H * W)[:, None].expand(N, 2, H * W)
    bwd = torch.zeros((N, 2, H * W + 1), dtype=fwd.dtype, device=fwd.device)
    bwd.scatter_(2, idx_set, -fwd.reshape(N, 2, H * W))
    bwd = torch.where(unique[:, None], bwd[..., :H * W], 0.0)
    bwd_occ = (~unique).to(fwd_occ.dtype).reshape(N, 1, H, W)
    return bwd.reshape(N, 2, H, W), bwd_occ


def forward_flow_warp(img, fwd_flow):
    """Bilinear forward splat with unnormalised corner weights; returns
    (splat, bwd_occ), a target occluded (1) where the weights landing on
    it sum to <= 0. The corners start from the coordinate truncated toward
    zero, as the reference's ``int()`` does."""
    N, C, H, W = img.shape
    i = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    j = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    ci = i + fwd_flow[:, 0].float()
    cj = j + fwd_flow[:, 1].float()
    i1 = ci.int()
    j1 = cj.int()

    src = img.reshape(N, C, H * W).float()
    res = torch.zeros((N, C, H * W), dtype=torch.float32, device=img.device)
    cnt = torch.zeros((N, H * W), dtype=torch.float32, device=img.device)
    for gi, gj in ((i1, j1), (i1 + 1, j1), (i1, j1 + 1), (i1 + 1, j1 + 1)):
        coef = (1 - (ci - gi).abs()) * (1 - (cj - gj).abs())
        valid = (gi >= 0) & (gi < H) & (gj >= 0) & (gj < W)
        coef = (coef * valid).reshape(N, H * W)
        idx = torch.where(valid, gi * W + gj, 0).reshape(N, H * W).long()
        res.scatter_add_(2, idx[:, None].expand(N, C, H * W),
                         src * coef[:, None])
        cnt.scatter_add_(1, idx, coef)
    bwd_occ = (cnt <= 0).to(img.dtype).reshape(N, 1, H, W)
    return res.reshape(N, C, H, W).to(img.dtype), bwd_occ


def forward_backward_consistency_check(fwd_flow, bwd_flow, alpha=0.01,
                                       beta=0.5):
    """UnFlow-style occlusion masks (N, 1, H, W): a pixel is occluded when
    the flow and the other flow warped onto it do not cancel to within
    ``alpha * (|fwd| + |bwd|) + beta``."""
    flow_mag = (torch.linalg.vector_norm(fwd_flow, dim=1)
                + torch.linalg.vector_norm(bwd_flow, dim=1))
    warped_bwd = flow_warp(bwd_flow, fwd_flow)
    warped_fwd = flow_warp(fwd_flow, bwd_flow)
    diff_fwd = torch.linalg.vector_norm(fwd_flow + warped_bwd, dim=1)
    diff_bwd = torch.linalg.vector_norm(bwd_flow + warped_fwd, dim=1)
    threshold = alpha * flow_mag + beta
    fwd_occ = (diff_fwd > threshold).to(fwd_flow.dtype)[:, None]
    bwd_occ = (diff_bwd > threshold).to(bwd_flow.dtype)[:, None]
    return fwd_occ, bwd_occ


def upsample_noise(noise, ratio, z=None, generator=None):
    """Variance-preserving noise upsample: hi-res gaussian ``z`` (drawn
    from ``generator`` unless given) minus its per-patch mean, plus the
    nearest-upsampled noise / ratio, so each ratio x ratio patch averages
    back to the original pixel / ratio."""
    n, c, h, w = noise.shape
    if z is None:
        z = torch.randn((n, c, h * ratio, w * ratio), generator=generator,
                        device=noise.device, dtype=noise.dtype)
    zp = z.reshape(n, c, h, ratio, w, ratio)
    z_centered = (zp - zp.mean(dim=(3, 5), keepdim=True)).reshape(z.shape)
    x = noise.repeat_interleave(ratio, 2).repeat_interleave(ratio, 3)
    return x / ratio + z_centered


def collect_noise_pixel(noise, bwd_occ, sidelength, fresh=None,
                        generator=None):
    """Re-aggregate hi-res noise into low-res (patch sums / sidelength),
    occluded pixels refreshed with gaussian ``fresh`` (drawn from
    ``generator`` unless given)."""
    sl = sidelength
    n, c, h, w = noise.shape
    if fresh is None:
        fresh = torch.randn(noise.shape, generator=generator,
                            device=noise.device, dtype=noise.dtype)
    res = fresh * bwd_occ + noise * (1 - bwd_occ)
    return res.reshape(n, c, h // sl, sl, w // sl, sl).sum(dim=(3, 5)) / sl


def continuous_noise_warp(high_res_noise, fwd_flow, fwd_occ, alpha,
                          noise_ratio=8, fresh=None, generator=None):
    """Warp hi-res noise along ``alpha`` times the forward flow, keeping
    its distribution: invert the flow by a nearest splat, warp backward,
    and collect the patches, occluded pixels refreshed."""
    bwd_flow, bwd_occ = get_intermediate_warp_mask(fwd_flow, fwd_occ, alpha)
    warped = flow_warp(high_res_noise, bwd_flow)
    return collect_noise_pixel(warped, bwd_occ, noise_ratio, fresh,
                               generator)


def continuous_noise_warp_bwd(high_res_noise, bwd_flow, bwd_occ,
                              noise_ratio=8, flow_ratio=1, fresh=None,
                              generator=None):
    """Warp hi-res noise backward along ``bwd_flow`` (upsampled nearest by
    ``flow_ratio``) and collect the patches."""
    if flow_ratio != 1:
        bwd_flow = bwd_flow.repeat_interleave(flow_ratio, 2) \
            .repeat_interleave(flow_ratio, 3)
        bwd_occ = bwd_occ.repeat_interleave(flow_ratio, 2) \
            .repeat_interleave(flow_ratio, 3)
    warped = flow_warp(high_res_noise, bwd_flow)
    return collect_noise_pixel(warped, bwd_occ, noise_ratio, fresh,
                               generator)


def continuous_noise_fwd_warp(high_res_noise, fwd_flow, alpha,
                              noise_ratio=8, fresh=None, generator=None):
    """Splat hi-res noise forward along ``alpha`` times the flow and
    collect the patches."""
    warped, bwd_occ = forward_flow_warp(high_res_noise, fwd_flow * alpha)
    return collect_noise_pixel(warped, bwd_occ, noise_ratio, fresh,
                               generator)


def forward_upsample_flow_warp(img, fwd_flow, scale=8):
    """Ideal-upsample by ``scale``, forward-splat along ``fwd_flow`` (at the
    upsampled size), decimate; returns (image, bwd_occ)."""
    up = upsample_rfft(img, up=scale)
    warped, occ = forward_flow_warp(up, fwd_flow)
    return warped[:, :, ::scale, ::scale], occ[:, :, ::scale, ::scale]


class InputPadder:
    """Pads images (edge replication) so that H and W are multiples of
    ``padding_factor``; ``dims`` is an NCHW shape."""

    def __init__(self, dims, mode="sintel", padding_factor=8):
        self.ht, self.wd = dims[2], dims[3]
        pad_ht = (((self.ht // padding_factor) + 1) * padding_factor
                  - self.ht) % padding_factor
        pad_wd = (((self.wd // padding_factor) + 1) * padding_factor
                  - self.wd) % padding_factor
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        return [F.pad(x, self._pad, mode="replicate") for x in inputs]

    def unpad(self, x):
        p = self._pad
        ht, wd = x.shape[2], x.shape[3]
        return x[:, :, p[2]: ht - p[3], p[0]: wd - p[1]]


def flow_reverse_map(feature, flow):
    """Nearest gather along the flow (the reference's misspelt
    ``flow_revserse_map``)."""
    return flow_warp_nearest(feature, flow)


def flow_warp_with_occ_bg(img, flow, mask, is_randn, filter=None,
                          offsets=None, generator=None, background=None):
    """Backward-warp ``img`` along ``flow`` and fill where ``mask`` is 0
    with gaussian noise (``is_randn``) or one uniform colour in [-1, 1) an
    image and channel; ``background`` replaces the draw from
    ``generator``. ``filter='lanczos'`` treats the flow as one constant
    translation, ``offsets`` = (di, dj) pixels (default: the flow at pixel
    (0, 0)), resampled with Lanczos-3 taps."""
    if background is None:
        background = (torch.randn(img.shape, generator=generator,
                                  dtype=img.dtype, device=img.device)
                      if is_randn else color_background(img, generator))
    if filter == "lanczos":
        h, w = img.shape[2], img.shape[3]
        if offsets is None:
            offsets = (float(flow[0, 0, 0, 0]), float(flow[0, 1, 0, 0]))
        warped, _ = apply_fractional_translation(
            img, -float(offsets[1]) / w, -float(offsets[0]) / h)
    else:
        warped = flow_warp(img, flow)
    return warped * mask + background * (1 - mask)


def get_patch_moving_flow(img_template, region_box, displacement, alpha=1):
    """A synthetic backward flow that moves one rectangle ``region_box`` =
    (top, bottom, left, right) by ``alpha * displacement`` = (di, dj);
    returns (bwd_flow (n, 2, h, w), bwd_occ (n, 1, h, w)), occluded where
    the patch left."""
    n, _, h, w = img_template.shape
    u, d, l, r = region_box
    di, dj = displacement
    bwd_flow = np.zeros((n, 2, h, w), np.float32)
    bwd_occ = np.zeros((n, 1, h, w), np.float32)
    bwd_occ[:, :, u:d, l:r] = 1.0
    u2 = int(np.round(u + di * alpha))
    d2 = int(np.round(d + di * alpha))
    l2 = int(np.round(l + dj * alpha))
    r2 = int(np.round(r + dj * alpha))
    bwd_flow[:, 0, u2:d2, l2:r2] = -di * alpha
    bwd_flow[:, 1, u2:d2, l2:r2] = -dj * alpha
    bwd_occ[:, :, u2:d2, l2:r2] = 0.0
    dev = img_template.device
    return (torch.from_numpy(bwd_flow).to(dev),
            torch.from_numpy(bwd_occ).to(dev))


def noise_image_random_translate(img, noise, max_offset_i, max_offset_j,
                                 noise_upsample=True, batch_size=1,
                                 int_offset=False, generator=None,
                                 offset=None, background=None, z=None,
                                 fresh=None):
    """Translate an image (bilinear, a uniform colour where it
    disoccludes) and its lower-resolution noise by one random offset,
    tiled ``batch_size`` times, keeping the noise gaussian: through the
    hi-res noise of ``upsample_noise`` (``noise_upsample``), else by a
    backward warp with fresh noise in the disocclusion. ``offset`` = (ti,
    tj) in image pixels, the image's ``background`` (n, C, 1, 1), the
    hi-res ``z`` and the ``fresh`` noise replace the draws from
    ``generator``. Returns (warped image, warped noise)."""
    n, _, h, w = img.shape
    n2, _, h2, w2 = noise.shape
    if n != n2 or h * w2 != w * h2:
        raise ValueError("the noise must match the image's batch and "
                         "aspect")
    ratio = h // h2
    img = img.repeat(batch_size, 1, 1, 1)
    noise = noise.repeat(batch_size, 1, 1, 1)
    n = n * batch_size

    if offset is None:
        from .shifters import gen_random_offset
        oi, oj = gen_random_offset(max_offset_i, max_offset_j, int_offset, 1,
                                   generator=generator)
        offset = (float(oi[0]), float(oj[0]))
    bwd_flow = translation_flow(*offset, n, h, w, img.device)
    warped_img, bwd_mask = flow_warp(img, bwd_flow, True)
    bwd_mask = bwd_mask[:, None].float()
    if background is None:
        background = color_background(img, generator)
    warped_img = warped_img * bwd_mask + background * (1 - bwd_mask)

    if noise_upsample:
        hi = upsample_noise(noise, ratio, z=z, generator=generator)
        warped_noise = continuous_noise_warp_bwd(
            hi, bwd_flow, 1 - bwd_mask, noise_ratio=ratio, fresh=fresh,
            generator=generator)
    else:
        noise_flow = bwd_flow[:, :, ::ratio, ::ratio] / ratio
        noise_mask = bwd_mask[:, :, ::ratio, ::ratio]
        warped_noise = flow_warp_with_occ_bg(noise, noise_flow, noise_mask,
                                             True, generator=generator,
                                             background=fresh)
    return warped_img, warped_noise


# -- the flow_fn wrappers -----------------------------------------------------
# ``flow_fn(img0, img1) -> (fwd, fwd_occ, bwd, bwd_occ)``, flows NCHW (di, dj)


def predict_flow(flow_fn, image1, image2, padding_factor=8):
    """Pad to a multiple of ``padding_factor``, run ``flow_fn`` both ways,
    unpad, and recompute the occlusions on the unpadded flows. For the LK
    estimator on an image pair use ``shift.simple_flow.predict_flow``."""
    if not callable(flow_fn):
        raise TypeError(
            "predict_flow(flow_fn, image1, image2) takes a bidirectional "
            "flow callable first; for LK flow of an image pair use "
            "shift.simple_flow.predict_flow(img0, img1)")
    padder = InputPadder(image1.shape, padding_factor=padding_factor)
    im1, im2 = padder.pad(image1, image2)
    fwd, _, bwd, _ = flow_fn(im1, im2)
    fwd, bwd = padder.unpad(fwd), padder.unpad(bwd)
    fwd_occ, bwd_occ = forward_backward_consistency_check(fwd, bwd)
    return fwd, fwd_occ, bwd, bwd_occ


def get_warped_and_mask(flow_fn, image1, image2, image3=None,
                        pixel_consistency=False):
    """Backward-warp ``image3`` (default ``image1``) along the 2->1 flow;
    returns (warped, bwd_occ, bwd_flow), the occlusion at beta 1 and, with
    ``pixel_consistency``, also where the warped image1 departs from image2
    by more than a quarter of the [-1, 1] range on the channel mean."""
    if image3 is None:
        image3 = image1
    padder = InputPadder(image1.shape, padding_factor=16)
    im1, im2 = padder.pad(image1, image2)
    fwd, _, bwd, _ = flow_fn(im1, im2)
    fwd, bwd = padder.unpad(fwd), padder.unpad(bwd)
    fwd_occ, bwd_occ = forward_backward_consistency_check(fwd, bwd, beta=1)
    if pixel_consistency:
        warped_image1 = flow_warp(image1, bwd)
        drift = ((image2 - warped_image1).abs().mean(dim=1, keepdim=True)
                 > 0.25 * 2.0).to(bwd_occ.dtype)
        bwd_occ = (bwd_occ + drift).clamp(0, 1)
    return flow_warp(image3, bwd), bwd_occ, bwd


def alpha_warp(flow_fn, image1, image2, alpha):
    """Forward-splat ``image1`` a fraction ``alpha`` of the way toward
    ``image2``; returns (warped, fwd, fwd_occ, bwd, bwd_occ)."""
    fwd, fwd_occ, bwd, bwd_occ = predict_flow(flow_fn, image1, image2)
    warped = flow_warp_splat_nearest(image1, fwd * alpha, fwd_occ)
    return warped, fwd, fwd_occ, bwd, bwd_occ
