"""Optical-flow utilities, NCHW. Flow is (N, 2, H, W) with channel 0 the
row offset di and channel 1 the column offset dj. Counterpart of
``coords_grid``, ``bilinear_sample``, ``flow_warp``,
``get_intermediate_warp_mask``, ``forward_backward_consistency_check``,
``upsample_noise`` and ``collect_noise_pixel`` in
``afldm_tpu/shift/flow.py``: the backward warp is the same four-tap gather
with zero padding and align_corners semantics (not ``grid_sample``, whose
corner conventions differ); the noise draws are passed in or taken from an
explicit ``torch.Generator``.
"""

import torch


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
    i = torch.arange(H, device=fwd.device)[:, None]
    j = torch.arange(W, device=fwd.device)[None, :]
    ti = torch.round(i + fwd[:, 0]).clamp(0, H - 1).long()
    tj = torch.round(j + fwd[:, 1]).clamp(0, W - 1).long()
    idx = (ti * W + tj).reshape(N, H * W)
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
