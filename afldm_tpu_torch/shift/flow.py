"""Backward bilinear warping, NCHW. Flow is (N, 2, H, W) with channel 0 the
row offset di and channel 1 the column offset dj. Counterpart of
``coords_grid``, ``bilinear_sample`` and ``flow_warp`` in
``afldm_tpu/shift/flow.py``: the same four-tap gather with zero padding
and align_corners semantics (not ``grid_sample``, whose corner
conventions differ).
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
