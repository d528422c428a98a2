"""Built-in optical flow: coarse-to-fine iterative Lucas-Kanade, NCHW.
Counterpart of ``afldm_tpu/shift/simple_flow.py``, the flow the
interpolation CLI uses when no flows are given: bidirectional flow plus
UnFlow occlusion masks, the interface of the reference's ``predict_flow``.

Flow convention: (N, 2, H, W), channel 0 the row offset di, channel 1 the
column offset dj. The pyramid's 2x flow upsample is ``F.interpolate``
bilinear with half-pixel centres, which equals the JAX package's bilinear
resize for these exact 2x steps (at the borders both reduce to the edge
pixel); the box filter is a depthwise conv with zero padding ('SAME').
"""

import torch
import torch.nn.functional as F

from .flow import flow_warp, forward_backward_consistency_check


def _gray(img):
    """[-1, 1] RGB -> one channel."""
    if img.shape[1] == 1:
        return img
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return (img * w[:, None, None]).sum(dim=1, keepdim=True)


def _box_filter(x, r):
    k = 2 * r + 1
    C = x.shape[1]
    kern = torch.full((C, 1, k, k), 1.0 / (k * k), dtype=x.dtype,
                      device=x.device)
    return F.conv2d(x, kern, padding=r, groups=C)


def _down2(x):
    return _box_filter(x, 1)[:, :, ::2, ::2]


def _grad(x):
    gy = (torch.roll(x, -1, dims=2) - torch.roll(x, 1, dims=2)) * 0.5
    gx = (torch.roll(x, -1, dims=3) - torch.roll(x, 1, dims=3)) * 0.5
    return gy, gx


def _lk_refine(i0, i1, flow, radius=3, iters=3, eps=1e-3):
    """Iterative LK at one pyramid level. ``eps`` on the structure tensor's
    diagonal keeps its determinant above eps² (Cauchy-Schwarz), so the
    division never meets zero."""
    for _ in range(iters):
        warped = flow_warp(i1, flow)
        iy, ix = _grad(warped)
        it = warped - i0
        a11 = _box_filter(iy * iy, radius) + eps
        a12 = _box_filter(iy * ix, radius)
        a22 = _box_filter(ix * ix, radius) + eps
        b1 = _box_filter(iy * it, radius)
        b2 = _box_filter(ix * it, radius)
        det = a11 * a22 - a12 * a12
        di = (-(a22 * b1 - a12 * b2) / det).mean(1, keepdim=True)
        dj = (-(a11 * b2 - a12 * b1) / det).mean(1, keepdim=True)
        flow = flow + torch.cat([di, dj], dim=1).clamp(-2.0, 2.0)
    return flow


def estimate_flow(img0, img1, levels=4, radius=3, iters=5):
    """Forward flow img0 -> img1, (N, 2, H, W) in pixels."""
    g0 = _gray(img0.float())
    g1 = _gray(img1.float())
    pyr = [(g0, g1)]
    for _ in range(levels - 1):
        g0, g1 = _down2(g0), _down2(g1)
        pyr.append((g0, g1))
    n = img0.shape[0]
    h, w = pyr[-1][0].shape[2:]
    flow = torch.zeros((n, 2, h, w), dtype=torch.float32, device=img0.device)
    for l0, l1 in reversed(pyr):
        if flow.shape[2] != l0.shape[2]:
            flow = 2.0 * F.interpolate(flow, size=l0.shape[2:],
                                       mode="bilinear", align_corners=False)
        flow = _lk_refine(l0, l1, flow, radius=radius, iters=iters)
        # flat (aperture-limited) regions inherit their neighbourhood's
        # motion
        flow = _box_filter(flow, 2)
    return flow


def predict_flow(img0, img1, levels=4, radius=3, iters=5):
    """(fwd_flow, fwd_occ, bwd_flow, bwd_occ): LK flow both ways and the
    forward-backward consistency masks."""
    fwd = estimate_flow(img0, img1, levels=levels, radius=radius,
                        iters=iters)
    bwd = estimate_flow(img1, img0, levels=levels, radius=radius,
                        iters=iters)
    fwd_occ, bwd_occ = forward_backward_consistency_check(fwd, bwd)
    return fwd, fwd_occ, bwd, bwd_occ
