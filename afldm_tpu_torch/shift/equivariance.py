"""StyleGAN-3 equivariance metrics (EQ-T, EQ-T_frac, EQ-R) and the Lanczos
fractional translation, NCHW. Counterpart of the JAX package's
``shift/equivariance.py`` (reference: ``af_libs/equivariance.py``).

Translation offsets are Python floats, fractions of the image's width and
height, and the slices they give are resolved on the host. The affine
warp samples with ``F.grid_sample`` on an ``F.affine_grid``, both with
``align_corners=False`` and zero padding.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.upfirdn2d import filter2d, upsample2d


def sinc(x):
    """sin(pi x) / (pi x), 1 at 0."""
    y = (x * np.pi).abs()
    z = torch.sin(y) / y.clamp(min=1e-30)
    return torch.where(y < 1e-30, torch.ones_like(x), z)


def lanczos_window(x, a):
    x = x.abs() / a
    return torch.where(x < 1, sinc(x), torch.zeros_like(x))


def rotation_matrix(angle):
    """3x3 float32 numpy rotation by ``angle`` radians."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=np.float32)


def apply_integer_translation(x, tx, ty):
    """Translate by (tx * W, ty * H) rounded to whole pixels; returns
    (image, mask), zeros where nothing moved in."""
    N, C, H, W = x.shape
    ix = int(np.rint(tx * W))
    iy = int(np.rint(ty * H))
    z = torch.zeros_like(x)
    m = torch.zeros_like(x)
    if abs(ix) < W and abs(iy) < H:
        dst = (slice(None), slice(None), slice(max(iy, 0), H + min(iy, 0)),
               slice(max(ix, 0), W + min(ix, 0)))
        z[dst] = x[:, :, max(-iy, 0): H + min(-iy, 0),
                   max(-ix, 0): W + min(-ix, 0)]
        m[dst] = 1.0
    return z, m


def apply_fractional_translation(x, tx, ty, a=3):
    """Translate by (tx * W, ty * H) pixels with separable Lanczos-``a``
    taps; returns (image, mask), the mask 1 where every tap was inside."""
    N, C, H, W = x.shape
    txp = float(tx) * W
    typ = float(ty) * H
    ix = int(np.floor(txp))
    iy = int(np.floor(typ))
    fx = txp - ix
    fy = typ - iy
    b = a - 1

    z = torch.zeros_like(x)
    zx0 = max(ix - b, 0)
    zy0 = max(iy - b, 0)
    zx1 = min(ix + a, 0) + W
    zy1 = min(iy + a, 0) + H
    if zx0 < zx1 and zy0 < zy1:
        taps = torch.arange(a * 2, dtype=torch.float32, device=x.device) - b
        filter_x = sinc(taps - fx) * sinc((taps - fx) / a)
        filter_y = sinc(taps - fy) * sinc((taps - fy) / a)
        y = filter2d(x, (filter_x / filter_x.sum())[None, :],
                     padding=[b, a, 0, 0])
        y = filter2d(y, (filter_y / filter_y.sum())[:, None],
                     padding=[0, 0, b, a])
        z[:, :, zy0:zy1, zx0:zx1] = y[
            :, :, max(b - iy, 0): H + b + a + min(-iy - a, 0),
            max(b - ix, 0): W + b + a + min(-ix - a, 0)]

    m = torch.zeros_like(x)
    mx0 = max(ix + a, 0)
    my0 = max(iy + a, 0)
    mx1 = min(ix - b, 0) + W
    my1 = min(iy - b, 0) + H
    if mx0 < mx1 and my0 < my1:
        m[:, :, my0:my1, mx0:mx1] = 1.0
    return z, m


def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4,
                                      cutoff_in=1, cutoff_out=1):
    """The oriented band-limit filter of an affine warp, built in numpy
    (a float32 tensor on the CPU)."""
    if not a <= amax < aflt:
        raise ValueError(f"need a <= amax < aflt, got {a}, {amax}, {aflt}")
    mat = np.asarray(mat, dtype=np.float32)

    taps = np.roll((np.arange(aflt * up * 2 - 1) + 1) / up - aflt,
                   1 - aflt * up)
    yi, xi = np.meshgrid(taps, taps, indexing="ij")
    pts = np.stack([xi, yi], axis=2) @ mat[:2, :2].T
    xo, yo = pts[..., 0], pts[..., 1]

    def np_lanczos(v, aa):
        vv = np.abs(v) / aa
        return np.where(vv < 1, np.sinc(vv), 0.0)

    fi = np.sinc(xi * cutoff_in) * np.sinc(yi * cutoff_in)
    fo = np.sinc(xo * cutoff_out) * np.sinc(yo * cutoff_out)
    f = np.real(np.fft.ifftn(np.fft.fftn(fi) * np.fft.fftn(fo)))

    wi = np_lanczos(xi, a) * np_lanczos(yi, a)
    wo = np_lanczos(xo, a) * np_lanczos(yo, a)
    w = np.real(np.fft.ifftn(np.fft.fftn(wi) * np.fft.fftn(wo)))

    f = f * w
    c = (aflt - amax) * up
    f = np.roll(f, (aflt * up - 1,) * 2, axis=(0, 1))[c:-c, c:-c]
    f = np.pad(f, ((0, 1), (0, 1))).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(axis=(0, 2), keepdims=True) / (up ** 2)
    f = f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1]
    return torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32))


def apply_affine_transformation(x, mat, up=4, **filter_kwargs):
    """Warp ``x`` by the 3x3 ``mat``: band-limited upsample by ``up``, then
    bilinear sampling; the mask is a nearest sample of the valid core."""
    N, C, H, W = x.shape
    mat = np.asarray(mat, dtype=np.float32)

    f = construct_affine_bandlimit_filter(mat, up=up, **filter_kwargs)
    p = f.shape[0] // 2

    theta = np.linalg.inv(mat)
    theta[:2, 2] *= 2
    theta[0, 2] += 1 / up / W
    theta[1, 2] += 1 / up / H
    theta[0, :] *= W / (W + p / up * 2)
    theta[1, :] *= H / (H + p / up * 2)
    theta = torch.from_numpy(np.ascontiguousarray(theta[:2, :3])).to(
        x.device)[None].expand(N, 2, 3)

    y = upsample2d(x, f, up=up, padding=p)
    g = F.affine_grid(theta, [N, C, H, W], align_corners=False)
    z = F.grid_sample(y, g, mode="bilinear", padding_mode="zeros",
                      align_corners=False)

    m = torch.zeros_like(y)
    c = p * 2 + 1
    m[:, :, c:-c, c:-c] = 1.0
    m = F.grid_sample(m, g, mode="nearest", padding_mode="zeros",
                      align_corners=False)
    return z, m


def apply_fractional_rotation(x, angle, a=3, **filter_kwargs):
    """R_alpha: rotate by ``angle`` radians."""
    mat = rotation_matrix(angle)
    return apply_affine_transformation(x, mat, a=a, amax=a * 2,
                                       **filter_kwargs)


def apply_fractional_pseudo_rotation(x, angle, a=3, **filter_kwargs):
    """R*_alpha: the rotation's band limit without the rotation."""
    mat = rotation_matrix(-angle)
    f = construct_affine_bandlimit_filter(mat, a=a, amax=a * 2, up=1,
                                          **filter_kwargs)
    y = filter2d(x, f)
    m = torch.zeros_like(y)
    c = f.shape[0] // 2
    m[:, :, c:-c, c:-c] = 1.0
    return y, m


def compute_equivariance_metrics(generate_fn, num_samples, batch_size,
                                 img_resolution, translate_max=0.125,
                                 rotate_max=1.0, compute_eqt_int=False,
                                 compute_eqt_frac=False, compute_eqr=False,
                                 axis_name=None):
    """EQ-T / EQ-T_frac / EQ-R in dB. ``generate_fn(batch_index,
    transform_matrix) -> NCHW image``: ``batch_index`` counts the batches
    (0, 1, ...) and carries the caller's randomness, the same for every
    call of one batch; ``transform_matrix`` is the 3x3 input-space
    transform (the identity for the reference image). Offsets and angles
    come from ``np.random.default_rng(0)``, in the JAX package's order.
    With ``axis_name`` set, the partial sums are summed over the
    ``torch.distributed`` process group (only whether it is None matters);
    without an initialised group that raises."""
    if not (compute_eqt_int or compute_eqt_frac or compute_eqr):
        raise ValueError("compute at least one metric")
    if axis_name is not None and not (torch.distributed.is_available()
                                      and torch.distributed.is_initialized()):
        raise RuntimeError("axis_name is set but torch.distributed has no "
                           "initialised process group")
    I = np.eye(3, dtype=np.float32)
    rng = np.random.default_rng(0)

    sums = None
    for index in range(-(-num_samples // batch_size)):
        orig = generate_fn(index, I)
        s = []
        if compute_eqt_int:
            t = (rng.random(2) * 2 - 1) * translate_max
            t = np.round(t * img_resolution) / img_resolution
            M = I.copy()
            M[:2, 2] = -t
            img = generate_fn(index, M)
            ref, mask = apply_integer_translation(orig, t[0], t[1])
            s += [(ref - img) ** 2 * mask, mask]
        if compute_eqt_frac:
            t = (rng.random(2) * 2 - 1) * translate_max
            M = I.copy()
            M[:2, 2] = -t
            img = generate_fn(index, M)
            ref, mask = apply_fractional_translation(orig, t[0], t[1])
            s += [(ref - img) ** 2 * mask, mask]
        if compute_eqr:
            angle = (rng.random() * 2 - 1) * (rotate_max * np.pi)
            M = rotation_matrix(-angle)
            img = generate_fn(index, M)
            ref, ref_mask = apply_fractional_rotation(orig, angle)
            pseudo, pseudo_mask = apply_fractional_pseudo_rotation(img, angle)
            mask = ref_mask * pseudo_mask
            s += [(ref - pseudo) ** 2 * mask, mask]
        s = torch.stack([v.double().sum() for v in s])
        sums = s if sums is None else sums + s

    if axis_name is not None:
        torch.distributed.all_reduce(sums)
    sums = sums.cpu().numpy()
    mses = sums[0::2] / sums[1::2]
    psnrs = np.log10(2) * 20 - np.log10(mses) * 10
    return psnrs[0] if len(psnrs) == 1 else tuple(psnrs)
