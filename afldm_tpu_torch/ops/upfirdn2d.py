"""upfirdn2d: pad, zero-stuff-upsample, FIR-filter, decimate. NCHW.

Counterpart of the JAX package's ``ops/upfirdn2d.py`` and of the
StyleGAN-3 reference's plain PyTorch path
(``torch_utils/ops/upfirdn2d.py:_upfirdn2d_ref``):

1. zero-stuff by ``up`` (up-1 zeros *after* each pixel),
2. pad by ``padding`` (negative = crop) around the upsampled grid,
3. convolve with ``f`` (correlate with it flipped) unless ``flip_filter``,
4. keep every ``down``-th pixel.

``padding`` is ``[x0, x1, y0, y1]``, x the width. The filter is scaled by
``gain ** (f.ndim / 2)`` a pass, so a separable 1-D filter's two passes
(W first, then H) share the gain. The filter runs as a grouped
``F.conv2d`` (one filter shared by all channels) whose stride does the
decimation; zero-stuffing is a reshape, padding and cropping ``F.pad``.
Exact float32 needs ``set_af_precision`` on the card, which turns TF32
off for cuDNN at every level.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling factors must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def _get_filter_size(f):
    if f is None:
        return 1, 1
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {f.ndim}-D")
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1,
                 separable=None) -> torch.Tensor:
    """A float32 FIR filter on the CPU: a 1-D filter of fewer than 8 taps
    becomes its 2-D outer product unless ``separable``; normalised to sum
    1, flipped, and scaled by ``gain ** (ndim / 2)``."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[np.newaxis]
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {f.ndim}-D")
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32))


def _conv_fir(x, f2d, stride):
    """Depthwise NCHW correlation of ``x`` with one (kh, kw) filter."""
    C = x.shape[1]
    kern = f2d[None, None].expand(C, 1, *f2d.shape).contiguous()
    return F.conv2d(x, kern, stride=stride, groups=C)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """See the module docstring. ``x`` is NCHW; ``f`` a 1-D (separable) or
    2-D filter (tensor, array or None for the identity)."""
    if x.ndim != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    if f is None:
        f = torch.ones((1, 1))
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    N, C, H, W = x.shape
    if W * upx + padx0 + padx1 < fw or H * upy + pady0 + pady1 < fh:
        raise ValueError("the padded, upsampled input is smaller than the "
                         "filter")

    dtype = x.dtype
    y = x.float()
    if upx > 1 or upy > 1:
        y = F.pad(y.reshape(N, C, H, 1, W, 1),
                  [0, upx - 1, 0, 0, 0, upy - 1])
        y = y.reshape(N, C, H * upy, W * upx)
    y = F.pad(y, [padx0, padx1, pady0, pady1])

    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        y = _conv_fir(y, f, (downy, downx))
    else:
        y = _conv_fir(y, f[None, :], (1, downx))
        y = _conv_fir(y, f[:, None], (downy, 1))
    return y.to(dtype)


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """Same-size FIR filtering."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """FIR upsampling by ``up``, the filter's gain scaled by up_x * up_y."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """FIR downsampling by ``down``."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """2-D convolution with optional FIR up- or downsampling, the
    reference's generic formula (``conv2d_resample.py:46-140``): padding
    applied once, relative to the upsampled image. ``x`` is NCHW, ``w``
    OIHW (out, in / groups, kh, kw); ``flip_weight=True`` is correlation,
    ``F.conv2d``'s own convention."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("x and w must be 4-D")
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    in_dtype = x.dtype
    x = upfirdn2d(x, f if up > 1 else None, up=up,
                  padding=(px0, px1, py0, py1), gain=up ** 2,
                  flip_filter=flip_filter)
    kern = w if flip_weight else w.flip([2, 3])
    x = F.conv2d(x.float(), kern.float(), groups=groups)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x.to(in_dtype)
