"""DDRM-style super-resolution degradation operators, NCHW. Counterpart of
``afldm_tpu/ops/superresolution.py``: block-average pooling and separable
bicubic downsampling with their transposes and pseudo-inverses (``H``,
``Ht``, ``H_pinv``), and the fixed 4x degrade -> nearest re-upsample
closure of the I2SB trainer (``build_sr4x``).

``SRConv`` applies its strided FIR along each axis as the product with its
(img_dim // stride, img_dim) conv matrix, ``A · x · Aᵀ``. The matrix folds
in the symmetric boundary rule (index j < 0 reads -j-1, j >= n reads
2n-1-j: the edge sample repeats, numpy's "symmetric" pad), which torch's
padding modes do not offer ("reflect" skips the edge sample). The matrices
are built with numpy once per operator; applying them costs
2·(n/stride)·n² FLOPs per plane and axis, nothing at these sizes.
"""

import numpy as np
import torch


def bicubic_kernel_1d(factor: int, a: float = -0.5) -> np.ndarray:
    """The DDRM bicubic taps (4·factor support, half-pixel centering),
    normalised to sum 1."""
    def k(x):
        ax = abs(x)
        if ax <= 1:
            return (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1
        if 1 < ax < 2:
            return a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a
        return 0.0
    taps = np.zeros(factor * 4)
    for i in range(factor * 4):
        x = (1 / factor) * (i - np.floor(factor * 4 / 2) + 0.5)
        taps[i] = k(x)
    return (taps / taps.sum()).astype(np.float32)


def _repeat2d(y, r):
    return y.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)


class SuperResolution:
    """Block-average pooling SR. The SVD is analytic: each factor x factor
    block has one singular vector (uniform) with singular value
    1/factor."""

    def __init__(self, channels, img_dim, ratio):
        self.ratio = ratio
        self.img_dim = img_dim
        self.channels = channels

    def H(self, x):
        n, c, h, w = x.shape
        r = self.ratio
        return x.reshape(n, c, h // r, r, w // r, r).mean(dim=(3, 5))

    def Ht(self, y):
        r = self.ratio
        return _repeat2d(y, r) / (r * r)

    def H_pinv(self, y):
        return _repeat2d(y, self.ratio)


class SRConv:
    """Separable strided FIR degradation with symmetric boundary
    reflection."""

    def __init__(self, kernel, channels, img_dim, stride):
        self.kernel = np.asarray(kernel, np.float32)
        self.stride = stride
        self.img_dim = img_dim
        self.channels = channels
        self.pad = (len(kernel) - stride) // 2
        self._A = None      # cached (img_dim // stride, img_dim) matrix
        self._Apinv = None  # cached truncated pinv of _A

    @staticmethod
    def _sandwich(left, x, right):
        """left · x · right over the last two axes, ``left``/``right``
        numpy matrices moved to x's device."""
        lt, rt = (torch.as_tensor(m, device=x.device) for m in (left, right))
        return torch.matmul(torch.matmul(lt, x), rt)

    def H(self, x):
        A = self._conv_matrix()
        return self._sandwich(A, x, A.T)

    def Ht(self, y):
        A = self._conv_matrix()
        return self._sandwich(A.T, y, A)

    def H_pinv(self, y):
        """Least-squares upsampling through the truncated pinv of the 1D
        conv matrix: singular values below 3e-2 are zeroed before
        inverting (a plain pinv keeps them and blows up the border
        modes)."""
        Ap = self._conv_pinv()
        return self._sandwich(Ap, y, Ap.T)

    def _conv_matrix(self):
        if self._A is not None:
            return self._A
        n = self.img_dim
        k = self.kernel
        rows = n // self.stride
        A = np.zeros((rows, n), np.float32)
        for r in range(rows):
            start = r * self.stride - self.pad
            for i in range(len(k)):
                j = start + i
                if j < 0:           # symmetric reflection: the edge repeats
                    j = -j - 1
                if j >= n:
                    j = 2 * n - 1 - j
                A[r, j] += k[i]
        self._A = A
        return A

    def _conv_pinv(self):
        if self._Apinv is not None:
            return self._Apinv
        u, s, vt = np.linalg.svd(self._conv_matrix(), full_matrices=False)
        s_inv = np.where(s < 3e-2, 0.0, 1.0 / np.maximum(s, 1e-30))
        self._Apinv = ((vt.T * s_inv) @ u.T).astype(np.float32)
        return self._Apinv


def build_sr_bicubic(factor, image_size, data_channels=3):
    k = bicubic_kernel_1d(factor)
    return SRConv(k / k.sum(), data_channels, image_size, stride=factor)


def build_sr_pool(factor, image_size, data_channels=3):
    return SuperResolution(data_channels, image_size, factor)


def build_sr4x(sr_filter, image_size, data_channels=3):
    """Fixed 4x degrade + nearest re-upsample closure."""
    if sr_filter not in ("pool", "bicubic"):
        raise ValueError(f"sr_filter must be 'pool' or 'bicubic', got "
                         f"{sr_filter!r}")
    factor = 4
    h = (build_sr_pool(factor, image_size, data_channels)
         if sr_filter == "pool"
         else build_sr_bicubic(factor, image_size, data_channels))

    def sr4x(img):
        return _repeat2d(h.H(img), factor)

    return sr4x
