"""Masked MSE / PSNR metrics, NCHW (any layout with the batch first)."""

import torch


def mask_mse(a, b, mask):
    """Per-sample masked MSE averaged over the batch."""
    diff = (a * mask - b * mask) ** 2
    dims = tuple(range(1, a.ndim))
    return (diff.sum(dim=dims) / mask.sum(dim=dims)).mean()


def mask_psnr(a, b, mask):
    """PSNR with the dynamic range taken from the masked tensors."""
    a_, b_ = a * mask, b * mask
    i_max = torch.maximum(a_.max(), b_.max()) - torch.minimum(a_.min(),
                                                              b_.min())
    return 10.0 * torch.log10(i_max * i_max / mask_mse(a, b, mask))


def psnr(a, b, i_max=None):
    """Plain PSNR with the dynamic range taken from the tensors."""
    if i_max is None:
        i_max = torch.maximum(a.max(), b.max()) - torch.minimum(a.min(),
                                                                b.min())
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(i_max * i_max / mse)
