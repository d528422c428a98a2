"""Patch discriminator for VAE-GAN training and its hinge losses, NCHW.
Counterpart of ``afldm_tpu/models/discriminator.py``.

Only the InstanceNorm + biased-conv arm is implemented (``use_bn=True``
raises, as in the JAX package). With ``antialias`` the strided convs become
stride-1 convs followed by ideal low-pass + decimate, and (with ``mod_act``)
the leaky-ReLU takes the filtered 2x sandwich.

Module names follow the Flax ones through ``from_flax``: ``conv_0`` ..
``conv_{depth-1}`` are ``conv.0`` .. ``conv.{depth-1}``; ``conv_pre`` and
``conv_out`` keep their names; the norms have no parameters.

``dtype`` is the compute dtype (``layers.set_compute_dtype``), as Flax's
``dtype=``: the convolutions run in it, the instance norms normalise in
float32 and return it; the parameters stay float32.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.ideal_lpf import downsample_rfft, filtered_nonlinearity
from .layers import Conv2d, set_compute_dtype


class Discriminator(nn.Module):

    def __init__(self, in_channels: int = 3, hidden_channels: int = 512,
                 depth: int = 6, use_bn: bool = False,
                 antialias: bool = False, mod_act: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if use_bn:
            raise NotImplementedError(
                "use_bn=True (BatchNorm + bias-free convs) is not "
                "implemented; only the default (InstanceNorm + biased "
                "convs) is")
        self.antialias = antialias
        self.mod_act = mod_act
        d = max(depth - 3, 3)
        chans = [hidden_channels // 2 ** d] + [
            hidden_channels // 2 ** max(d - 1 - i, 0)
            for i in range(depth - 1)]
        stride, pad = (1, 0) if antialias else (2, 1)
        self.conv = nn.ModuleList(
            Conv2d(cin, cout, 4, stride=stride, padding=pad)
            for cin, cout in zip([in_channels] + chans[:-1], chans))
        self.conv_pre = Conv2d(chans[-1], hidden_channels, 4, padding=1)
        self.conv_out = Conv2d(hidden_channels, 1, 4, padding=1)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def _act(self, h):
        if self.antialias and self.mod_act:
            return filtered_nonlinearity(h, "leaky_relu")
        return F.leaky_relu(h, 0.2)

    def _down(self, conv, h):
        if self.antialias:
            # "SAME" for a 4x4 kernel at stride 1: one row/column before,
            # two after
            return downsample_rfft(conv(F.pad(h, (1, 2, 1, 2))), down=2)
        return conv(h)

    @staticmethod
    def _norm(h):
        # InstanceNorm: a group norm with one group per channel, no affine,
        # in float32, returned in h's dtype
        return F.group_norm(h.float(), h.shape[1], eps=1e-5).to(h.dtype)

    def forward(self, x):
        x = self._act(self._down(self.conv[0], x))
        for conv in self.conv[1:]:
            x = self._act(self._norm(self._down(conv, x)))
        x = self._act(self._norm(self.conv_pre(x)))
        return self.conv_out(x)


def hinge_d_loss(logits_real, logits_fake):
    """Hinge GAN loss of the discriminator."""
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def hinge_g_loss(logits_fake):
    return -torch.mean(logits_fake)
