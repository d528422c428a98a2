"""AutoencoderKL with the diffusers parameter names and the alias-free
options in its config (``configs/vae/model_afvae.json``), NCHW.
Counterpart of ``afldm_tpu/models/vae.py``.

Alias-free wiring:
- encoder down block i: downsampler alias-free when
  ``reversed(up_rescale)[i]``; activations filtered when
  ``down_filtered_act[i]``;
- both mid blocks filtered when ``mid_act``;
- decoder up block i: activations filtered when ``up_filtered_act[i]``,
  upsampler alias-free when ``up_rescale[i]``;
- the final activation and conv_in/conv_out are never wrapped.

``remat=True`` recomputes each down/up-block resnet in the backward pass
(non-reentrant ``torch.utils.checkpoint``); the parameter names do not
change, so one state dict serves both.
"""

from dataclasses import asdict, dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .layers import (Conv2d, Downsample2D, GroupNorm, KVHelper,
                     ResnetBlock2D, Upsample2D, WrappedActivation,
                     set_compute_dtype)
from .unet2d import UNetMidBlock2D

_EPS = 1e-6


@dataclass
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    act_fn: str = "silu"
    latent_channels: int = 4
    norm_num_groups: int = 32
    sample_size: int = 256
    scaling_factor: float = 0.18215
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True
    mid_block_add_attention: bool = True
    alias_free: bool = False
    mid_act: bool = True
    down_filtered_act: Sequence[bool] = (True, True, True, True)
    up_filtered_act: Sequence[bool] = (True, True, True, True)
    up_rescale: Sequence[bool] = (True, True, True)

    @classmethod
    def from_diffusers(cls, cfg: dict, alias_free: Optional[bool] = None):
        """Precedence for ``alias_free``: an explicit key in the dict, then
        the argument, then the heuristic (an alias-free config carries
        ``up_rescale`` or ``fft_rescale``)."""
        keep = {k: v for k, v in cfg.items()
                if k in cls.__dataclass_fields__ and not k.startswith("_")}
        if "alias_free" not in keep:
            if alias_free is None:
                alias_free = ("up_rescale" in cfg
                              or cfg.get("fft_rescale", False))
            keep["alias_free"] = alias_free
        return cls(**keep)

    def to_dict(self):
        return asdict(self)

    @property
    def downsample_ratio(self):
        return 2 ** (len(self.block_out_channels) - 1)


class _Level(nn.Module):
    """One encoder down block or decoder up block (diffusers names:
    ``resnets.j`` plus ``downsamplers.0`` / ``upsamplers.0``)."""

    def __init__(self, resnets, downsamplers=None, upsamplers=None,
                 remat=False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList(resnets)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)

    def forward(self, x):
        for r in self.resnets:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(r, x, use_reentrant=False)
            else:
                x = r(x)
        for m in getattr(self, "downsamplers", []):
            x = m(x)
        for m in getattr(self, "upsamplers", []):
            x = m(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig, remat: bool = False):
        super().__init__()
        ch = list(cfg.block_out_channels)
        g = cfg.norm_num_groups
        filtered = [cfg.alias_free and f for f in cfg.down_filtered_act]
        af_resample = list(reversed(
            [cfg.alias_free and r for r in cfg.up_rescale])) + [False]
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, out_ch in enumerate(ch):
            is_final = i == len(ch) - 1
            resnets = [ResnetBlock2D(prev if j == 0 else out_ch, out_ch,
                                     eps=_EPS, groups=g, act_fn=cfg.act_fn,
                                     filtered_act=filtered[i])
                       for j in range(cfg.layers_per_block)]
            downs = None if is_final else [
                Downsample2D(out_ch, out_ch, padding=0,
                             alias_free=af_resample[i])]
            self.down_blocks.append(_Level(resnets, downsamplers=downs,
                                           remat=remat))
            prev = out_ch
        self.mid_block = UNetMidBlock2D(
            ch[-1], None, None, g, _EPS, cfg.act_fn,
            cfg.alias_free and cfg.mid_act,
            add_attention=cfg.mid_block_add_attention)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=_EPS)
        self.conv_act = WrappedActivation(cfg.act_fn, filtered=False)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x, None, KVHelper())
        return self.conv_out(self.conv_act(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig, remat: bool = False):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        filtered = [cfg.alias_free and f for f in cfg.up_filtered_act]
        af_resample = [cfg.alias_free and r for r in cfg.up_rescale] + [False]
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = UNetMidBlock2D(
            rev[0], None, None, g, _EPS, cfg.act_fn,
            cfg.alias_free and cfg.mid_act,
            add_attention=cfg.mid_block_add_attention)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, out_ch in enumerate(rev):
            is_final = i == len(rev) - 1
            resnets = [ResnetBlock2D(prev if j == 0 else out_ch, out_ch,
                                     eps=_EPS, groups=g, act_fn=cfg.act_fn,
                                     filtered_act=filtered[i])
                       for j in range(cfg.layers_per_block + 1)]
            ups = None if is_final else [
                Upsample2D(out_ch, out_ch, alias_free=af_resample[i])]
            self.up_blocks.append(_Level(resnets, upsamplers=ups,
                                         remat=remat))
            prev = out_ch
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=_EPS)
        self.conv_act = WrappedActivation(cfg.act_fn, filtered=False)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block(x, None, KVHelper())
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_act(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """``encode`` returns (mean, logvar); ``gaussian_sample`` draws from it.
    ``remat``: per-resnet-block gradient checkpointing. ``dtype``: the
    compute dtype of every block (float32 or bfloat16); the parameters stay
    float32, and encode and decode return it."""

    def __init__(self, config: AutoencoderKLConfig, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, remat)
        self.decoder = Decoder(config, remat)
        lc = config.latent_channels
        self.quant_conv = (Conv2d(2 * lc, 2 * lc, 1)
                           if config.use_quant_conv else None)
        self.post_quant_conv = (Conv2d(lc, lc, 1)
                                if config.use_post_quant_conv else None)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def encode(self, x):
        h = self.encoder(x)
        if self.quant_conv is not None:
            h = self.quant_conv(h)
        mean, logvar = torch.chunk(h, 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    def forward(self, x, sample_posterior: bool = False, generator=None):
        """(decode(z), mean, logvar): z drawn from the posterior with
        ``generator`` when ``sample_posterior``, else its mean."""
        mean, logvar = self.encode(x)
        z = (gaussian_sample(mean, logvar, generator) if sample_posterior
             else mean)
        return self.decode(z), mean, logvar


def gaussian_sample(mean, logvar, generator=None, noise=None):
    """mean + exp(logvar / 2) * noise, the noise drawn from ``generator``
    unless given, in mean's dtype either way (the JAX package draws it in
    mean's dtype: bfloat16 for a bf16 encoder)."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)


def gaussian_kl(mean, logvar):
    """KL(q || N(0, I)) summed over the non-batch dimensions and averaged
    over the batch (the posterior's ``kl()`` reduction)."""
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return kl.sum(dim=tuple(range(1, kl.ndim))).mean()
