"""The latent-conditioned ControlNet of the normal-estimation pipeline, NCHW:
the SD UNet's time embedding, ``conv_in``, down blocks and mid block, plus
a zero-initialised ``conv_in2`` through which the 4-channel latent
condition enters (``conv_in(sample) + conv_in2(cond)``) and zero-initialised
1x1 ``controlnet_down_blocks`` / ``controlnet_mid_block`` that turn each
skip and the mid block's output into the residuals the UNet adds.
Counterpart of ``afldm_tpu/models/controlnet.py``; the blocks are the
port's UNet blocks.
"""

import dataclasses
from dataclasses import asdict, dataclass, field
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .layers import (Conv2d, KVHelper, TimestepEmbedding,
                     get_timestep_embedding, set_compute_dtype)
from .unet2d_condition import (CrossAttnDownBlock2D, UNet2DConditionConfig,
                               UNetMidBlock2DCrossAttn)

# the convs that start at zero, so that an untrained ControlNet adds nothing
ZERO_INIT = ("conv_in2.", "controlnet_down_blocks.", "controlnet_mid_block.")


@dataclass
class ControlNetConfig:
    in_channels: int = 4
    conditioning_channels: int = 4  # latent-space conditioning
    down_block_types: Sequence[str] = field(default_factory=lambda: (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D"))
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    downsample_padding: int = 1
    transformer_layers_per_block: int = 1
    alias_free: bool = False

    @classmethod
    def from_unet_config(cls, u: UNet2DConditionConfig,
                         alias_free: bool | None = None):
        return cls(in_channels=u.in_channels,
                   down_block_types=tuple(u.down_block_types),
                   block_out_channels=tuple(u.block_out_channels),
                   layers_per_block=u.layers_per_block,
                   attention_head_dim=u.attention_head_dim,
                   cross_attention_dim=u.cross_attention_dim,
                   norm_num_groups=u.norm_num_groups, norm_eps=u.norm_eps,
                   act_fn=u.act_fn, downsample_padding=u.downsample_padding,
                   transformer_layers_per_block=u.transformer_layers_per_block,
                   alias_free=(u.alias_free if alias_free is None
                               else alias_free))

    @classmethod
    def from_diffusers(cls, cfg: dict, alias_free: bool = False):
        """Build from a diffusers controlnet (or unet) config.json dict,
        keeping only the keys this latent-conditioned variant uses."""
        names = {f.name for f in dataclasses.fields(cls)}
        keep = {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in cfg.items() if k in names}
        keep.setdefault("alias_free", alias_free)
        return cls(**keep)

    def to_dict(self):
        return asdict(self)


class ControlNetModel(nn.Module):
    """``forward(sample, timesteps, encoder_hidden_states, cond,
    conditioning_scale=1.0, kv_in=None, kv_in2=None, alpha=None,
    guess_mode=False) -> (down_residuals, mid_residual, stored_maps)``.
    ``guess_mode`` ramps the residual strengths logarithmically from 0.1
    (shallowest skip) to 1 (mid block) before ``conditioning_scale``.
    ``dtype`` is the compute dtype (``layers.set_compute_dtype``); the
    parameters stay float32 and the residuals come out in it."""

    def __init__(self, config: ControlNetConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        ch = list(cfg.block_out_channels)
        temb_ch = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.conv_in2 = Conv2d(cfg.conditioning_channels, ch[0], 3,
                               padding=1)

        self.down_blocks = nn.ModuleList()
        skip_ch = [ch[0]]
        prev = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            is_final = i == len(cfg.down_block_types) - 1
            self.down_blocks.append(CrossAttnDownBlock2D(
                prev, ch[i], temb_ch, cfg, add_downsample=not is_final,
                use_attention=btype.startswith("CrossAttn")))
            skip_ch += [ch[i]] * (cfg.layers_per_block
                                  + (0 if is_final else 1))
            prev = ch[i]
        self.mid_block = UNetMidBlock2DCrossAttn(ch[-1], temb_ch, cfg)
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv2d(c, c, 1) for c in skip_ch])
        self.controlnet_mid_block = Conv2d(ch[-1], ch[-1], 1)
        self.zero_controls_()
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    @torch.no_grad()
    def zero_controls_(self):
        """Sets ``conv_in2`` and the 1x1 residual convs to zero, as the
        Flax initialisers make them."""
        for name, p in self.named_parameters():
            if name.startswith(ZERO_INIT):
                p.zero_()
        return self

    def forward(self, sample, timesteps, encoder_hidden_states, cond,
                conditioning_scale: float = 1.0, kv_in=None, kv_in2=None,
                alpha=None, guess_mode: bool = False):
        cfg = self.config
        kv = KVHelper(kv_in, kv_in2, alpha)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(get_timestep_embedding(
            timesteps, cfg.block_out_channels[0], flip_sin_to_cos=True,
            downscale_freq_shift=0))
        ehs = encoder_hidden_states

        x = self.conv_in(sample) + self.conv_in2(cond)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, ehs, kv)
            skips.extend(block_skips)
        x = self.mid_block(x, temb, ehs, kv)

        n = len(skips) + 1
        ramp = np.logspace(-1, 0, n) if guess_mode else np.ones(n)
        scales = [float(r) * conditioning_scale for r in ramp]
        down_res = tuple(conv(s) * scale for conv, s, scale in
                         zip(self.controlnet_down_blocks, skips, scales))
        mid_res = self.controlnet_mid_block(x) * scales[-1]
        return down_res, mid_res, kv.collected()
