"""UNet2DConditionModel, the SD 1.5 text-conditioned backbone in diffusers
layout (CrossAttnDown/UpBlock2D, UNetMidBlock2DCrossAttn), NCHW, with the
alias-free wiring taken from the config (filtered resnet activations and
alias-free resamplers in the down, mid and up blocks; the transformer
blocks untouched), explicit CFA maps on the self-attentions and the
ControlNet's residual inputs. Counterpart of
``afldm_tpu/models/unet2d_condition.py``.
"""

from dataclasses import asdict, dataclass, field
from typing import Sequence

import torch
import torch.nn as nn

from .attention_blocks import Transformer2DModel
from .layers import (Conv2d, Downsample2D, GroupNorm, KVHelper,
                     ResnetBlock2D, TimestepEmbedding, Upsample2D,
                     WrappedActivation, get_timestep_embedding,
                     set_compute_dtype)


@dataclass
class UNet2DConditionConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Sequence[str] = field(default_factory=lambda: (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D"))
    up_block_types: Sequence[str] = field(default_factory=lambda: (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D"))
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8  # SD quirk: this is the HEAD COUNT
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    downsample_padding: int = 1
    transformer_layers_per_block: int = 1
    alias_free: bool = False

    @classmethod
    def from_diffusers(cls, cfg: dict, alias_free: bool = False):
        keep = {k: v for k, v in cfg.items()
                if k in cls.__dataclass_fields__ and not k.startswith("_")}
        if isinstance(keep.get("attention_head_dim"), (list, tuple)):
            # SD 2.x/XL-style per-block head counts: refused at config load
            raise NotImplementedError(
                f"per-block attention_head_dim "
                f"{keep['attention_head_dim']} is not supported (SD 1.x "
                f"configs use a single int head count)")
        keep.setdefault("alias_free", alias_free)
        return cls(**keep)

    def to_dict(self):
        return asdict(self)


def _resnet(cin, cout, temb_ch, cfg):
    return ResnetBlock2D(cin, cout, temb_ch, eps=cfg.norm_eps,
                         groups=cfg.norm_num_groups, act_fn=cfg.act_fn,
                         filtered_act=cfg.alias_free)


def _transformer(ch, cfg):
    heads = cfg.attention_head_dim
    return Transformer2DModel(ch, heads, ch // heads,
                              cfg.cross_attention_dim,
                              depth=cfg.transformer_layers_per_block,
                              groups=cfg.norm_num_groups)


class CrossAttnDownBlock2D(nn.Module):
    """(CrossAttn)DownBlock2D: resnets, optional transformers, optional
    downsampler."""

    def __init__(self, in_channels, out_channels, temb_channels, cfg,
                 add_downsample, use_attention):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([
            _resnet(in_channels if i == 0 else out_channels, out_channels,
                    temb_channels, cfg) for i in range(n)])
        self.attentions = nn.ModuleList(
            [_transformer(out_channels, cfg) for _ in range(n)]
            if use_attention else [])
        self.downsamplers = nn.ModuleList([
            Downsample2D(out_channels, out_channels,
                         padding=cfg.downsample_padding,
                         alias_free=cfg.alias_free)
        ] if add_downsample else [])

    def forward(self, x, temb, ehs, kv: KVHelper):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions:
                x = self.attentions[i](x, ehs, kv)
            skips.append(x)
        for down in self.downsamplers:
            x = down(x)
            skips.append(x)
        return x, skips


class CrossAttnUpBlock2D(nn.Module):
    """(CrossAttn)UpBlock2D: skip concat + resnets, optional transformers,
    optional upsampler."""

    def __init__(self, prev_channels, out_channels, skip_channels,
                 temb_channels, cfg, add_upsample, use_attention):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList([
            _resnet((prev_channels if i == 0 else out_channels)
                    + skip_channels[i], out_channels, temb_channels, cfg)
            for i in range(n)])
        self.attentions = nn.ModuleList(
            [_transformer(out_channels, cfg) for _ in range(n)]
            if use_attention else [])
        self.upsamplers = nn.ModuleList([
            Upsample2D(out_channels, out_channels, alias_free=cfg.alias_free)
        ] if add_upsample else [])

    def forward(self, x, skips, temb, ehs, kv: KVHelper):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions:
                x = self.attentions[i](x, ehs, kv)
        for up in self.upsamplers:
            x = up(x)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    """resnet -> transformer -> resnet."""

    def __init__(self, channels, temb_channels, cfg):
        super().__init__()
        self.resnets = nn.ModuleList([
            _resnet(channels, channels, temb_channels, cfg)
            for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(channels, cfg)])

    def forward(self, x, temb, ehs, kv: KVHelper):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ehs, kv)
        return self.resnets[1](x, temb)


class UNet2DConditionModel(nn.Module):
    """``forward(sample, timesteps, encoder_hidden_states, kv_in=None,
    kv_in2=None, alpha=None, down_block_residuals=None,
    mid_block_residual=None) -> (eps, stored_maps)``: ``kv_in`` (the maps
    of a STORE pass) for cross-frame attention, ``kv_in2`` and ``alpha``
    to blend two of them (interpolation); a ControlNet's residuals (one
    per skip, and one for the mid block) are added to the skips and to
    the mid block's output. ``dtype`` is the compute dtype of every block
    (float32 or bfloat16, ``layers.set_compute_dtype``); the parameters
    stay float32 and eps comes out in it."""

    def __init__(self, config: UNet2DConditionConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        ch = list(cfg.block_out_channels)
        temb_ch = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)

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

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        n_res = cfg.layers_per_block + 1
        for i, btype in enumerate(cfg.up_block_types):
            is_final = i == len(cfg.up_block_types) - 1
            block_skips, skip_ch = skip_ch[-n_res:], skip_ch[:-n_res]
            self.up_blocks.append(CrossAttnUpBlock2D(
                rev[i] if i == 0 else rev[i - 1], rev[i],
                list(reversed(block_skips)), temb_ch, cfg,
                add_upsample=not is_final,
                use_attention=btype.startswith("CrossAttn")))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0],
                                       eps=cfg.norm_eps)
        self.conv_act = WrappedActivation(cfg.act_fn, filtered=False)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def forward(self, sample, timesteps, encoder_hidden_states, kv_in=None,
                kv_in2=None, alpha=None, down_block_residuals=None,
                mid_block_residual=None):
        cfg = self.config
        kv = KVHelper(kv_in, kv_in2, alpha)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(get_timestep_embedding(
            timesteps, cfg.block_out_channels[0], flip_sin_to_cos=True,
            downscale_freq_shift=0))
        ehs = encoder_hidden_states

        x = self.conv_in(sample)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, ehs, kv)
            skips.extend(block_skips)
        if down_block_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_block_residuals,
                                           strict=True)]
        x = self.mid_block(x, temb, ehs, kv)
        if mid_block_residual is not None:
            x = x + mid_block_residual
        n_res = cfg.layers_per_block + 1
        for block in self.up_blocks:
            block_skips, skips = skips[-n_res:], skips[:-n_res]
            x = block(x, block_skips, temb, ehs, kv)
        x = self.conv_out(self.conv_act(self.conv_norm_out(x)))
        return x, kv.collected()
