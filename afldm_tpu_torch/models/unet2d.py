"""UNet2DModel with the diffusers architecture and parameter names (the
FFHQ AF-LDM backbone, ``configs/ldm/model_unet.json``), config-driven
alias-free resampling and filtered activations, NCHW. Counterpart of
``afldm_tpu/models/unet2d.py``.

Cross-frame attention is explicit data: the forward pass returns the
pre-norm map of every self-attention layer (STORE) and accepts a tuple of
such maps as K/V sources (LOAD).
"""

from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import (Attention, Conv2d, Downsample2D, GroupNorm, KVHelper,
                     ResnetBlock2D, TimestepEmbedding, Upsample2D,
                     WrappedActivation, get_timestep_embedding,
                     set_compute_dtype)


@dataclass
class UNet2DConfig:
    sample_size: int = 32
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Sequence[str] = field(default_factory=lambda: (
        "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D",
        "AttnDownBlock2D", "DownBlock2D"))
    up_block_types: Sequence[str] = field(default_factory=lambda: (
        "UpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D",
        "AttnUpBlock2D"))
    block_out_channels: Sequence[int] = (192, 384, 384, 768, 768)
    layers_per_block: int = 2
    attention_head_dim: int = 24
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    downsample_padding: int = 1
    add_attention: bool = True
    dropout: float = 0.0
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    alias_free: bool = False
    # None follows alias_free
    filtered_act: Optional[bool] = None

    def resolved_filtered_act(self) -> bool:
        return self.alias_free if self.filtered_act is None \
            else self.filtered_act

    @classmethod
    def from_diffusers(cls, cfg: dict, alias_free: bool = False):
        keep = {k: v for k, v in cfg.items()
                if k in cls.__dataclass_fields__ and not k.startswith("_")}
        return cls(**keep, **({"alias_free": alias_free}
                              if "alias_free" not in keep else {}))

    def to_dict(self):
        return asdict(self)


class AttnDownBlock2D(nn.Module):
    """(Attn)DownBlock2D: resnets, optional attentions, optional downsampler."""

    def __init__(self, in_channels, out_channels, temb_channels, num_layers,
                 head_dim, groups, eps, act_fn, filtered_act, alias_free,
                 add_downsample, downsample_padding, use_attention):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels, eps=eps, groups=groups,
                          act_fn=act_fn, filtered_act=filtered_act)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Attention(out_channels, out_channels // head_dim, eps=eps,
                      groups=groups)
            for _ in range(num_layers)] if use_attention else [])
        self.downsamplers = nn.ModuleList([
            Downsample2D(out_channels, out_channels,
                         padding=downsample_padding, alias_free=alias_free)
        ] if add_downsample else [])

    def forward(self, x, temb, kv: KVHelper):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions:
                x, stored = self.attentions[i](x, *kv.take(),
                                               kv.alpha)
                kv.push(stored)
            skips.append(x)
        for down in self.downsamplers:
            x = down(x)
            skips.append(x)
        return x, skips


class AttnUpBlock2D(nn.Module):
    """(Attn)UpBlock2D: skip concat + resnets, optional attentions,
    optional upsampler."""

    def __init__(self, prev_channels, out_channels, skip_channels,
                 temb_channels, num_layers, head_dim, groups, eps, act_fn,
                 filtered_act, alias_free, add_upsample, use_attention):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_channels if i == 0 else out_channels)
                          + skip_channels[i], out_channels, temb_channels,
                          eps=eps, groups=groups, act_fn=act_fn,
                          filtered_act=filtered_act)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Attention(out_channels, out_channels // head_dim, eps=eps,
                      groups=groups)
            for _ in range(num_layers)] if use_attention else [])
        self.upsamplers = nn.ModuleList([
            Upsample2D(out_channels, out_channels, alias_free=alias_free)
        ] if add_upsample else [])

    def forward(self, x, skips, temb, kv: KVHelper):
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=1)
            x = resnet(x, temb)
            if self.attentions:
                x, stored = self.attentions[i](x, *kv.take(),
                                               kv.alpha)
                kv.push(stored)
        for up in self.upsamplers:
            x = up(x)
        return x


class UNetMidBlock2D(nn.Module):
    """resnet -> (attention) -> resnet, shared by UNet2DModel and the VAE
    (which uses one head over all channels: ``head_dim=None``)."""

    def __init__(self, channels, temb_channels, head_dim, groups, eps,
                 act_fn, filtered_act, add_attention=True, attn_groups=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels, eps=eps,
                          groups=groups, act_fn=act_fn,
                          filtered_act=filtered_act) for _ in range(2)])
        head_dim = head_dim or channels
        self.attentions = nn.ModuleList([
            Attention(channels, channels // head_dim, eps=eps,
                      groups=attn_groups or groups)
        ] if add_attention else [])

    def forward(self, x, temb, kv: KVHelper):
        x = self.resnets[0](x, temb)
        if self.attentions:
            x, stored = self.attentions[0](x, *kv.take(), kv.alpha)
            kv.push(stored)
        return self.resnets[1](x, temb)


class UNet2DModel(nn.Module):
    """``forward(sample, timesteps, kv_in=None, kv_in2=None, alpha=None)
    -> (eps, stored_maps)``; pass ``kv_in`` (the maps of a STORE pass) for
    cross-frame attention, and ``kv_in2`` with ``alpha`` to blend the
    attention over two STORE passes (interpolation). ``dtype`` is the
    compute dtype of every block (float32 or bfloat16, ``layers.
    set_compute_dtype``); the parameters stay float32 and eps comes out in
    it."""

    def __init__(self, config: UNet2DConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        ch = list(cfg.block_out_channels)
        temb_ch = ch[0] * 4
        af, fa = cfg.alias_free, cfg.resolved_filtered_act()
        common = dict(groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                      act_fn=cfg.act_fn, filtered_act=fa, alias_free=af,
                      head_dim=cfg.attention_head_dim,
                      temb_channels=temb_ch)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        self.down_blocks = nn.ModuleList()
        skip_ch = [ch[0]]
        prev = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            is_final = i == len(cfg.down_block_types) - 1
            self.down_blocks.append(AttnDownBlock2D(
                prev, ch[i], num_layers=cfg.layers_per_block,
                add_downsample=not is_final,
                downsample_padding=cfg.downsample_padding,
                use_attention=btype.startswith("Attn"), **common))
            skip_ch += [ch[i]] * (cfg.layers_per_block
                                  + (0 if is_final else 1))
            prev = ch[i]

        self.mid_block = UNetMidBlock2D(
            ch[-1], temb_ch, cfg.attention_head_dim, cfg.norm_num_groups,
            cfg.norm_eps, cfg.act_fn, fa, add_attention=cfg.add_attention)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        n_res = cfg.layers_per_block + 1
        for i, btype in enumerate(cfg.up_block_types):
            is_final = i == len(cfg.up_block_types) - 1
            block_skips, skip_ch = skip_ch[-n_res:], skip_ch[:-n_res]
            self.up_blocks.append(AttnUpBlock2D(
                rev[i] if i == 0 else rev[i - 1], rev[i],
                list(reversed(block_skips)), num_layers=n_res,
                add_upsample=not is_final,
                use_attention=btype.startswith("Attn"), **common))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0],
                                          eps=cfg.norm_eps)
        self.conv_act = WrappedActivation(cfg.act_fn, filtered=False)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def forward(self, sample, timesteps, kv_in=None, kv_in2=None, alpha=None):
        cfg = self.config
        kv = KVHelper(kv_in, kv_in2, alpha)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = get_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift)
        temb = self.time_embedding(t_emb)

        x = self.conv_in(sample)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, kv)
            skips.extend(block_skips)
        x = self.mid_block(x, temb, kv)
        n_res = cfg.layers_per_block + 1
        for block in self.up_blocks:
            block_skips, skips = skips[-n_res:], skips[:-n_res]
            x = block(x, block_skips, temb, kv)
        x = self.conv_out(self.conv_act(self.conv_norm_out(x)))
        return x, kv.collected()
