"""Building blocks with the diffusers parameter names (ResnetBlock2D, the
spatial Attention of UNet2DModel and the VAE, Up/Downsample2D) and their
alias-free variants, NCHW. Counterpart of ``afldm_tpu/models/layers.py``.

Every block takes ``alias_free`` / ``filtered_act`` flags; the parameters
are the same either way (the alias-free downsampler runs the stride-2
conv's weights at stride 1), so one state dict serves both wirings.

Compute dtype, as Flax's ``dtype=``: parameters stay float32, and every
``Conv2d`` and ``Linear`` casts its input, weight and bias to its module's
compute dtype at call, adding the bias after the product in that dtype;
every ``GroupNorm`` and ``LayerNorm`` normalises in float32 and returns
the compute dtype. ``set_compute_dtype`` sets it for every such layer of a
model.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa, sdpa2
from ..ops.filtered_act import filtered_act_fused
from ..ops.ideal_lpf import _ACTS, downsample_rfft, silu, upsample_rfft


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` run in ``compute_dtype`` (float32 unless
    ``set_compute_dtype`` changes it): x, weight and bias cast to it, the
    bias added after the product (two roundings, as Flax's ``Conv``)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32 and x.dtype == dt:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` run in ``compute_dtype``, as ``Conv2d`` (Flax's
    ``Dense``)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32 and x.dtype == dt:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` whose statistics and normalisation run in float32
    and whose result is cast to ``compute_dtype`` (Flax's
    ``GroupNorm(dtype=)``)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32 and x.dtype == dt:
            return super().forward(x)
        w, b = (None if t is None else t.float()
                for t in (self.weight, self.bias))
        return F.group_norm(x.float(), self.num_groups, w, b,
                            self.eps).to(dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and normalisation run in float32
    and whose result is cast to ``compute_dtype`` (Flax's
    ``LayerNorm(dtype=)``)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32 and x.dtype == dt:
            return super().forward(x)
        w, b = (None if t is None else t.float()
                for t in (self.weight, self.bias))
        return F.layer_norm(x.float(), self.normalized_shape, w, b,
                            self.eps).to(dt)


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Sets the compute dtype of every ``Conv2d``, ``Linear``,
    ``GroupNorm`` and ``LayerNorm`` in ``module`` (float32 or bfloat16);
    the parameters keep their dtype. Returns ``module``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype float32 or bfloat16, got {dtype}")
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear, GroupNorm, LayerNorm)):
            m.compute_dtype = dtype
    return module


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False,
                           downscale_freq_shift: float = 1.0,
                           scale: float = 1.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embeddings, diffusers conventions."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(silu(self.linear_1(sample)))


class WrappedActivation(nn.Module):
    """The activation of a block: when ``filtered``, 4D tensors take the
    2x-oversampled sandwich (``filtered_act_fused``); tensors below 4D
    (time embeddings) always take the plain activation."""

    def __init__(self, act_fn: str = "silu", filtered: bool = False):
        super().__init__()
        self.act_fn = act_fn
        self.filtered = filtered

    def forward(self, x):
        if self.filtered:
            return filtered_act_fused(x, self.act_fn)
        return _ACTS[self.act_fn](x)


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D ('default' time-embedding injection)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, eps: float = 1e-6,
                 groups: int = 32, act_fn: str = "silu",
                 filtered_act: bool = False):
        super().__init__()
        self.act = WrappedActivation(act_fn, filtered_act)
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.act(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(self.act(temb))[:, :, None, None]
        h = self.conv2(self.act(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Spatial self-attention (group-norm -> to_q/to_k/to_v -> SDPA ->
    to_out + residual).

    Cross-frame attention is an input: ``kv_override`` is a *pre-norm* map
    stored from the reference frame (NCHW); group-norm is re-applied to it
    before the K/V projection. A smaller override batch is repeated over
    the frame batch after projection; from batch 1 that is an ``expand``
    view (no copy), which the flash kernels read with stride 0.
    ``kv_override2`` and ``alpha`` (default 0.5; a scalar or one per frame)
    blend the attention over two stored maps for interpolation, before
    ``to_out`` (exact: ``to_out`` is affine and the weights sum to 1), in
    one pass of ``sdpa2``. The pre-norm input is always returned as the map
    a STORE pass keeps."""

    def __init__(self, channels: int, num_heads: int, eps: float = 1e-6,
                 groups: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.group_norm = GroupNorm(groups, channels, eps=eps)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def _tokens(self, x):
        """(N, C, H, W) -> group-normed (N, H*W, C)."""
        return self.group_norm(x).flatten(2).transpose(1, 2)

    def _heads(self, t):
        n, L, C = t.shape
        return t.reshape(n, L, self.num_heads, C // self.num_heads) \
                .transpose(1, 2)

    def _kv(self, override, n):
        """Head-split K/V of a stored map, broadcast over ``n`` frames."""
        kv = self._tokens(override)
        k, v = self.to_k(kv), self.to_v(kv)
        if k.shape[0] == 1 and n > 1:
            k, v = k.expand(n, -1, -1), v.expand(n, -1, -1)
        elif k.shape[0] < n:
            reps = n // k.shape[0]
            k = k.repeat_interleave(reps, dim=0)
            v = v.repeat_interleave(reps, dim=0)
        return self._heads(k), self._heads(v)

    def forward(self, x, kv_override=None, kv_override2=None, alpha=None):
        N, C, H, W = x.shape
        xn = self._tokens(x)
        q = self._heads(self.to_q(xn))
        if kv_override is None:
            out = sdpa(q, self._heads(self.to_k(xn)),
                       self._heads(self.to_v(xn)))
        elif kv_override2 is None:
            out = sdpa(q, *self._kv(kv_override, N))
        else:
            out = sdpa2(q, *self._kv(kv_override, N),
                        *self._kv(kv_override2, N),
                        0.5 if alpha is None else alpha)
        out = self.to_out[0](out.transpose(1, 2).reshape(N, H * W, C))
        return out.transpose(1, 2).reshape(N, C, H, W) + x, x


class Downsample2D(nn.Module):
    """diffusers Downsample2D (3x3 conv, stride 2) or the alias-free variant
    (the same conv at stride 1, then ideal low-pass and decimate).
    ``padding=0`` is the VAE's asymmetric (0, 1) pad."""

    def __init__(self, channels: int, out_channels: int, padding: int = 1,
                 alias_free: bool = False):
        super().__init__()
        self.alias_free = alias_free
        self.padding = padding
        self.conv = Conv2d(channels, out_channels, 3,
                              stride=1 if alias_free else 2,
                              padding=1 if alias_free else padding)

    def forward(self, x):
        if self.alias_free:
            return downsample_rfft(self.conv(x), down=2)
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """diffusers Upsample2D (nearest 2x + conv) or alias-free (ideal
    upsample + the same conv)."""

    def __init__(self, channels: int, out_channels: int,
                 alias_free: bool = False):
        super().__init__()
        self.alias_free = alias_free
        self.conv = Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x):
        if self.alias_free:
            x = upsample_rfft(x, up=2)
        else:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x)


class KVHelper:
    """Threads cross-frame-attention maps through nested blocks:
    ``take()`` returns the (override, override2) pair for the next
    attention layer (None where not given), ``alpha`` the interpolation
    weight, ``push()`` collects its stored map."""

    def __init__(self, kv_in=None, kv_in2=None, alpha=None):
        self.kv_in = kv_in
        self.kv_in2 = kv_in2
        self.alpha = alpha
        self._i = 0
        self.out = []

    def take(self):
        i = self._i
        self._i += 1
        return (None if self.kv_in is None else self.kv_in[i],
                None if self.kv_in2 is None else self.kv_in2[i])

    def push(self, stored):
        self.out.append(stored)

    def collected(self):
        return tuple(self.out)
