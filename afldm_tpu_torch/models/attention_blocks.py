"""Transformer attention blocks of the SD-family UNets (diffusers
Transformer2DModel / BasicTransformerBlock layout, SD 1.5 flavour: 1x1-conv
projections, GEGLU feed-forward, LayerNorms), NCHW at the block boundary
and (N, L, C) tokens inside. Counterpart of
``afldm_tpu/models/attention_blocks.py``.

Cross-frame attention applies to the self-attention (``attn1``): its
stored map is the token map *after* ``norm1``, which a LOAD pass takes
as the K/V source directly (unlike ``layers.Attention``, whose stored map
is pre-norm). Interpolation blends two such passes after ``to_out``, as
the JAX package computes it: two ``sdpa`` calls, not the fused ``sdpa2``.

Compute dtype as in ``layers``: every projection, norm and convolution is
the ``layers`` one, so ``set_compute_dtype`` on a model reaches these
blocks too (the LayerNorms normalise in float32 and return the compute
dtype, as Flax's ``LayerNorm(dtype=)``).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from .layers import Conv2d, GroupNorm, LayerNorm, Linear


class CrossAttention(nn.Module):
    """diffusers Attention of a transformer block: q/k/v linear without
    bias, ``to_out.0`` with bias, multi-head SDPA. ``context_dim`` is the
    width of the K/V source (the text embeddings for ``attn2``)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        self.num_heads = num_heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def _heads(self, t):
        n, L, C = t.shape
        return t.reshape(n, L, self.num_heads, C // self.num_heads) \
                .transpose(1, 2)

    def forward(self, x, context=None, context2=None, alpha=None):
        N, L, _ = x.shape
        q = self._heads(self.to_q(x))

        def attend(ctx):
            k, v = self.to_k(ctx), self.to_v(ctx)
            # a smaller context batch is broadcast over the frames after
            # projection: from batch 1 an expand view (stride 0, no copy)
            if k.shape[0] == 1 and N > 1:
                k, v = k.expand(N, -1, -1), v.expand(N, -1, -1)
            elif k.shape[0] < N:
                reps = N // k.shape[0]
                k = k.repeat_interleave(reps, dim=0)
                v = v.repeat_interleave(reps, dim=0)
            out = sdpa(q, self._heads(k), self._heads(v))
            return self.to_out[0](out.transpose(1, 2).reshape(N, L, -1))

        if context is None:
            return attend(x)
        if context2 is None:
            return attend(context)
        # alpha: default 0.5, or per frame ((N,) or (N, 1, 1)), broadcast
        # over tokens and channels
        a = torch.as_tensor(0.5 if alpha is None else alpha,
                            dtype=torch.float32, device=x.device)
        o0, o1 = attend(context), attend(context2)
        a = a.reshape(a.shape + (1,) * (o0.ndim - a.ndim))
        return (1 - a) * o0 + a * o1


def gelu_exact(x):
    """The exact (erf) gelu. A bfloat16 x takes the JAX package's bf16
    definition, 0.5·x·erfc(−x·√½) with √½ in bf16 and each step rounded to
    bf16 (Flax's ``nn.gelu(approximate=False)``); other dtypes
    ``F.gelu``."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    sqrt_half = float(torch.tensor(math.sqrt(0.5), dtype=torch.bfloat16))
    return 0.5 * x * torch.erfc(-x * sqrt_half)


class GEGLU(nn.Module):
    """``proj`` to twice the width, then value * gelu(gate) with the exact
    (erf) gelu, as diffusers computes it."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu_exact(gate)


class FeedForward(nn.Module):
    """GEGLU MLP with diffusers' names: ``net.0`` the GEGLU, ``net.2`` the
    output linear (``net.1`` is the parameter-free dropout)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    """norm1 -> self-attention (CFA) -> norm2 -> cross-attention -> norm3 ->
    GEGLU feed-forward, each with a residual; LayerNorm eps 1e-5 (torch's
    default, which diffusers keeps). Returns (tokens, the post-norm1 map)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 cross_attention_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads, head_dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, num_heads, head_dim,
                                    cross_attention_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, encoder_hidden_states, kv_override=None,
                kv_override2=None, alpha=None):
        normed = self.norm1(x)
        x = x + self.attn1(normed, kv_override, kv_override2, alpha)
        x = x + self.attn2(self.norm2(x), encoder_hidden_states)
        x = x + self.ff(self.norm3(x))
        return x, normed


class Transformer2DModel(nn.Module):
    """group-norm (eps 1e-6) -> 1x1-conv ``proj_in`` -> transformer blocks
    on the (N, H*W, C) tokens -> 1x1-conv ``proj_out`` -> residual. Each
    block takes its CFA pair from ``kv`` and pushes its stored map."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 cross_attention_dim: int, depth: int = 1, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, num_heads, head_dim,
                                  cross_attention_dim)
            for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, encoder_hidden_states, kv):
        N, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            h, stored = block(h, encoder_hidden_states, *kv.take(), kv.alpha)
            kv.push(stored)
        h = h.transpose(1, 2).reshape(N, C, H, W)
        return self.proj_out(h) + x
