"""Scaled-dot-product attention: the plain version, the flash kernels
(K3, K4a and K4b of the JAX package: ``attention.py::_flash_kernel``,
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``), the autograd
Function that joins them and the dispatcher; and the two-KV blended
attention of CFA interpolation (``sdpa2``) with its kernel (K6,
``_flash2_kernel``).

q: (..., Lq, D), k/v: (..., Lk, D). Semantics of the JAX ``sdpa_xla``:
f32 scores, f32 softmax, p cast to v's dtype for p @ v. The backward is the
JAX ``_sdpa_bwd``: p recomputed from the forward's logsumexp,
``delta = rowsum(dO * O)`` in plain torch, ``ds = p * (dp - delta) * scale``.

bfloat16 q, k, v (on the card ``flash_fwd_bf16`` and ``flash2_fwd_bf16``,
counted as ``flash_fwd/bf16`` and ``flash2_fwd/bf16``; on the CPU their
plain versions ``flash_fwd_plain`` and ``flash2_fwd_plain``): the function
of the TPU kernels ``_flash_kernel`` and ``_flash2_kernel`` at bf16, an
online softmax over key tiles of ``flash_bf16_key_tile(D)`` keys that
rounds the unnormalised p = exp(s - running max) to bf16 for p @ v, sums
the row's l from the unrounded f32 p and divides once at the end; lse f32.
The two-KV blend keeps both sets' f32 states and rounds
(1 - a) * acc0 / l0 + a * acc1 / l1 once. ``sdpa_eager`` and
``sdpa2_eager`` keep ``sdpa_xla``'s semantics (the normalised p rounded),
for what the kernels never take: D > 256 and K/V sets of unequal shapes.
The backward at bf16
(``flash_bwd_dq_bf16`` and ``flash_bwd_dkv_bf16``, counted as
``flash_bwd_dq/bf16`` and ``flash_bwd_dkv/bf16``) follows the JAX kernels
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` at bf16: s and dp
from bf16 products summed in f32, p and ds in f32, ds (and p for dv)
rounded to bf16 before the second product of each pair, accumulated in f32
and rounded to bf16 once. lse and delta stay f32. A K/V batch expanded from
one image gets bf16 dk and dv for each leading index, which autograd's
expand backward sums (in f32, rounded to bf16 once). Where
``flash_bwd_dkv_splits`` > 1 (few K/V tiles, as over 77 text tokens) the
bf16 dkv kernel splits its query walk over blocks into f32 partials, and
``flash_bwd_dkv_reduce`` (its own kernel, counted as
``flash_bwd_dkv_reduce``) sums them in split order and rounds once.
"""

import math

import torch
from torch.autograd.function import once_differentiable

from .. import kernels

FLASH_MAX_D = 256


def sdpa_eager(q, k, v, scale=None):
    """Plain SDPA: matmul, softmax, matmul."""
    return _attention_plain(q, k, v, scale)[0]


def _attention_plain(q, k, v, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    # p @ v summed in at least f32 and rounded once to v's dtype
    acc = torch.promote_types(v.dtype, torch.float32)
    return torch.matmul(p.to(acc), v.to(acc)).to(v.dtype), lse


# The bf16 forward kernels' key tile at each padded head dim
# (``kernels/csrc/flash_tile.cuh::FwdCfg``): 128 keys up to DP = 128, 64 at
# 160, 32 at 256.
_BF16_KEY_TILES = {32: 128, 48: 128, 64: 128, 80: 128, 128: 128, 160: 64,
                   256: 32}


def flash_bf16_key_tile(D: int) -> int:
    """BK of ``flash_fwd_bf16`` and ``flash2_fwd_bf16`` at head dim D (D
    padded to the smallest instantiated multiple of 16 at least D)."""
    if not 0 < D <= FLASH_MAX_D:
        raise ValueError(f"no bf16 flash kernel at head dim {D}")
    return _BF16_KEY_TILES[min(p for p in _BF16_KEY_TILES if p >= D)]


# The bf16 backward kernels' walked tile at each padded head dim
# (``kernels/csrc/flash_tile.cuh::BwdTile``): 128 rows up to DP = 80, 64
# above.
_BF16_BWD_WALK_TILES = {32: 128, 48: 128, 64: 128, 80: 128, 128: 64,
                        160: 64, 256: 64}
# ``flash_tile.cuh``'s BwdMmaCfg::BQ (the fixed rows of a block) and
# kSplitSMs (the SMs of an H100 SXM)
_BWD_FIXED_ROWS = 64
_SPLIT_SMS = 132


def flash_bwd_bf16_walk_tile(D: int) -> int:
    """BK of ``flash_bwd_dq_bf16`` and ``flash_bwd_dkv_bf16`` at head dim D
    (D padded to the smallest instantiated multiple of 16 at least D): the
    walked rows a stage of their ring."""
    if not 0 < D <= FLASH_MAX_D:
        raise ValueError(f"no bf16 flash kernel at head dim {D}")
    return _BF16_BWD_WALK_TILES[min(p for p in _BF16_BWD_WALK_TILES
                                    if p >= D)]


def flash_bwd_dkv_splits(bh: int, Lq: int, Lk: int, D: int) -> int:
    """The blocks over which the bf16 dkv kernel splits its query walk
    (``flash_tile.cuh::dkv_splits``): one where the bh·⌈Lk/64⌉ blocks give
    each SM one or the walk has fewer than 4 tiles; else up to
    ⌈2·132 / blocks⌉ splits of at least 2 walked tiles each, balanced so
    that none is empty."""
    blocks = bh * -(-Lk // _BWD_FIXED_ROWS)
    tiles = -(-Lq // flash_bwd_bf16_walk_tile(D))
    if blocks >= _SPLIT_SMS or tiles < 4:
        return 1
    s = min(tiles // 2, -(-2 * _SPLIT_SMS // blocks))
    per = -(-tiles // s)
    return -(-tiles // per)


def _online_state(q, k, v, scale, key_tile):
    """(acc, m, l) of the online softmax over ``key_tile``-key tiles, in
    order: s = q·kᵀ·scale in f32, m' = max(m, rowmax s), p = exp(s - m')
    and c = exp(m - m') in f32, l = l·c + rowsum p, acc = acc·c +
    p_(v's dtype)·v summed in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = torch.full(s.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for j in range(0, s.shape[-1], key_tile):
        st = s[..., j:j + key_tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        c = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + torch.matmul(p.to(v.dtype).float(),
                                     v[..., j:j + key_tile, :].float())
        m = m_new
    return acc, m, l


def flash_fwd_plain(q, k, v, scale=None, key_tile=None):
    """The plain version of the bf16 flash forward (K3/bf16): the online
    softmax of ``_online_state`` at ``key_tile`` (default: the kernel's,
    ``flash_bf16_key_tile``), out = (acc / l) in q's dtype and lse = m +
    log l (..., Lq, 1) f32, as the JAX ``_flash_kernel`` computes them."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if key_tile is None:
        key_tile = flash_bf16_key_tile(q.shape[-1])
    acc, m, l = _online_state(q, k, v, scale, key_tile)
    return (acc / l).to(q.dtype), m + torch.log(l)


def flash2_fwd_plain(q, k0, v0, k1, v1, alpha, scale=None, key_tile=None):
    """The plain version of the bf16 two-KV flash forward (K6/bf16): one
    online-softmax state a K/V set (``_online_state``), blended as
    (1 - a)·acc0/l0 + a·acc1/l1 in f32 and rounded once to q's dtype, as
    the JAX ``_flash2_kernel`` computes it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if key_tile is None:
        key_tile = flash_bf16_key_tile(q.shape[-1])
    lead = q.shape[:-2]
    a = _alpha_per_lead(alpha, lead, q.device).reshape(lead + (1, 1))
    (acc0, _, l0), (acc1, _, l1) = (_online_state(q, k, v, scale, key_tile)
                                    for k, v in ((k0, v0), (k1, v1)))
    return ((1.0 - a) * (acc0 / l0) + a * (acc1 / l1)).to(q.dtype)


def _all_bf16(ts):
    return all(t.dtype == torch.bfloat16 for t in ts)


def _kernel_dtype(ts, name) -> str:
    """'f32' or 'bf16': the C entry's suffix for inputs of one dtype."""
    if all(t.dtype == torch.float32 for t in ts):
        return "f32"
    if all(t.dtype == torch.bfloat16 for t in ts):
        return "bf16"
    raise TypeError(f"{name}: float32 or bfloat16 inputs of one dtype only, "
                    f"got {[t.dtype for t in ts]}")


def _as_4d(t):
    """View leading dims as (B1, B2): 3D gets B1 = 1, 4D stays."""
    if t.ndim == 3:
        return t.unsqueeze(0)
    if t.ndim == 4:
        return t
    raise ValueError(f"flash_fwd takes 3D or 4D tensors, got {tuple(t.shape)}")


def _bwd_probs(q, k, v, do, lse, delta, scale):
    """p recomputed from lse, and ds = p * (dp - delta) * scale, f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta) * scale


def _rounded(t, dtype):
    """f32 t rounded to ``dtype`` and read back as f32 (bf16: the kernels'
    A operands; f32: t itself)."""
    return t.to(dtype).float()


def _bwd_dq_plain(q, k, v, do, lse, delta, scale):
    """The plain version of ``flash_bwd_dq``: ds rounded to k's dtype,
    ds·k summed in f32, rounded once to q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, scale)
    return torch.matmul(_rounded(ds, k.dtype), k.float()).to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, scale):
    """The plain version of ``flash_bwd_dkv``: (dk, dv), dense per leading
    index; ds rounded to q's dtype and p to dO's before their products,
    each summed in f32 and rounded once."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, scale)
    dk = torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2),
                      q.float()).to(k.dtype)
    dv = torch.matmul(_rounded(p, do.dtype).transpose(-1, -2),
                      do.float()).to(v.dtype)
    return dk, dv


def _dkv_reduce_plain(ws):
    """The plain version of ``flash_bwd_dkv_reduce``: ws[0] + ws[1] + ...
    in f32, in that order, rounded once to bf16."""
    acc = ws[0]
    for part in ws[1:]:
        acc = acc + part
    return acc.to(torch.bfloat16)


def flash_bwd_dkv_reduce(ws):
    """The split bf16 dkv's reduction: ``ws`` (splits, 2, ...) f32 partials
    of dk and dv, contiguous; returns (2, ...) bf16, dk then dv, each the
    sum of its partials in split order rounded once. On the CPU its plain
    version."""
    if ws.device.type == "cpu":
        return _dkv_reduce_plain(ws)
    if (ws.dtype != torch.float32 or ws.ndim < 2 or ws.shape[0] < 1
            or not ws.is_contiguous()):
        raise ValueError("flash_bwd_dkv_reduce: contiguous f32 (splits, 2, "
                         f"...) partials only, got {ws.dtype} "
                         f"{tuple(ws.shape)}")
    out = torch.empty(ws.shape[1:], device=ws.device, dtype=torch.bfloat16)
    if out.numel() == 0:
        return out
    err = kernels.library("flash_bwd").flash_bwd_dkv_reduce(
        ws.data_ptr(), out.data_ptr(), out.numel(), ws.shape[0],
        torch.cuda.current_stream(ws.device).cuda_stream)
    kernels.check(err, "flash_bwd_dkv_reduce")
    kernels.LAUNCHES["flash_bwd_dkv_reduce"] += 1
    return out


def _delta(do, out):
    """rowsum(dO * O) in f32, (..., Lq, 1)."""
    return (do.float() * out.float()).sum(-1, keepdim=True)


def _attention_bwd_plain(q, k, v, out, lse, do, scale=None):
    """The plain version of the flash backward: (dq, dk, dv) from the
    forward's out and lse and the cotangent do, with the kernels'
    formulas."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(do, out)
    return (_bwd_dq_plain(q, k, v, do, lse, delta, scale),
            *_bwd_dkv_plain(q, k, v, do, lse, delta, scale))


def flash_fwd(q, k, v, scale=None):
    """Flash forward; returns ``(out, lse)`` with out in q's dtype (float32
    or bfloat16) and lse (..., Lq, 1) f32, like the JAX ``_flash_3d``.

    On the card, q/k/v are read through their strides; the only layout rule
    is a unit stride along D (a tensor without one is copied). A K/V batch
    expanded from 1 (``expand``, stride 0) is passed with batch stride 0 and
    never copied. Inputs with no rows (batch or Lq 0) return empty outputs
    without a launch. On the CPU: ``flash_fwd_plain`` at bf16, the plain
    softmax attention at f32. At bf16 the scale must be positive (the
    kernel takes the row max over the raw scores)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        if _all_bf16((q, k, v)):
            return flash_fwd_plain(q, k, v, scale)
        return _attention_plain(q, k, v, scale)
    if not all(t.device == q.device and t.device.type == "cuda"
               for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k, v must lie on one CUDA device")
    dt = _kernel_dtype((q, k, v), "flash_fwd")
    _check_bf16_scale(dt, scale, "flash_fwd")
    lead = q.shape[:-2]
    q4, k4, v4 = (_as_4d(t) for t in (q, k, v))
    q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q4, k4, v4))
    B1, B2, Lq, D = q4.shape
    Lk = k4.shape[2]
    if (k4.shape[:2] != (B1, B2) or v4.shape != k4.shape
            or k4.shape[3] != D or D > FLASH_MAX_D
            or (Lk == 0 and B1 * B2 * Lq)):
        raise ValueError(f"flash_fwd: unsupported shapes {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)}")
    out = torch.empty((B1, B2, Lq, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B1, B2, Lq, 1), device=q.device, dtype=torch.float32)
    if out.numel() == 0:  # no rows: nothing to launch
        return out.reshape(lead + (Lq, D)), lse.reshape(lead + (Lq, 1))
    strides = [s for t in (q4, k4, v4) for s in t.stride()[:3]]
    err = getattr(kernels.library("flash_fwd"), f"flash_fwd_{dt}")(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B1, B2, Lq, Lk, D, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    key = "flash_fwd" if dt == "f32" else "flash_fwd/bf16"
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return out.reshape(lead + (Lq, D)), lse.reshape(lead + (Lq, 1))


def _check_bf16_scale(dt, scale, name):
    if dt == "bf16" and not scale > 0:
        raise ValueError(f"{name}: the bf16 kernel takes a positive scale, "
                         f"got {scale}")


def _bwd_launch_args(q, k, v, do, lse, delta, name):
    if not all(t.device == q.device and t.device.type == "cuda"
               for t in (q, k, v, do, lse, delta)):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device")
    dt = _kernel_dtype((q, k, v, do), name)
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: lse and delta must be float32")
    q4, k4, v4, do4 = (_as_4d(t) for t in (q, k, v, do))
    q4, k4, v4, do4 = (t if t.stride(-1) == 1 else t.contiguous()
                       for t in (q4, k4, v4, do4))
    B1, B2, Lq, D = q4.shape
    Lk = k4.shape[2]
    if (k4.shape[:2] != (B1, B2) or v4.shape != k4.shape
            or k4.shape[3] != D or do4.shape != q4.shape
            or lse.numel() != B1 * B2 * Lq or delta.numel() != B1 * B2 * Lq
            or D > FLASH_MAX_D or (Lk == 0 and B1 * B2 * Lq)):
        raise ValueError(f"{name}: unsupported shapes {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)}")
    lse, delta = lse.contiguous(), delta.contiguous()
    strides = [s for t in (q4, k4, v4, do4) for s in t.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q4, k4, v4, do4, lse, delta)]
    return ptrs, (B1, B2, Lq, Lk, D), strides, dt


def flash_bwd_dq(q, k, v, do, lse, delta, scale=None):
    """dq of the flash backward (K4a): p recomputed from ``lse`` (the
    forward's (..., Lq, 1) logsumexp), ``delta = rowsum(dO * O)``
    (..., Lq, 1). Same layout rules as ``flash_fwd``; q, k, v and dO all
    float32 or all bfloat16, lse and delta float32; dq is dense, in q's
    dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, do, lse, delta, scale)
    ptrs, dims, strides, dt = _bwd_launch_args(q, k, v, do, lse, delta,
                                               "flash_bwd_dq")
    B1, B2, Lq, Lk, D = dims
    dq = torch.empty((B1, B2, Lq, D), device=q.device, dtype=q.dtype)
    if dq.numel() == 0:  # no rows: nothing to launch
        return dq.reshape(q.shape)
    key = "flash_bwd_dq" if dt == "f32" else "flash_bwd_dq/bf16"
    err = getattr(kernels.library("flash_bwd"), f"flash_bwd_dq_{dt}")(
        *ptrs, dq.data_ptr(), *dims, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return dq.reshape(q.shape)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale=None):
    """(dk, dv) of the flash backward (K4b), dense per leading index: for a
    K/V batch expanded from 1 each image gets its own rows, and autograd's
    expand backward sums them. Gradients in q's dtype. At bf16, where
    ``flash_bwd_dkv_splits`` > 1, the query walk is split over blocks into
    f32 partials (one launch, counted as ``flash_bwd_dkv/bf16``) that
    ``flash_bwd_dkv_reduce`` sums; dk and dv are then the two halves of
    one (2, ...) tensor."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    ptrs, dims, strides, dt = _bwd_launch_args(q, k, v, do, lse, delta,
                                               "flash_bwd_dkv")
    B1, B2, Lq, Lk, D = dims
    if B1 * B2 * Lq * Lk == 0:  # no rows: zero sums, nothing to launch
        dk, dv = (torch.zeros((B1, B2, Lk, D), device=q.device,
                              dtype=q.dtype) for _ in range(2))
        return dk.reshape(k.shape), dv.reshape(v.shape)
    key = "flash_bwd_dkv" if dt == "f32" else "flash_bwd_dkv/bf16"
    stream = torch.cuda.current_stream(q.device).cuda_stream
    splits = (flash_bwd_dkv_splits(B1 * B2, Lq, Lk, D) if dt == "bf16"
              else 1)
    if splits > 1:  # f32 partials of each split, then their reduction
        ws = torch.empty((splits, 2, B1, B2, Lk, D), device=q.device,
                         dtype=torch.float32)
        err = kernels.library("flash_bwd").flash_bwd_dkv_bf16_split(
            *ptrs, ws.data_ptr(), *dims, *strides, float(scale), splits,
            stream)
        kernels.check(err, key)
        kernels.LAUNCHES[key] += 1
        g = flash_bwd_dkv_reduce(ws)
        return g[0].reshape(k.shape), g[1].reshape(v.shape)
    dk, dv = (torch.empty((B1, B2, Lk, D), device=q.device, dtype=q.dtype)
              for _ in range(2))
    err = getattr(kernels.library("flash_bwd"), f"flash_bwd_dkv_{dt}")(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, *strides, float(scale),
        stream)
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return dk.reshape(k.shape), dv.reshape(v.shape)


class _FlashAttention(torch.autograd.Function):
    """``flash_fwd`` forward; ``flash_bwd_dq`` and ``flash_bwd_dkv``
    backward. Saves q, k, v, out and lse; no score matrix is stored."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = _delta(do, out)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def sdpa(q, k, v, scale=None):
    """Dispatching SDPA for the model's attention blocks: the flash kernels
    (forward and backward) for every head dim up to 256. The VAE
    mid-block's single head of D = 512 is outside the JAX flash gate
    (``attention.py:519-527``) and stays matmul + softmax there, as XLA
    computes it; so it does here."""
    if q.shape[-1] > FLASH_MAX_D:
        return sdpa_eager(q, k, v, scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, scale)


# -- two-KV blended attention (CFA interpolation) ----------------------------

def _alpha_per_lead(alpha, lead, device) -> torch.Tensor:
    """Alpha as one f32 weight per leading index, flattened, as the JAX
    ``sdpa2_flash`` broadcasts it: trailing size-1 axes beyond the leading
    rank are dropped, then alpha aligns with the leading dims from the left
    (a scalar covers all; (N,) and (N,1,1) are per frame and broadcast over
    heads)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    while a.ndim > len(lead) and a.shape[-1] == 1:
        a = a[..., 0]
    a = a.reshape(a.shape + (1,) * (len(lead) - a.ndim))
    return a.expand(lead).reshape(-1) if lead else a.reshape(1)


def _sdpa2_twopass(q, k0, v0, k1, v1, alpha, attn):
    """(1-alpha)*attn(q,k0,v0) + alpha*attn(q,k1,v1), blended in f32 and
    returned in q's dtype: the semantics the fused kernel must match."""
    lead = q.shape[:-2]
    a = _alpha_per_lead(alpha, lead, q.device).reshape(lead + (1, 1))
    o0, o1 = attn(q, k0, v0).float(), attn(q, k1, v1).float()
    return ((1.0 - a) * o0 + a * o1).to(q.dtype)


def sdpa2_eager(q, k0, v0, k1, v1, alpha, scale=None):
    """Plain two-KV blended SDPA: two ``sdpa_eager`` passes and the f32
    blend (the JAX ``sdpa2_xla``)."""
    return _sdpa2_twopass(q, k0, v0, k1, v1, alpha,
                          lambda q, k, v: sdpa_eager(q, k, v, scale))


def flash2_fwd(q, k0, v0, k1, v1, alpha, scale=None):
    """Fused two-KV flash forward (K6): ``(1-a)*attn(q,k0,v0) +
    a*attn(q,k1,v1)`` with one alpha per leading index. The layout rules
    are ``flash_fwd``'s: inputs read through their strides (a unit stride
    along D, else copied), K/V expanded from one image (stride 0) never
    copied. The four K/V tensors share one shape; all five are float32,
    or all bfloat16 (out in q's dtype). On the CPU: ``flash2_fwd_plain``
    at bf16, ``sdpa2_eager`` at f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kvs = (k0, v0, k1, v1)
    if q.device.type == "cpu":
        if _all_bf16((q, *kvs)):
            return flash2_fwd_plain(q, k0, v0, k1, v1, alpha, scale)
        return sdpa2_eager(q, k0, v0, k1, v1, alpha, scale)
    if not all(t.device == q.device and t.device.type == "cuda"
               for t in (q, *kvs)):
        raise ValueError("flash2_fwd: q, k0, v0, k1, v1 must lie on one "
                         "CUDA device")
    dt = _kernel_dtype((q, *kvs), "flash2_fwd")
    _check_bf16_scale(dt, scale, "flash2_fwd")
    lead = q.shape[:-2]
    ts = [_as_4d(t) for t in (q, *kvs)]
    ts = [t if t.stride(-1) == 1 else t.contiguous() for t in ts]
    B1, B2, Lq, D = ts[0].shape
    Lk = ts[1].shape[2]
    if (any(t.shape != (B1, B2, Lk, D) for t in ts[1:]) or D > FLASH_MAX_D
            or (Lk == 0 and B1 * B2 * Lq)):
        raise ValueError(f"flash2_fwd: unsupported shapes {tuple(q.shape)} "
                         f"x {[tuple(t.shape) for t in kvs]}")
    out = torch.empty((B1, B2, Lq, D), device=q.device, dtype=q.dtype)
    if out.numel() == 0:  # no rows: nothing to launch
        return out.reshape(lead + (Lq, D))
    a = _alpha_per_lead(alpha, lead, q.device).contiguous()
    strides = [s for t in ts for s in t.stride()[:3]]
    err = getattr(kernels.library("flash2_fwd"), f"flash2_fwd_{dt}")(
        *(t.data_ptr() for t in ts), a.data_ptr(), out.data_ptr(), B1, B2,
        Lq, Lk, D, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    key = "flash2_fwd" if dt == "f32" else "flash2_fwd/bf16"
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return out.reshape(lead + (Lq, D))


class _FlashAttention2(torch.autograd.Function):
    """``flash2_fwd`` forward. The backward is the VJP of the two-pass blend
    through ``_FlashAttention`` (K3 recompute, then K4a and K4b for each
    KV set), as the JAX ``_sdpa2_bwd`` takes it through two ``sdpa_flash``
    passes; alpha's gradient comes with it."""

    @staticmethod
    def forward(ctx, q, k0, v0, k1, v1, alpha, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k0, v0, k1, v1, alpha)
        return flash2_fwd(q, k0, v0, k1, v1, alpha, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        scale = ctx.scale
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = _sdpa2_twopass(
                *ins, lambda q, k, v: _FlashAttention.apply(q, k, v, scale))
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], g))
        return (*(next(grads) if n else None for n in needs), None)


def sdpa2(q, k0, v0, k1, v1, alpha, scale=None):
    """Dispatching two-KV blended SDPA (the CFA-interpolation attention of
    ``layers.Attention``). It chooses by shape only, like the JAX gate
    (``attention.py:453-480``) without its TPU thresholds: D <= 256 and
    ``k0.shape == k1.shape`` take the fused kernel, everything else the
    plain version."""
    if q.shape[-1] > FLASH_MAX_D or k0.shape != k1.shape:
        return sdpa2_eager(q, k0, v0, k1, v1, alpha, scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=q.device)
    return _FlashAttention2.apply(q, k0, v0, k1, v1, alpha, scale)
