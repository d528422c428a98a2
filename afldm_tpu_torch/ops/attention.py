"""Scaled-dot-product attention: the plain version, the flash kernel (K3 of
the JAX package, ``attention.py::_flash_kernel``) and the dispatcher.

q: (..., Lq, D), k/v: (..., Lk, D). Semantics of the JAX ``sdpa_xla``:
f32 scores, f32 softmax, p cast to v's dtype for p @ v.
"""

import math

import torch

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
    return torch.matmul(p, v), lse


def _as_4d(t):
    """View leading dims as (B1, B2): 3D gets B1 = 1, 4D stays."""
    if t.ndim == 3:
        return t.unsqueeze(0)
    if t.ndim == 4:
        return t
    raise ValueError(f"flash_fwd takes 3D or 4D tensors, got {tuple(t.shape)}")


def flash_fwd(q, k, v, scale=None):
    """Flash forward; returns ``(out, lse)`` with lse (..., Lq, 1) f32, like
    the JAX ``_flash_3d``.

    On the card, q/k/v are read through their strides; the only layout rule
    is a unit stride along D (a tensor without one is copied). A K/V batch
    expanded from 1 (``expand``, stride 0) is passed with batch stride 0 and
    never copied."""
    if q.device.type == "cpu":
        return _attention_plain(q, k, v, scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not all(t.device == q.device and t.device.type == "cuda"
               for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k, v must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("flash_fwd: float32 only")
    lead = q.shape[:-2]
    q4, k4, v4 = (_as_4d(t) for t in (q, k, v))
    q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q4, k4, v4))
    B1, B2, Lq, D = q4.shape
    Lk = k4.shape[2]
    if (k4.shape[:2] != (B1, B2) or v4.shape != k4.shape
            or k4.shape[3] != D or D > FLASH_MAX_D or Lk == 0 or Lq == 0):
        raise ValueError(f"flash_fwd: unsupported shapes {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)}")
    out = torch.empty((B1, B2, Lq, D), device=q.device, dtype=torch.float32)
    lse = torch.empty((B1, B2, Lq, 1), device=q.device, dtype=torch.float32)
    strides = [s for t in (q4, k4, v4) for s in t.stride()[:3]]
    err = kernels.library("flash_fwd").flash_fwd_f32(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B1, B2, Lq, Lk, D, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash_fwd")
    kernels.LAUNCHES["flash_fwd"] += 1
    return out.reshape(lead + (Lq, D)), lse.reshape(lead + (Lq, 1))


def sdpa(q, k, v, scale=None):
    """Dispatching SDPA for the model's attention blocks: ``flash_fwd`` for
    every head dim up to 256. The VAE mid-block's single head of D = 512 is
    outside the JAX flash gate (``attention.py:519-527``) and stays matmul +
    softmax there, as XLA computes it; so it does here."""
    if q.shape[-1] > FLASH_MAX_D:
        return sdpa_eager(q, k, v, scale)
    return flash_fwd(q, k, v, scale)[0]
