"""The filtered activation's kernels (K5 and K1 of the JAX package), their
plain version and the dispatcher. Forward only; NCHW; float32.

- ``filtered_act_plane``: whole planes in shared memory, H, W <= 64
  (counterpart of ``pallas_kernels.py::_forward``).
- ``filtered_act_banded``: the 2x intermediate walked in row bands,
  96 <= H, W <= 512 (counterpart of ``pallas_kernels.py::_forward_spatial``).
- ``filtered_act_plain``: ``D_h act(U_h x U_w^T) D_w^T`` with
  ``torch.matmul``, the function both kernels compute.

A wrapper given a CPU tensor returns the plain version; given a CUDA tensor
it launches its kernel or raises. There is no fallback between them.
"""

import torch

from .. import kernels
from .ideal_lpf import (_ACTS, _downsample_op, _upsample_op,
                        filtered_act_matmul, filtered_nonlinearity)

ACT_CODES = {"silu": 0, "swish": 0, "gelu": 1, "relu": 2, "mish": 3,
             "leaky_relu": 4, "tanh": 5, "linear": 6}

PLANE_MAX = 64
BANDED_MIN = 96
BANDED_MAX = 512
# the banded kernel keeps its H x W accumulator in shared memory up to this
ACC_SMEM_MAX_BYTES = 64 * 1024

_KERNEL_OPS = {}


# the plain version of both kernels (H, W % 4 == 0)
filtered_act_plain = filtered_act_matmul


def _kernel_ops(H: int, W: int, device) -> tuple:
    """(U_h, U_w^T, D_h, D_w^T) as contiguous float32 tensors on ``device``."""
    key = (H, W, torch.device(device))
    if key not in _KERNEL_OPS:
        ops = (_upsample_op(H, 2), _upsample_op(W, 2).T,
               _downsample_op(2 * H, 2), _downsample_op(2 * W, 2).T)
        _KERNEL_OPS[key] = tuple(torch.from_numpy(o.copy()).to(device)
                                 for o in ops)
    return _KERNEL_OPS[key]


def _check(x: torch.Tensor, act: str, lo: int, hi: int, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CPU or CUDA tensors only, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{name}: expects NCHW, got shape {tuple(x.shape)}")
    H, W = x.shape[-2:]
    if H % 4 or W % 4 or not (lo <= H <= hi and lo <= W <= hi):
        raise ValueError(f"{name}: takes H, W % 4 == 0 in [{lo}, {hi}], "
                         f"got {H}x{W}")
    if act not in ACT_CODES:
        raise ValueError(f"{name}: unknown activation {act!r}")


def _launch_args(x: torch.Tensor):
    x = x.contiguous()
    out = torch.empty_like(x)
    H, W = x.shape[-2:]
    ops = _kernel_ops(H, W, x.device)
    nplanes = x.shape[0] * x.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return x, out, ops, nplanes, stream


def filtered_act_plane(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Kernel for planes up to 64 px; P planes per block so that small
    planes still give the 256 threads work."""
    if x.device.type == "cpu":
        return filtered_act_plain(x, act)
    _check(x, act, 4, PLANE_MAX, "filtered_act_plane")
    x, out, ops, nplanes, stream = _launch_args(x)
    H, W = x.shape[-2:]
    ppb = max(1, 1024 // (H * W))
    err = kernels.library("filtered_act").filtered_act_plane_f32(
        x.data_ptr(), out.data_ptr(), *(o.data_ptr() for o in ops),
        nplanes, H, W, ppb, ACT_CODES[act], stream)
    kernels.check(err, "filtered_act_plane")
    kernels.LAUNCHES["filtered_act_plane"] += 1
    return out


def band_rows(H: int) -> int:
    """Rows of the 2H intermediate per band: the largest of 32, 16, 8 that
    divides 2H (8 always does when H % 4 == 0)."""
    return next(r for r in (32, 16, 8) if (2 * H) % r == 0)


def filtered_act_banded(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Kernel for 96-512 px planes, one block per plane."""
    if x.device.type == "cpu":
        return filtered_act_plain(x, act)
    _check(x, act, BANDED_MIN, BANDED_MAX, "filtered_act_banded")
    x, out, ops, nplanes, stream = _launch_args(x)
    H, W = x.shape[-2:]
    acc_in_smem = int(H * W * 4 <= ACC_SMEM_MAX_BYTES)
    err = kernels.library("filtered_act").filtered_act_banded_f32(
        x.data_ptr(), out.data_ptr(), *(o.data_ptr() for o in ops),
        nplanes, H, W, band_rows(H), acc_in_smem, ACT_CODES[act], stream)
    kernels.check(err, "filtered_act_banded")
    kernels.LAUNCHES["filtered_act_banded"] += 1
    return out


def filtered_act_fused(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Dispatcher for the model's filtered activations.

    Below 4D: the plain activation. H or W not divisible by 4 (the UNet's
    2x2 level): the FFT ref chain, as in the JAX package, where that case
    never reaches a Pallas kernel either. Otherwise ``filtered_act_plane``
    up to 64 px and ``filtered_act_banded`` for 96-512 px; any other size
    raises."""
    if x.ndim < 4:
        return _ACTS[act](x)
    H, W = x.shape[-2:]
    if H % 4 or W % 4:
        return filtered_nonlinearity(x, act)
    if max(H, W) <= PLANE_MAX:
        return filtered_act_plane(x, act)
    if BANDED_MIN <= min(H, W) and max(H, W) <= BANDED_MAX:
        return filtered_act_banded(x, act)
    raise ValueError(f"no filtered-activation kernel takes {H}x{W}")
