"""The filtered activation's kernels (K5, K5b and K1 of the JAX package),
their plain versions, their autograd Functions and the dispatcher. NCHW;
float32 on the card.

- ``filtered_act_plane``: whole planes in shared memory, H, W <= 64
  (counterpart of ``pallas_kernels.py::_forward``); differentiable, its
  backward is ``filtered_act_plane_bwd`` (counterpart of the kernel inside
  ``pallas_kernels.py::_bwd_rule``), which recomputes the pre-activation
  from the saved x rather than storing the 4x intermediate.
- ``filtered_act_banded``: the 2x intermediate walked in row bands,
  96 <= H, W <= 512 (counterpart of ``pallas_kernels.py::_forward_spatial``);
  differentiable, its backward is ``filtered_act_banded_bwd`` (counterpart
  of ``pallas_kernels.py::_bwd_spatial``), which walks the same bands and
  recomputes the pre-activation from the saved x.
- ``filtered_act_plain``: ``D_h act(U_h x U_w^T) D_w^T`` with
  ``torch.matmul``, the function both forward kernels compute;
  ``filtered_act_plane_bwd_plain`` the VJP's six products, the plain
  version of both backward kernels.

A wrapper given a CPU tensor returns the plain version; given a CUDA tensor
it launches its kernel or raises. There is no fallback between them.
"""

import torch
from torch.autograd.function import once_differentiable

from .. import kernels
from .ideal_lpf import (_ACTS, _downsample_op, _op, _upsample_op,
                        filtered_act_matmul, filtered_nonlinearity)

ACT_CODES = {"silu": 0, "swish": 0, "gelu": 1, "relu": 2, "mish": 3,
             "leaky_relu": 4, "tanh": 5, "linear": 6}

PLANE_MAX = 64
BANDED_MIN = 96
BANDED_MAX = 512
# the banded kernel keeps its H x W accumulator in shared memory up to this
ACC_SMEM_MAX_BYTES = 64 * 1024

_KERNEL_OPS = {}


# the plain version of both forward kernels (H, W % 4 == 0)
filtered_act_plain = filtered_act_matmul


def act_grad(x: torch.Tensor, act: str) -> torch.Tensor:
    """act'(x) as the JAX package's ``_act_and_grad`` writes it: relu and
    leaky_relu take the slope of x >= 0 at 0 (torch's autograd takes 0 for
    relu there), gelu is the tanh approximation."""
    if act in ("silu", "swish"):
        s = torch.sigmoid(x)
        return s * (1 + x * (1 - s))
    if act == "gelu":
        c = 0.7978845608028654
        t = torch.tanh(c * (x + 0.044715 * x ** 3))
        du = c * (1.0 + 3.0 * 0.044715 * x ** 2)
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t ** 2) * du
    if act == "relu":
        return (x >= 0).to(x.dtype)
    if act == "leaky_relu":
        return torch.where(x >= 0, 1.0, 0.2).to(x.dtype)
    if act == "mish":
        t = torch.tanh(torch.nn.functional.softplus(x))
        return t + x * (1.0 - t ** 2) * torch.sigmoid(x)
    if act == "tanh":
        return 1 - torch.tanh(x) ** 2
    if act == "linear":
        return torch.ones_like(x)
    raise ValueError(f"unknown activation {act!r}")


def filtered_act_plane_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                                 act: str = "silu") -> torch.Tensor:
    """dx = U_h^T [act'(U_h x U_w^T) * (D_h^T g D_w)] U_w, six products
    with ``torch.matmul`` in float32 (float64 for float64 input)."""
    H, W = x.shape[-2:]
    dt = torch.promote_types(x.dtype, torch.float32)
    uh, uw = (_op("up", n, 2, x.device).to(dt) for n in (H, W))
    dh, dw = (_op("down", 2 * n, 2, x.device).to(dt) for n in (H, W))
    pre = torch.matmul(torch.matmul(uh, x.to(dt)), uw.T)
    gu = torch.matmul(torch.matmul(dh.T, g.to(dt)), dw)
    m = act_grad(pre, act) * gu
    return torch.matmul(torch.matmul(uh.T, m), uw).to(x.dtype)


def _kernel_ops(H: int, W: int, device) -> tuple:
    """(U_h, U_w^T, D_h, D_w^T) as contiguous float32 tensors on ``device``."""
    key = (H, W, torch.device(device))
    if key not in _KERNEL_OPS:
        ops = (_upsample_op(H, 2), _upsample_op(W, 2).T,
               _downsample_op(2 * H, 2), _downsample_op(2 * W, 2).T)
        with torch.inference_mode(False):  # see ideal_lpf._op
            _KERNEL_OPS[key] = tuple(torch.from_numpy(o.copy()).to(device)
                                     for o in ops)
    return _KERNEL_OPS[key]


def _kernel_bwd_ops(H: int, W: int, device) -> tuple:
    """The backward's other operators, (D_h^T, D_w, U_w, U_h^T), contiguous
    float32 on ``device``."""
    key = ("bwd", H, W, torch.device(device))
    if key not in _KERNEL_OPS:
        ops = (_downsample_op(2 * H, 2).T, _downsample_op(2 * W, 2),
               _upsample_op(W, 2), _upsample_op(H, 2).T)
        with torch.inference_mode(False):  # see ideal_lpf._op
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


def _planes_per_block(H: int, W: int) -> int:
    """P planes a block, so that small planes still give 256 threads work."""
    return max(1, 1024 // (H * W))


def _plane_forward(x: torch.Tensor, act: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return filtered_act_plain(x, act)
    _check(x, act, 4, PLANE_MAX, "filtered_act_plane")
    x, out, ops, nplanes, stream = _launch_args(x)
    H, W = x.shape[-2:]
    err = kernels.library("filtered_act").filtered_act_plane_f32(
        x.data_ptr(), out.data_ptr(), *(o.data_ptr() for o in ops),
        nplanes, H, W, _planes_per_block(H, W), ACT_CODES[act], stream)
    kernels.check(err, "filtered_act_plane")
    kernels.LAUNCHES["filtered_act_plane"] += 1
    return out


def _bwd_launch_args(x, g, act, lo, hi, name):
    """Checks x and g, then returns (the kernel's tensor arguments: x, g,
    dx and the operators U_h, U_wᵀ, D_hᵀ, D_w, U_w, U_hᵀ, contiguous;
    nplanes; stream)."""
    _check(x, act, lo, hi, name)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"{name}: g must match x in shape, device and "
                         "dtype")
    x, dx, ops, nplanes, stream = _launch_args(x)
    bwd_ops = _kernel_bwd_ops(*x.shape[-2:], x.device)
    return (x, g.contiguous(), dx, *ops[:2], *bwd_ops), nplanes, stream


def filtered_act_plane_bwd(x: torch.Tensor, g: torch.Tensor,
                           act: str = "silu") -> torch.Tensor:
    """The VJP of ``filtered_act_plane`` at x for the cotangent g (K5b)."""
    if x.device.type == "cpu":
        return filtered_act_plane_bwd_plain(x, g, act)
    args, nplanes, stream = _bwd_launch_args(
        x, g, act, 4, PLANE_MAX, "filtered_act_plane_bwd")
    H, W = x.shape[-2:]
    err = kernels.library("filtered_act").filtered_act_plane_bwd_f32(
        *(t.data_ptr() for t in args), nplanes, H, W,
        _planes_per_block(H, W), ACT_CODES[act], stream)
    kernels.check(err, "filtered_act_plane_bwd")
    kernels.LAUNCHES["filtered_act_plane_bwd"] += 1
    return args[2]


class _FilteredActPlane(torch.autograd.Function):
    """Saves x, not the 4x pre-activation (as ``_bwd_rule`` does)."""

    @staticmethod
    def forward(ctx, x, act):
        ctx.act = act
        ctx.save_for_backward(x)
        return _plane_forward(x, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return filtered_act_plane_bwd(x, g, ctx.act), None


def filtered_act_plane(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Kernel for planes up to 64 px, differentiable through
    ``filtered_act_plane_bwd``."""
    return _FilteredActPlane.apply(x, act)


def band_rows(H: int) -> int:
    """Rows of the 2H intermediate per band: the largest of 32, 16, 8 that
    divides 2H (8 always does when H % 4 == 0)."""
    return next(r for r in (32, 16, 8) if (2 * H) % r == 0)


def _banded_forward(x: torch.Tensor, act: str) -> torch.Tensor:
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


def filtered_act_banded_bwd(x: torch.Tensor, g: torch.Tensor,
                            act: str = "silu") -> torch.Tensor:
    """The VJP of ``filtered_act_banded`` at x for the cotangent g (K2)."""
    if x.device.type == "cpu":
        return filtered_act_plane_bwd_plain(x, g, act)
    args, nplanes, stream = _bwd_launch_args(
        x, g, act, BANDED_MIN, BANDED_MAX, "filtered_act_banded_bwd")
    H, W = x.shape[-2:]
    acc_in_smem = int(H * W * 4 <= ACC_SMEM_MAX_BYTES)
    err = kernels.library("filtered_act").filtered_act_banded_bwd_f32(
        *(t.data_ptr() for t in args), nplanes, H, W, band_rows(H),
        acc_in_smem, ACT_CODES[act], stream)
    kernels.check(err, "filtered_act_banded_bwd")
    kernels.LAUNCHES["filtered_act_banded_bwd"] += 1
    return args[2]


class _FilteredActBanded(torch.autograd.Function):
    """Saves x, not the 4x pre-activation (as ``_bwd_spatial`` does)."""

    @staticmethod
    def forward(ctx, x, act):
        ctx.act = act
        ctx.save_for_backward(x)
        return _banded_forward(x, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return filtered_act_banded_bwd(x, g, ctx.act), None


def filtered_act_banded(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Kernel for 96-512 px planes, one block per plane, differentiable
    through ``filtered_act_banded_bwd``."""
    return _FilteredActBanded.apply(x, act)


def filtered_act_fused(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Dispatcher for the model's filtered activations.

    Below 4D: the plain activation. H or W not divisible by 4 (the UNet's
    2x2 level): the FFT ref chain, as in the JAX package, where that case
    never reaches a Pallas kernel either; autograd runs through
    ``torch.fft``. Otherwise ``filtered_act_plane`` up to 64 px and
    ``filtered_act_banded`` for 96-512 px; any other size raises."""
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
