"""Ideal (rect) low-pass filtering, FFT resampling and sub-pixel shifts, NCHW.

PyTorch counterpart of ``afldm_tpu/ops/ideal_lpf.py``: the same rect masks
(with the N % 4 band-edge rules), the same three resampling chains
(dense circulant ``matmul``, exact ``spectral`` zero-pad / fold, literal
``ref`` zero-stuff) and the same fallback rules. Spatial axes are the last
two. FFTs and circulant products run in float32 and the input dtype is
restored on the way out.

Precision of the circulant products (``set_af_precision``): "highest"
(the default) is exact float32; "high" is each product's 3-pass bf16 split
``ah·bh + ah·bl + al·bh`` and "default" its single pass ``ah·bh``, where
``hi = bf16(a)`` and ``lo = bf16(a - hi)`` round to nearest even, the
products are exact and the sums float32. The level governs the circulant
operators only: TF32 stays off for matmuls and cuDNN convolutions at every
level.

bfloat16 activations (``set_af_bf16_split``): by default a bf16 input to
a circulant product is promoted to float32, filtered at the level and
rounded once on the way out, as the JAX package does. With the split on,
each operator is its bf16 (hi, lo) pair and each side's product with the
bf16 x is two single bf16 passes summed in float32, rounded to bf16
between the H side and the W side (the JAX package's ``_einsum_split``).
"""

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Rect mask construction (numpy, built once per size)
# ---------------------------------------------------------------------------


def _rect_1d(N: int, cutoff: float, edge_value: float) -> np.ndarray:
    """1D full-FFT rect mask. ``edge_value`` is used at the band-edge bins
    when ``N % 4 == 0`` (0.0 for the analysis LPF, 0.5 for reconstruction)."""
    cutoff_low = int((N * cutoff) // 2)
    cutoff_high = int(N - cutoff_low)
    rect = np.ones(N, dtype=np.float32)
    rect[cutoff_low + 1: cutoff_high] = 0.0
    if N % 4 == 0:
        rect[cutoff_low] = edge_value
        rect[cutoff_high % N] = edge_value
    return rect


def create_lpf_rect(N: int, cutoff: float = 0.5) -> np.ndarray:
    """2D ideal low-pass rect mask (full-FFT layout)."""
    r = _rect_1d(N, cutoff, edge_value=0.0)
    return r[:, None] * r[None, :]


def create_fixed_lpf_rect(N: int, size: int) -> np.ndarray:
    """Rect with a fixed passband of ``size`` bins."""
    rect = np.ones(N, dtype=np.float32)
    if size < N:
        cutoff_low = size // 2
        cutoff_high = int(N - cutoff_low)
        rect[cutoff_low + 1: cutoff_high] = 0.0
    return rect[:, None] * rect[None, :]


def create_recon_rect(N: int, cutoff: float = 0.5) -> np.ndarray:
    """Reconstruction rect (band edges 0.5 when N % 4 == 0)."""
    r = _rect_1d(N, cutoff, edge_value=0.5)
    return r[:, None] * r[None, :]


def _rect_masks_2d(H: int, W: int, cutoff: float, edge: float) -> np.ndarray:
    """Separable (H, W//2+1) rfft2-layout mask for possibly non-square input."""
    rh = _rect_1d(H, cutoff, edge)
    rw = _rect_1d(W, cutoff, edge)[: W // 2 + 1]
    return rh[:, None] * rw[None, :]


def _masked_rfft_filter(x: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    H, W = x.shape[-2:]
    X = torch.fft.rfft2(x.float())
    X = X * torch.from_numpy(mask).to(x.device)
    return torch.fft.irfft2(X, s=(H, W)).to(x.dtype)


def lpf_rfft(x: torch.Tensor, cutoff: float = 0.5,
             fixed_size: int | None = None) -> torch.Tensor:
    """Ideal low-pass via rfft2 over the last two axes; the mask is built
    per axis so non-square inputs are exact."""
    H, W = x.shape[-2:]
    if fixed_size is not None:
        rh = create_fixed_lpf_rect(H, fixed_size)[:, 0]
        rw = create_fixed_lpf_rect(W, fixed_size)[0, : W // 2 + 1]
        mask = rh[:, None] * rw[None, :]
    else:
        mask = _rect_masks_2d(H, W, cutoff, edge=0.0)
    return _masked_rfft_filter(x, mask)


def lpf_recon_rfft(x: torch.Tensor, cutoff: float = 0.5) -> torch.Tensor:
    """Reconstruction low-pass (band edges 0.5)."""
    H, W = x.shape[-2:]
    return _masked_rfft_filter(x, _rect_masks_2d(H, W, cutoff, edge=0.5))


# ---------------------------------------------------------------------------
# Spectral zero-pad upsampling and spectral-fold downsampling (exact)
# ---------------------------------------------------------------------------

# Largest edge served by the dense circulant operators; the FFT chains take
# over above it (the same rule as the JAX package, so both pick the same
# arithmetic for every shape).
_MATMUL_MAX_SIZE = 1024


def _spectral_pad(X: torch.Tensor, H: int, W: int, up: int) -> torch.Tensor:
    """rfft2 spectrum (..., H, W//2+1) -> spectrum of the ``up``x
    zero-stuffed, reconstruction-filtered, ``up**2``-scaled signal."""
    Wr = X.shape[-1]
    H2, W2 = H * up, W * up
    hh, hw = H // 2, W // 2
    row_scale = np.full(H, float(up * up), dtype=np.float32)
    row_scale[hh] *= 0.5
    col_scale = np.ones(Wr, dtype=np.float32)
    col_scale[hw] = 0.5
    Xs = X * torch.from_numpy(row_scale[:, None] * col_scale[None, :]).to(X.device)
    top = Xs[..., : hh + 1, :]
    bot = Xs[..., hh:H, :]
    mid = X.new_zeros(X.shape[:-2] + (H2 - H - 1, Wr))
    Y = torch.cat([top, mid, bot], dim=-2)
    return F.pad(Y, (0, W2 // 2 + 1 - Wr))


def _spectral_fold(X: torch.Tensor, H: int, W: int, down: int) -> torch.Tensor:
    """rfft2 spectrum at (H, W) -> spectrum of
    ``lpf_rfft(y, 1/down)[..., ::down, ::down]``."""
    Ho, Wo = H // down, W // down
    hh, hw = Ho // 2, Wo // 2
    top = X[..., :hh, :]
    bot = X[..., H - hh + 1: H, :]
    zero_row = X.new_zeros(X.shape[:-2] + (1, X.shape[-1]))
    Y = torch.cat([top, zero_row, bot], dim=-2)[..., : hw + 1]
    col_scale = np.full(hw + 1, 1.0 / (down * down), dtype=np.float32)
    col_scale[hw] = 0.0
    return Y * torch.from_numpy(col_scale).to(X.device)


def upsample_rfft(x: torch.Tensor, up: int = 2, factor: int = 1,
                  impl: str = "matmul") -> torch.Tensor:
    """Ideal (sinc) upsampling by integer ``up`` over the last two axes.

    ``matmul`` applies dense circulant operators, ``spectral`` pads the
    spectrum, ``ref`` zero-stuffs and filters literally (and alone handles
    odd sizes and ``factor != 1``)."""
    if up == 1:
        return x
    H, W = x.shape[-2:]
    even = H % 2 == 0 and W % 2 == 0 and up % 2 == 0
    if (impl == "matmul" and factor == 1 and even
            and max(H, W) * up <= _MATMUL_MAX_SIZE):
        return _apply_sep(x, ("up", H, up), ("up", W, up))
    if impl in ("spectral", "matmul") and factor == 1 and even:
        X = torch.fft.rfft2(x.float())
        Y = _spectral_pad(X, H, W, up)
        return torch.fft.irfft2(Y, s=(H * up, W * up)).to(x.dtype)
    z = x.new_zeros(x.shape[:-2] + (H, up, W, up))
    z[..., :, 0, :, 0] = x
    z = z.reshape(x.shape[:-2] + (H * up, W * up))
    return lpf_recon_rfft(z, cutoff=factor / up) * (up * up)


def downsample_rfft(x: torch.Tensor, down: int = 2,
                    impl: str = "matmul") -> torch.Tensor:
    """Ideal low-pass then decimate: ``lpf_rfft(x, 1/down)[..., ::down, ::down]``."""
    H, W = x.shape[-2:]
    ok = H % (2 * down) == 0 and W % (2 * down) == 0
    if impl == "matmul" and ok and max(H, W) <= _MATMUL_MAX_SIZE:
        return _apply_sep(x, ("down", H, down), ("down", W, down))
    if impl in ("spectral", "matmul") and ok:
        X = torch.fft.rfft2(x.float())
        Y = _spectral_fold(X, H, W, down)
        return torch.fft.irfft2(Y, s=(H // down, W // down)).to(x.dtype)
    return lpf_rfft(x, cutoff=1.0 / down)[..., ::down, ::down]


def subpixel_shift(images: torch.Tensor, up: int = 2, shift_x: int = 1,
                   shift_y: int = 1) -> torch.Tensor:
    """Fractional shift by (shift_x/up, shift_y/up) of (H, W): ideal
    upsample, roll by (-shift_x, -shift_y), decimate."""
    up_img = upsample_rfft(images, up=up)
    rolled = torch.roll(up_img, shifts=(-shift_x, -shift_y), dims=(-2, -1))
    return rolled[..., ::up, ::up]


# ---------------------------------------------------------------------------
# Filtered (warped) nonlinearity: 2x oversample -> act -> LPF -> decimate
# ---------------------------------------------------------------------------

def _mish(x):
    return x * torch.tanh(F.softplus(x))


def silu(x):
    """x·sigmoid(x). A bfloat16 x takes the JAX package's bf16 definition,
    x · 1 / (1 + exp(-x)) with each step rounded to bf16 (XLA's expansion
    of its silu); other dtypes ``F.silu``."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


_ACTS = {
    "silu": silu,
    "swish": silu,
    # the JAX package's gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "mish": _mish,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "tanh": torch.tanh,
    "linear": lambda x: x,
}


def filtered_act_matmul(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The sandwich with dense circulant operators on both axes:
    ``D_h act(U_h x U_w^T) D_w^T``. Needs H, W % 4 == 0."""
    H, W = x.shape[-2:]
    hi = _apply_sep(x, ("up", H, 2), ("up", W, 2))
    hi = _ACTS[act](hi)
    return _apply_sep(hi, ("down", 2 * H, 2), ("down", 2 * W, 2))


def filtered_nonlinearity(x: torch.Tensor, act: str = "silu",
                          impl: str = "matmul") -> torch.Tensor:
    """2x oversample -> act -> ideal LPF(1/2) -> decimate. Tensors below 4D
    get the plain activation. Fallback chain: matmul when H, W % 4 == 0 and
    2*max(H, W) <= 1024, spectral when % 4 == 0, otherwise ref."""
    act_fn = _ACTS[act]
    if x.ndim < 4:
        return act_fn(x)
    H, W = x.shape[-2:]
    if (impl == "matmul" and H % 4 == 0 and W % 4 == 0
            and 2 * max(H, W) <= _MATMUL_MAX_SIZE):
        return filtered_act_matmul(x, act)
    if impl in ("spectral", "matmul") and H % 4 == 0 and W % 4 == 0:
        X = torch.fft.rfft2(x.float())
        hi = torch.fft.irfft2(_spectral_pad(X, H, W, 2), s=(H * 2, W * 2))
        hi = act_fn(hi)
        Z = _spectral_fold(torch.fft.rfft2(hi), H * 2, W * 2, 2)
        return torch.fft.irfft2(Z, s=(H, W)).to(x.dtype)
    x = upsample_rfft(x, up=2, impl="ref")
    x = act_fn(x)
    x = lpf_rfft(x, cutoff=0.5)
    return x[..., ::2, ::2]


# ---------------------------------------------------------------------------
# Dense circulant operators, built once per size by applying the exact
# spectral algorithms to identity signals
# ---------------------------------------------------------------------------

_NP_OPS = {}
_DEV_OPS = {}


def _upsample_op(N: int, up: int = 2) -> np.ndarray:
    """(up*N, N) ideal zero-pad upsampling operator (1D)."""
    key = ("up", N, up)
    if key not in _NP_OPS:
        X = np.fft.rfft(np.eye(N, dtype=np.float32), axis=0)
        hh = N // 2
        scale = np.full(hh + 1, float(up), np.float32)
        scale[hh] *= 0.5
        Xs = X * scale[:, None]
        Y = np.zeros((up * N // 2 + 1, N), np.complex64)
        Y[: hh + 1] = Xs
        _NP_OPS[key] = np.fft.irfft(Y, n=up * N, axis=0).astype(np.float32)
    return _NP_OPS[key]


def _downsample_op(N: int, down: int = 2) -> np.ndarray:
    """(N//down, N) ideal LPF + decimate operator (1D)."""
    key = ("down", N, down)
    if key not in _NP_OPS:
        X = np.fft.rfft(np.eye(N, dtype=np.float32), axis=0)
        No = N // down
        hh = No // 2
        Y = np.zeros((No // 2 + 1, N), np.complex64)
        Y[:hh] = X[:hh] / down
        _NP_OPS[key] = np.fft.irfft(Y, n=No, axis=0).astype(np.float32)
    return _NP_OPS[key]


def _op(kind: str, N: int, factor: int, device) -> torch.Tensor:
    """The numpy operator as a float32 tensor on ``device``, cached per
    (kind, N, factor, device). Built outside inference mode even when first
    asked for inside it (sampling), so that training can save it for
    backward later in the same process."""
    key = (kind, N, factor, torch.device(device))
    if key not in _DEV_OPS:
        build = _upsample_op if kind == "up" else _downsample_op
        with torch.inference_mode(False):
            _DEV_OPS[key] = torch.from_numpy(build(N, factor)).to(device)
    return _DEV_OPS[key]


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------

AF_PRECISIONS = ("highest", "high", "default")
# the bf16 passes of one product at each reduced level
LEVEL_PASSES = {"high": 3, "default": 1}
_AF_PRECISION = "highest"


def set_af_precision(p: str = "highest"):
    """'highest' (the default): exact float32 circulant products. 'high':
    each product the 3-pass bf16 split ``ah·bh + ah·bl + al·bh`` (~2e-4
    per op on the JAX package's TPU); 'default': the single pass ``ah·bh``
    (~1e-2 per op there). Every level switches TF32 off for matmuls and
    cuDNN convolutions: convolutions and attention stay exact float32."""
    global _AF_PRECISION
    if p not in AF_PRECISIONS:
        raise ValueError(f"unknown af_precision {p!r}; one of "
                         f"{AF_PRECISIONS}")
    _AF_PRECISION = p
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def af_precision() -> str:
    """The level the circulant products run at now."""
    return _AF_PRECISION


_AF_BF16_SPLIT = False


def set_af_bf16_split(on: bool):
    """Run the circulant products of bfloat16 activations as two single
    bf16 passes of the operator's (hi, lo) pieces (on), or promote them to
    float32 (off, the default). Read at call time, as the level is."""
    global _AF_BF16_SPLIT
    _AF_BF16_SPLIT = bool(on)


def af_bf16_split() -> bool:
    """Whether bfloat16 activations take the split circulant products."""
    return _AF_BF16_SPLIT


def split_bf16(t: torch.Tensor) -> tuple:
    """(hi, lo) in bfloat16 with ``hi = bf16(t)`` and ``lo = bf16(t - hi)``,
    both rounded to nearest even (the casts of ``ml_dtypes`` and of the JAX
    package's ``_split_bf16``)."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.to(t.dtype)).to(torch.bfloat16)


def _pieces(t: torch.Tensor, level: str) -> tuple:
    """The bf16 pieces of t that ``level`` multiplies, as tensors of t's
    dtype: (hi, lo) at 'high', (hi,) at 'default'."""
    hi, lo = split_bf16(t)
    return (hi.to(t.dtype), lo.to(t.dtype)) if level == "high" else (
        hi.to(t.dtype),)


def level_matmul(a: torch.Tensor, b: torch.Tensor, level: str,
                 a_pieces: tuple = None, b_pieces: tuple = None,
                 exact_sums: bool = False) -> torch.Tensor:
    """a @ b at ``level``: exact at 'highest'; else the bf16 pieces of both
    as float32 tensors, ``ah@bh + ah@bl + al@bh`` ('high', summed in that
    order) or ``ah@bh`` ('default'). Each piece holds 8 significant bits,
    so each product of two is exact in float32. ``a_pieces``/``b_pieces``:
    the pieces of an operand split earlier (a cached operator).
    ``exact_sums``: at a reduced level, sum in float64 and round the result
    to a's dtype once, the float32 result of an exactly rounding
    accumulator (what the kernels' plain versions hold them to)."""
    if level == "highest":
        return torch.matmul(a, b)
    ah, *al = a_pieces or _pieces(a, level)
    bh, *bl = b_pieces or _pieces(b, level)
    dt = torch.float64 if exact_sums else ah.dtype
    ah, bh, *al = (t.to(dt) for t in (ah, bh, *al))
    bl = [t.to(dt) for t in bl]
    out = torch.matmul(ah, bh)
    if level == "high":
        out = out + torch.matmul(ah, bl[0]) + torch.matmul(al[0], bh)
    return out.to(a.dtype)


def _op_pieces(kind: str, N: int, factor: int, device,
               level: str) -> torch.Tensor:
    """The operator's bf16 pieces at ``level`` as float32, stacked (hi, lo
    at 'high'; hi at 'default'), cached per level beside the operator and
    built outside inference mode as ``_op`` is."""
    key = (kind, N, factor, torch.device(device), level)
    if key not in _DEV_OPS:
        with torch.inference_mode(False):
            _DEV_OPS[key] = torch.stack(
                _pieces(_op(kind, N, factor, device), level))
    return _DEV_OPS[key]


class _SepAtLevel(torch.autograd.Function):
    """op_h @ x @ op_w^T at a reduced level, H side first, as the JAX
    package's ``_apply_sep`` contracts. Its backward is the transposed
    chain at the same level, W side first (the transpose of the forward's
    two contractions), as a dot's transpose keeps its precision in JAX."""

    @staticmethod
    def forward(ctx, x, op_h, op_w, ph, pw, level):
        ctx.save_for_backward(op_h, op_w, ph, pw)
        ctx.level = level
        y = level_matmul(op_h, x, level, a_pieces=tuple(ph))
        return level_matmul(y, op_w.T, level,
                            b_pieces=tuple(t.T for t in pw))

    @staticmethod
    def backward(ctx, g):
        op_h, op_w, ph, pw = ctx.saved_tensors
        gw = level_matmul(g, op_w, ctx.level, b_pieces=tuple(pw))
        dx = level_matmul(op_h.T, gw, ctx.level,
                          a_pieces=tuple(t.T for t in ph))
        return dx, None, None, None, None, None


def _split_op(kind: str, N: int, factor: int, device) -> tuple:
    """The operator's (hi, lo) bf16 pieces, cached per device beside it
    and built outside inference mode as ``_op`` is."""
    key = (kind, N, factor, torch.device(device), "split")
    if key not in _DEV_OPS:
        with torch.inference_mode(False):
            _DEV_OPS[key] = split_bf16(_op(kind, N, factor, device))
    return _DEV_OPS[key]


def _matmul_split(pieces: tuple, x: torch.Tensor) -> torch.Tensor:
    """hi @ x + lo @ x for the bf16 pieces of an operator and a bf16 x:
    each product exact, summed in float32."""
    hi, lo = (p.float() for p in pieces)
    return torch.matmul(hi, x.float()) + torch.matmul(lo, x.float())


def _apply_sep(x: torch.Tensor, key_h: tuple, key_w: tuple) -> torch.Tensor:
    """y = op_h @ x @ op_w^T over the last two axes at the current level,
    the operators given by their ``_op`` keys (kind, N, factor); in
    float32 (float64 for float64 input, so that gradcheck can hold the
    chain). A bfloat16 x with ``set_af_bf16_split`` on takes the split
    products instead, H side then W side, each rounded to bf16."""
    if _AF_BF16_SPLIT and x.dtype == torch.bfloat16:
        y = _matmul_split(_split_op(*key_h, x.device), x).to(x.dtype)
        wh, wl = _split_op(*key_w, x.device)
        y = _matmul_split((wh, wl), y.transpose(-1, -2))
        return y.transpose(-1, -2).to(x.dtype)
    dt = torch.promote_types(x.dtype, torch.float32)
    op_h, op_w = (_op(*k, x.device).to(dt) for k in (key_h, key_w))
    if _AF_PRECISION == "highest":
        y = torch.matmul(op_h, x.to(dt))
        return torch.matmul(y, op_w.T).to(x.dtype)
    ph, pw = (_op_pieces(*k, x.device, _AF_PRECISION).to(dt)
              for k in (key_h, key_w))
    return _SepAtLevel.apply(x.to(dt), op_h, op_w, ph, pw,
                             _AF_PRECISION).to(x.dtype)
