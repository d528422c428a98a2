"""The filtered activation's kernels (K5, K5b, K1 and K2 of the JAX
package), their plain versions, their autograd Functions and the
dispatcher. NCHW; float32 or bfloat16 on the card.

- ``filtered_act_plane``: whole planes in shared memory, H, W <= 64
  (counterpart of ``pallas_kernels.py::_forward``), P planes a block and
  each product's register micro-tile chosen by ``plane_plan``;
  differentiable, its backward is ``filtered_act_plane_bwd`` (counterpart
  of the kernel inside ``pallas_kernels.py::_bwd_rule``), the same design
  with six products on its own plan (``plane_bwd_plan``), which recomputes
  the pre-activation from the saved x rather than storing the 4x
  intermediate.
- ``filtered_act_banded``: every H, W % 4 == 0 with max(H, W) > 64
  (counterpart of ``pallas_kernels.py::_forward_spatial``), a chunk of
  planes at a time as four launches of one tiled GEMM kernel, the 2x
  intermediates in device scratch (``banded_plan`` chunks the planes and
  picks each product's block tile); differentiable at every such size,
  its backward is ``filtered_act_banded_bwd`` (counterpart of
  ``pallas_kernels.py::_bwd_spatial``), six launches of the same GEMM a
  chunk on the same scratch and plan, which recomputes the pre-activation
  from the saved x.
- ``filtered_act_plain``: ``D_h act(U_h x U_w^T) D_w^T`` with
  ``torch.matmul``, the function both forward kernels compute (at
  'highest'); ``filtered_act_plane_bwd_plain`` the VJP's six products,
  the plain version of both backward kernels at 'highest'.

At the reduced precision levels (``ideal_lpf.set_af_precision("high")``
or ``"default"``) each of the four kernels has a bf16 tensor-core variant
(``kernels/csrc/filtered_mma.cuh``): every product ``ah·bh + ah·bl +
al·bh`` (3 passes) or ``ah·bh`` (1), each f32 result split again before
the next product, in the product order of its JAX kernel, which decides
what is split: K5 and K5b as the f32 kernels, K1 and K2 H side first in
every filter pair (``filtered_act_plane_plain``,
``filtered_act_banded_plain``, ``filtered_act_plane_bwd_plain``,
``filtered_act_banded_bwd_plain`` at a level are their plain versions,
with each product's sum exactly rounded). K1's variant is two fused
launches a chunk (``kernels/csrc/filtered_banded_mma.cu``: t and lo on
chip, hi's split pieces the only scratch), chunked by
``banded_mma_plan``.
The level applies to planes up to LEVEL_MAX px a side, where the JAX
package runs the circulant products; above it both packages filter
exactly (the JAX package spectrally) and the f32 kernels run. The autograd
Functions keep the forward's level for the backward.

bfloat16 activations: the forward kernels K5 and K1 take a bf16 x and
write a bf16 out at every level (the ``_xbf16`` C entries, counted as
``<kernel>[:<level>]/bf16``): x is loaded as bf16, the products run as
for a float32 x (exact f32 at 'highest', the level's bf16 passes
otherwise) and out is rounded to bf16 once, so the result is
``bf16(f(f32(x)))``, which is what the JAX package's kernels compute for a
bf16 x (they cast x to float32 inside and write x's dtype). Their plain
versions at bf16 are the same function. So do the backward kernels K5b and
K2 (``_xbf16`` entries too, counted as ``<kernel>[:<level>]/bf16``): a bf16
x and g, a bf16 dx, ``bf16(vjp(f32(x), f32(g)))``, what the JAX package's
``_bwd_rule`` and ``_bwd_spatial`` compute for bf16 x and g.

A wrapper given a CPU tensor returns the plain version; given a CUDA tensor
it launches its kernel (chosen by dtype, level and shape: the f32 one at
"highest", the bf16 variant otherwise) or raises. There is no fallback
between them. A CUDA tensor of 0 planes returns its empty result without a
launch.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import kernels
from .ideal_lpf import (_ACTS, LEVEL_PASSES, _downsample_op, _op,
                        _upsample_op, af_precision, filtered_act_matmul,
                        filtered_nonlinearity, level_matmul, split_bf16)

ACT_CODES = {"silu": 0, "swish": 0, "gelu": 1, "relu": 2, "mish": 3,
             "leaky_relu": 4, "tanh": 5, "linear": 6}

# the plane kernels take H, W % 4 == 0 up to this; the banded kernels every
# H, W % 4 == 0 above it
PLANE_MAX = 64
# the largest side at which the reduced precision levels apply: the JAX
# package's filtered activation runs circulant products up to it
# (2·max(H, W) <= 1024) and the exact spectral chain above
LEVEL_MAX = 512
# the banded chains' scratch for one chunk of planes (6·H·W floats a plane,
# forward and backward) stays under this, or holds one plane. On an H100
# 256 MB ran K1 at the path's shapes 1.58× quicker than 32 MB, which fits
# the 50 MB L2 but cuts the GEMMs' grids into a wave or two of blocks
# (PERF.md §6)
BANDED_SCRATCH_BYTES = 256 * 2 ** 20
# the shared memory one block may use on Hopper (227 KB)
SMEM_MAX_BYTES = 232448

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


def _plain_ops(H: int, W: int, device, dt) -> tuple:
    """(U_h, U_w, D_h, D_w) of an H × W plane as ``dt`` on ``device``."""
    uh, uw = (_op("up", n, 2, device).to(dt) for n in (H, W))
    dh, dw = (_op("down", 2 * n, 2, device).to(dt) for n in (H, W))
    return uh, uw, dh, dw


# the kernels' plain versions at a reduced level: each product's sum
# exactly rounded to float32 (float32 sums in cuBLAS's or the CPU's order
# move the bf16 lo pieces of the results they split again by as much as
# a third of the level's own error, PERF.md)
_mm = functools.partial(level_matmul, exact_sums=True)


def _forward_plain(x, act, level, down_w_first):
    """D_h act(U_h x U_w^T) D_w^T with ``level_matmul`` at ``level``, up
    the H side first, down the W side first where ``down_w_first``."""
    dt = torch.promote_types(x.dtype, torch.float32)
    uh, uw, dh, dw = _plain_ops(*x.shape[-2:], x.device, dt)
    hi = _ACTS[act](_mm(_mm(uh, x.to(dt), level), uw.T, level))
    if down_w_first:
        out = _mm(dh, _mm(hi, dw.T, level), level)
    else:
        out = _mm(_mm(dh, hi, level), dw.T, level)
    return out.to(x.dtype)


def filtered_act_plane_plain(x: torch.Tensor, act: str = "silu",
                             level: str = None) -> torch.Tensor:
    """K5's plain version at ``level`` (default: the current one): at
    'highest' ``filtered_act_plain``'s exact products; at a reduced level
    ``_forward``'s order, U_h then U_w up, D_w then D_h down."""
    level = level or af_precision()
    return _forward_plain(x, act, level, level != "highest")


def filtered_act_banded_plain(x: torch.Tensor, act: str = "silu",
                              level: str = None) -> torch.Tensor:
    """K1's plain version at ``level`` (default: the current one), in
    ``_forward_spatial``'s order: U_h, U_w, D_h, D_w."""
    return _forward_plain(x, act, level or af_precision(), False)


def _bwd_plain(x, g, act, level, dx_w_first):
    """dx = U_h^T [act'(U_h x U_w^T) * (D_h^T g D_w)] U_w, six products
    with ``level_matmul`` at ``level``, H side first except dx's where
    ``dx_w_first``; float32 (float64 for float64 input)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    uh, uw, dh, dw = _plain_ops(*x.shape[-2:], x.device, dt)
    pre = _mm(_mm(uh, x.to(dt), level), uw.T, level)
    gu = _mm(_mm(dh.T, g.to(dt), level), dw, level)
    m = act_grad(pre, act) * gu
    if dx_w_first:
        dx = _mm(uh.T, _mm(m, uw, level), level)
    else:
        dx = _mm(_mm(uh.T, m, level), uw, level)
    return dx.to(x.dtype)


def filtered_act_plane_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                                 act: str = "silu",
                                 level: str = None) -> torch.Tensor:
    """K5b's plain version at ``level`` (default: the current one): at
    'highest' the exact six products; at a reduced level ``_bwd_rule``'s
    order (dx's W side first)."""
    level = level or af_precision()
    return _bwd_plain(x, g, act, level, level != "highest")


def filtered_act_banded_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                                  act: str = "silu",
                                  level: str = None) -> torch.Tensor:
    """K2's plain version at ``level`` (default: the current one), in
    ``_bwd_spatial``'s order: H side first in all three filter pairs."""
    return _bwd_plain(x, g, act, level or af_precision(), False)


def _level_at(H: int, W: int, level: str = None) -> str:
    """The level a filtered-activation kernel runs an H × W plane at:
    ``level`` (default: the current one), 'highest' above LEVEL_MAX."""
    return "highest" if max(H, W) > LEVEL_MAX else level or af_precision()


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
    """(D_h^T, D_w, U_w, U_h^T), contiguous float32 on ``device``: the
    backward kernels' other operators; the plane forward takes D_h^T and
    U_h^T, its k-major forms of D_h and U_h."""
    key = ("bwd", H, W, torch.device(device))
    if key not in _KERNEL_OPS:
        ops = (_downsample_op(2 * H, 2).T, _downsample_op(2 * W, 2),
               _upsample_op(W, 2), _upsample_op(H, 2).T)
        with torch.inference_mode(False):  # see ideal_lpf._op
            _KERNEL_OPS[key] = tuple(torch.from_numpy(o.copy()).to(device)
                                     for o in ops)
    return _KERNEL_OPS[key]


def _check(x: torch.Tensor, act: str, banded: bool, name: str,
           dtypes: tuple = (torch.float32, torch.bfloat16)):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CPU or CUDA tensors only, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: {' or '.join(map(str, dtypes))} only on "
                        f"the card, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{name}: expects NCHW, got shape {tuple(x.shape)}")
    H, W = x.shape[-2:]
    if H % 4 or W % 4 or (max(H, W) > PLANE_MAX) != banded:
        side = "above" if banded else "up to"
        raise ValueError(f"{name}: takes H, W % 4 == 0 with max(H, W) "
                         f"{side} {PLANE_MAX}, got {H}x{W}")
    if act not in ACT_CODES:
        raise ValueError(f"{name}: unknown activation {act!r}")


def _contiguous16(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, at a 16-byte boundary: the kernels read it in 16-byte
    chunks."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


# the plane kernels' (K5, K5b) launch: the threads a block they are built
# for (256 runs two blocks an SM where shared memory allows, 512 one), the
# SMs, and the shared memory a block may take with two blocks an SM (228 KB
# an SM, 1 KB of it reserved for each block)
K5_THREADS = (256, 512)
NUM_SMS = 132
SMEM_SM_BYTES = 233472
SMEM_BLOCK_RESERVED = 1024
SMEM_TWO_BLOCKS_BYTES = SMEM_SM_BYTES // 2 - SMEM_BLOCK_RESERVED
# the micro-tiles (rows, columns), by the kernel's bit for a product
# (filtered_tile.cuh::product)
K5_TILES = ((8, 4), (4, 4))
# a product at least this deep takes 8×4 micro-tiles with half of the
# block's threads busy; a shallower one only with all of them
K5_DEEP = 64
# two 256-thread blocks on an SM overlap each other's barriers and copies,
# which the plan's rounds do not count: their waves are weighted by this
K5_TWO_BLOCKS = 0.9
# K5b's micro-tiles: a product at least this deep takes 8×4 with half of
# the block's threads busy, and its fourth product (mᵀ), whose epilogue
# reads C and takes act′, 4×4 always. On an H100 (plane_sweep.py --bwd,
# PERF.md §6) that picked the quickest choice at K5b's three chip_smoke
# shapes up to 32 px and came within 0.5 % of it at the two 64 px ones;
# K5's rule (K5_DEEP, 8×4 for mᵀ) ran 2-4 % slower than the quickest
K5B_DEEP = 32
K5B_SMALL = (3,)


class PlanePlan(NamedTuple):
    """How a plane kernel (``filtered_act_plane``'s, or
    ``filtered_act_plane_bwd``'s) is launched: P planes a block, each
    product's micro-tile (rows, columns), the threads a block and the
    shared bytes a block."""
    planes_per_block: int
    tiles: tuple
    threads: int
    smem_bytes: int

    @property
    def tile_codes(self) -> int:
        """The kernel's ``tiles`` argument: bit i set gives product i + 1
        4×4 tiles."""
        return sum(K5_TILES.index(t) << i for i, t in enumerate(self.tiles))


def plane_products(H: int, W: int) -> tuple:
    """(rows, columns, depth) of the plane kernel's four results: tᵀ, hiᵀ,
    t and out."""
    return ((W, 2 * H, H), (2 * W, 2 * H, W), (2 * H, W, 2 * W),
            (H, W, 2 * H))


def _row_pad(n: int) -> int:  # filtered_tile.cuh::row_pad
    return n + 4 if n % 8 == 0 else n


def plane_smem_bytes(H: int, W: int, ppb: int) -> int:
    """Shared memory of a plane block (filtered_act.cu::PlaneLayout): two
    operator buffers of 2·max(H, W)² floats, and per plane the 2W × 2H hiᵀ
    and one buffer for tᵀ and t, rows padded by ``_row_pad``."""
    op = 2 * max(H, W) ** 2
    big = 2 * W * _row_pad(2 * H)
    small = max(W * _row_pad(2 * H), 2 * H * _row_pad(W))
    return 4 * (2 * op + ppb * (big + small))


def plane_bwd_products(H: int, W: int) -> tuple:
    """(rows, columns, depth) of the plane backward's six results: tᵀ,
    preᵀ, uᵀ, mᵀ, s and dx (filtered_act.cu, K5b)."""
    return ((W, 2 * H, H), (2 * W, 2 * H, W), (W, 2 * H, H),
            (2 * W, 2 * H, W), (2 * H, W, 2 * W), (H, W, 2 * H))


def plane_bwd_smem_bytes(H: int, W: int, ppb: int) -> int:
    """Shared memory of a plane backward block
    (filtered_act.cu::PlaneBwdLayout): the forward's, its per-plane
    buffers holding preᵀ (then mᵀ) and tᵀ (then uᵀ, then s), and the
    staged g (H × W) a plane."""
    return plane_smem_bytes(H, W, ppb) + 4 * ppb * H * W


def _plane_cost(products: tuple, smem: int, nplanes: int, ppb: int,
                threads: int):
    """The plans' model of a launch's time: waves of blocks (a wave is one
    block an SM, or two at 256 threads where they fit, weighted by
    K5_TWO_BLOCKS) times a block's rounds of 4×4 tiles of its
    ``products`` (rows, columns, depth) over its threads, each round
    weighted by its product's depth. None where the block's ``smem``
    bytes exceed SMEM_MAX_BYTES."""
    if smem > SMEM_MAX_BYTES:
        return None
    per_sm = 2 if threads == 256 and smem <= SMEM_TWO_BLOCKS_BYTES else 1
    blocks = -(-nplanes // ppb)
    waves = -(-blocks // (NUM_SMS * per_sm))
    rounds = sum(k * -(-ppb * (r * c // 16) // threads)
                 for r, c, k in products)
    return waves * rounds * (K5_TWO_BLOCKS if per_sm == 2 else 1.0)


def _plane_launch(H: int, W: int, nplanes: int, products, smem_bytes,
                  deep: int = K5_DEEP, small: tuple = ()) -> PlanePlan:
    """A plane kernel's launch plan, for its ``products(H, W)`` and
    ``smem_bytes(H, W, P)``: ``plane_plan``'s rule, a product ``deep`` or
    deeper taking 8×4 tiles with half of the threads busy, the products
    indexed in ``small`` 4×4 tiles always."""
    if nplanes == 0:
        nplanes = 1
    # the largest P with ceil(nplanes / P) >= NUM_SMS, or 1
    grid = max(1, -(-nplanes // (NUM_SMS - 1)) - 1)
    best = None
    for threads in K5_THREADS:
        for ppb in range(1, min(grid, nplanes) + 1):
            cost = _plane_cost(products(H, W), smem_bytes(H, W, ppb),
                               nplanes, ppb, threads)
            if cost is None:
                break
            if best is None or cost < best[0] or (cost == best[0]
                                                  and threads > best[2]):
                best = (cost, ppb, threads)
    _, ppb, threads = best
    tiles = []
    for i, (rows, cols, depth) in enumerate(products(H, W)):
        need = threads // 2 if depth >= deep else threads
        wide = (rows % 8 == 0 and i not in small
                and ppb * (rows // 8) * (cols // 4) >= need)
        tiles.append(K5_TILES[0] if wide else K5_TILES[1])
    return PlanePlan(ppb, tuple(tiles), threads, smem_bytes(H, W, ppb))


@functools.lru_cache(maxsize=None)
def plane_plan(H: int, W: int, nplanes: int) -> PlanePlan:
    """The plane kernel's launch plan. P and the threads a block minimise
    ``_plane_cost`` (on a tie the smaller P, then 512 threads), with P at
    most the plane count, the block within SMEM_MAX_BYTES, and the grid at
    least one wave of NUM_SMS blocks where the planes allow it. Each
    product then takes 8×4 tiles where they divide its result and keep the
    block's threads busy (half of them for a product K5_DEEP deep or more),
    else 4×4. The model, the rule and both constants were fitted to timings
    of every block size, P and micro-tile at the models' plane sizes on an
    H100 (``scripts/plane_sweep.py``; PERF.md §6). 0 planes get the
    one-plane plan (the wrapper launches nothing for them)."""
    return _plane_launch(H, W, nplanes, plane_products, plane_smem_bytes)


@functools.lru_cache(maxsize=None)
def plane_bwd_plan(H: int, W: int, nplanes: int) -> PlanePlan:
    """The plane backward kernel's (K5b) launch plan: ``plane_plan``'s
    model and rule over its six products (``plane_bwd_products``) and its
    block (``plane_bwd_smem_bytes``), with its own micro-tile constants
    (K5B_DEEP, K5B_SMALL), fitted to timings of every block size, P and
    micro-tile at its chip_smoke shapes on an H100
    (``scripts/plane_sweep.py --bwd``; PERF.md §6). 0 planes get the
    one-plane plan."""
    return _plane_launch(H, W, nplanes, plane_bwd_products,
                         plane_bwd_smem_bytes, K5B_DEEP, K5B_SMALL)


# -- the plane kernels' bf16 variants (the reduced levels) -----------------

# threads a block of K5b's bf16 variant: 8 warps of mma.sync
MMA_THREADS = 256
# K5's bf16 blocks an SM at most, by the registers its launch bounds allow
# (filtered_act.cu::mma_plane_threads: at 'high' one block takes the
# register file; at 'default' two of 256 threads, 128 registers a thread)
K5_MMA_BLOCKS = {"high": 1, "default": 2}
# what an iteration of a K5 bf16 block costs beside its products (its
# barriers, x's split and the group's copies), in 16-deep steps of one
# 16 × 16 tile, and the time of an SM's iteration with two blocks on it
# against one alone
K5_MMA_ITER = 8.0
K5_MMA_TWO_BLOCKS = 1.2


def _pad16(n: int) -> int:  # filtered_mma.cuh::pad16
    return -(-n // 16) * 16


def mma_ld(n: int) -> int:
    """The row stride, in bf16, of a split piece of n columns
    (filtered_mma.cuh::mma_ld): padded to 16, plus 8."""
    return _pad16(n) + 8


def mma_piece(rows: int, cols: int) -> int:
    """bf16 elements of one piece, hi or lo, of rows × cols
    (filtered_mma.cuh::mma_piece)."""
    return _pad16(rows) * mma_ld(cols)


def mma_buf(rows: int, cols: int) -> int:
    """bf16 elements of a split buffer, hi and lo pieces of rows × cols
    (filtered_mma.cuh::mma_buf)."""
    return 2 * mma_piece(rows, cols)


def plane_mma_smem_bytes(H: int, W: int, planes: int, level: str = "high",
                         x_bytes: int = 4) -> int:
    """Shared memory of a K5 bf16 block (filtered_act.cu::MmaPlaneLayout):
    the four operators' pieces, resident, and per plane of an iteration
    x's pieces, t's (t₂ over it) and x as it arrives (``x_bytes`` an
    element). Each operand holds hi and lo pieces at 'high', hi alone at
    'default'."""
    pieces = 2 if level == "high" else 1
    ops = (mma_piece(H, 2 * H) + mma_piece(W, 2 * W) + mma_piece(2 * W, W)
           + mma_piece(2 * H, H))
    per = mma_piece(H, W) + mma_piece(2 * H, W)
    return 2 * pieces * (ops + planes * per) + planes * H * W * x_bytes


def plane_mma_bwd_smem_bytes(H: int, W: int, ppb: int) -> int:
    """Shared memory of a K5b bf16 block (filtered_act.cu::
    MmaPlaneBwdLayout): two operator buffers of the largest operator's
    split blob, and per plane mᵀ (x and g staged in it), a buffer for tᵀ
    then s, and uᵀ."""
    op = max(mma_buf(H, 2 * H), mma_buf(W, 2 * W), mma_buf(2 * W, W),
             mma_buf(2 * H, H))
    big = max(mma_buf(2 * W, 2 * H), 2 * mma_buf(H, W))
    small = max(mma_buf(W, 2 * H), mma_buf(2 * H, W))
    return 2 * (2 * op + ppb * (big + small + mma_buf(W, 2 * H)))


def plane_mma_products(H: int, W: int) -> tuple:
    """(rows, columns, depth) of K5b's bf16 products: tᵀ, uᵀ, the fused
    pre-activation and cotangent over one tile as two, s, dx."""
    return ((W, 2 * H, H), (W, 2 * H, H), (2 * W, 2 * H, W),
            (2 * W, 2 * H, W), (2 * H, W, 2 * W), (H, W, 2 * H))


def _mma_cost(products: tuple, smem: int, nplanes: int, ppb: int):
    """K5b's model: waves of blocks times a block's rounds of 16×16 warp
    tiles over its 8 warps, each round weighted by its product's padded
    depth; None over SMEM_MAX_BYTES."""
    if smem > SMEM_MAX_BYTES:
        return None
    per_sm = 2 if smem <= SMEM_TWO_BLOCKS_BYTES else 1
    waves = -(-(-(-nplanes // ppb)) // (NUM_SMS * per_sm))
    warps = MMA_THREADS // 32
    rounds = sum(_pad16(k) // 16
                 * -(-ppb * (_pad16(r) // 16) * (_pad16(c) // 16) // warps)
                 for r, c, k in products)
    return waves * rounds * (K5_TWO_BLOCKS if per_sm == 2 else 1.0)


@functools.lru_cache(maxsize=None)
def plane_mma_bwd_plan(H: int, W: int, nplanes: int) -> PlanePlan:
    """The launch plan of K5b's bf16 variant: P planes a block minimising
    ``_mma_cost`` (on a tie the smaller P), with P at most the plane
    count, the block within SMEM_MAX_BYTES and the grid at least one wave
    where the planes allow it, as ``plane_plan`` picks P; 256 threads and
    no micro-tiles (``tiles`` empty). 0 planes get the one-plane plan."""
    n = max(nplanes, 1)
    grid = max(1, -(-n // (NUM_SMS - 1)) - 1)
    best = None
    for ppb in range(1, min(grid, n) + 1):
        cost = _mma_cost(plane_mma_products(H, W),
                         plane_mma_bwd_smem_bytes(H, W, ppb), n, ppb)
        if cost is None:
            break
        if best is None or cost < best[0]:
            best = (cost, ppb)
    ppb = best[1]
    return PlanePlan(ppb, (), MMA_THREADS,
                     plane_mma_bwd_smem_bytes(H, W, ppb))


def k5_mma_threads(level: str, W: int) -> int:
    """Threads a block of K5's bf16 variant (filtered_act.cu::
    mma_plane_threads): 256 at 'default' (two blocks an SM, 128 registers
    a thread); at 'high' one block an SM of 512 threads up to 16 px wide,
    384 up to 32, else 256."""
    if level == "default" or _pad16(W) > 32:
        return 256
    return 384 if _pad16(W) > 16 else 512


class MmaPlan(NamedTuple):
    """How K5's bf16 variant is launched: ``grid`` persistent blocks of
    ``k5_mma_threads``, ``per_sm`` of them an SM, each walking groups of
    ``planes`` planes (an iteration) with ``smem_bytes`` of shared
    memory."""
    planes: int
    grid: int
    per_sm: int
    smem_bytes: int


def _strip_rounds(strips: int, blocks: int, depth: int, warps: int) -> int:
    """A K5 strip product's rounds over the block's ``warps``, in 16-deep
    steps of a 16 × 16 tile (filtered_mma.cuh::strip_product: a warp
    item is a 16-row strip and ``per`` 16-column blocks, all of the
    strip's or the next smaller divisor of their count while that leaves
    warps idle)."""
    per = next((d for d in range(blocks, 0, -1) if blocks % d == 0
                and strips * (blocks // d) >= warps), 1)
    return -(-strips * (blocks // per) // warps) * per * depth


def plane_mma_rounds(H: int, W: int, planes: int, level: str) -> int:
    """A K5 bf16 iteration's products over ``planes`` planes at
    ``level``, in rounds of the block's warps (16-deep steps of a 16 × 16
    tile): t = U_h·x and out = D_h·t₂ by strips, and the middle pair a
    16-row strip of the 2H side a warp, each of its 2W / 16 chunks one hi
    tile over W and one step of t₂'s blocks."""
    warps = k5_mma_threads(level, W) // 32
    h2, h, w, w2 = (_pad16(n) // 16 for n in (2 * H, H, W, 2 * W))
    return (_strip_rounds(planes * h2, w, h, warps)
            + _strip_rounds(planes * h, w, h2, warps)
            + -(-planes * h2 // warps) * w2 * 2 * w)


def _mma_per_sm(smem: int, level: str) -> int:
    """K5's bf16 blocks an SM: by shared memory, within K5_MMA_BLOCKS."""
    return min(K5_MMA_BLOCKS[level],
               SMEM_SM_BYTES // (smem + SMEM_BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)
def plane_mma_plan(H: int, W: int, nplanes: int, level: str = "high",
                   x_bytes: int = 4) -> MmaPlan:
    """The launch plan of K5's bf16 variant at ``level`` for an x of
    ``x_bytes`` an element. P planes an iteration minimise the modelled
    time, ceil(groups / (NUM_SMS · per_sm)) iterations of
    (``plane_mma_rounds`` + K5_MMA_ITER), weighted by
    K5_MMA_TWO_BLOCKS at two blocks an SM (on a tie the smaller P), with
    the block within SMEM_MAX_BYTES; the grid is the groups, at most
    per_sm · NUM_SMS blocks. The model and its two constants were fitted
    to timings of every P and 1 or 2 blocks an SM at K5's chip_smoke
    shapes on an H100 (``scripts/plane_sweep.py --level high|default``;
    PERF.md §6): its pick was the quickest or within 1 % of it at each.
    0 planes get the one-plane plan."""
    n = max(nplanes, 1)
    best = None
    for planes in range(1, n + 1):
        smem = plane_mma_smem_bytes(H, W, planes, level, x_bytes)
        if smem > SMEM_MAX_BYTES:
            break
        per_sm = _mma_per_sm(smem, level)
        groups = -(-n // planes)
        cost = (-(-groups // (NUM_SMS * per_sm))
                * (plane_mma_rounds(H, W, planes, level) + K5_MMA_ITER)
                * (K5_MMA_TWO_BLOCKS if per_sm == 2 else 1.0))
        if best is None or cost < best[0]:
            best = (cost, planes, per_sm, smem)
    _, planes, per_sm, smem = best
    return MmaPlan(planes, min(-(-n // planes), per_sm * NUM_SMS), per_sm,
                   smem)


def _mma_blob(op: np.ndarray) -> torch.Tensor:
    """An operator's split blob as the bf16 plane kernels stage it: (hi,
    lo) bf16 pieces of ``split_bf16``, zero-padded to pad16(rows) ×
    mma_ld(cols)."""
    rows, cols = op.shape
    blob = torch.zeros((2, _pad16(rows), mma_ld(cols)), dtype=torch.bfloat16)
    hi, lo = split_bf16(torch.from_numpy(np.ascontiguousarray(op)))
    blob[0, :rows, :cols] = hi
    blob[1, :rows, :cols] = lo
    return blob


def _mma_blobs(H: int, W: int, device, bwd: bool) -> tuple:
    """The split blobs of the bf16 plane kernels' operators, each in the
    k-major form its product reads: K5's U_hᵀ, U_wᵀ, D_wᵀ, D_hᵀ; K5b's
    U_hᵀ, D_h, U_wᵀ, D_w, U_w, U_h. Split once on the host and cached; one
    blob serves both reduced levels ('default' reads only its hi piece)."""
    key = ("mma", bwd, H, W, torch.device(device))
    if key not in _KERNEL_OPS:
        uh, uw = _upsample_op(H, 2), _upsample_op(W, 2)
        dh, dw = _downsample_op(2 * H, 2), _downsample_op(2 * W, 2)
        ops = ((uh.T, dh, uw.T, dw, uw, uh) if bwd
               else (uh.T, uw.T, dw.T, dh.T))
        with torch.inference_mode(False):  # see ideal_lpf._op
            _KERNEL_OPS[key] = tuple(_mma_blob(o).to(device) for o in ops)
    return _KERNEL_OPS[key]


def _variant(name: str, level: str, dtype) -> tuple:
    """(C entry suffix, LAUNCHES key) of a kernel's variant for
    ``level`` and x's ``dtype``: '_f32' / 'name' at 'highest', '_bf16' /
    'name:level' at a reduced level, each with '_xbf16' / '/bf16' after it
    for a bfloat16 x."""
    suffix, key = ("_f32", name) if level == "highest" else (
        "_bf16", f"{name}:{level}")
    if dtype == torch.bfloat16:
        return suffix + "_xbf16", key + "/bf16"
    return suffix, key


def _plane_forward_mma(x: torch.Tensor, act: str, level: str):
    x = _contiguous16(x)
    out = torch.empty_like(x)
    H, W = x.shape[-2:]
    nplanes = x.shape[0] * x.shape[1]
    if nplanes == 0:
        return out
    plan = plane_mma_plan(H, W, nplanes, level, x.element_size())
    suffix, key = _variant("filtered_act_plane", level, x.dtype)
    err = getattr(kernels.library("filtered_act"),
                  f"filtered_act_plane{suffix}")(
        x.data_ptr(), out.data_ptr(),
        *(o.data_ptr() for o in _mma_blobs(H, W, x.device, False)), nplanes,
        H, W, plan.planes, plan.grid, LEVEL_PASSES[level], ACT_CODES[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return out


def _plane_forward(x: torch.Tensor, act: str, level: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return filtered_act_plane_plain(x, act, level)
    _check(x, act, False, "filtered_act_plane")
    if level != "highest":
        return _plane_forward_mma(x, act, level)
    x = _contiguous16(x)
    out = torch.empty_like(x)
    H, W = x.shape[-2:]
    _, uwT, _, dwT = _kernel_ops(H, W, x.device)
    dhT, _, _, uhT = _kernel_bwd_ops(H, W, x.device)
    nplanes = x.shape[0] * x.shape[1]
    if nplanes == 0:
        return out
    plan = plane_plan(H, W, nplanes)
    suffix, key = _variant("filtered_act_plane", level, x.dtype)
    err = getattr(kernels.library("filtered_act"),
                  f"filtered_act_plane{suffix}")(
        x.data_ptr(), out.data_ptr(), uhT.data_ptr(), uwT.data_ptr(),
        dwT.data_ptr(), dhT.data_ptr(), nplanes, H, W,
        plan.planes_per_block, plan.tile_codes, plan.threads, ACT_CODES[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return out


def _check_bwd(x, g, act, banded, name):
    _check(x, act, banded, name)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"{name}: g must match x in shape, device and "
                         "dtype")


def _plane_bwd_ops(H: int, W: int, device) -> tuple:
    """(U_hᵀ, U_wᵀ, D_h, D_w, U_w, U_h): the plane backward's operators in
    the order of its products, each in the k-major form its product
    reads."""
    uh, uwT, dh, _ = _kernel_ops(H, W, device)
    _, dw, uw, uhT = _kernel_bwd_ops(H, W, device)
    return uhT, uwT, dh, dw, uw, uh


def filtered_act_plane_bwd(x: torch.Tensor, g: torch.Tensor,
                           act: str = "silu",
                           level: str = None) -> torch.Tensor:
    """The VJP of ``filtered_act_plane`` at x for the cotangent g (K5b), at
    ``level`` (default: the current one). On the card x and g are read in
    16-byte chunks, so a strided or misaligned one (a cotangent from
    autograd may be either) is copied first."""
    level = level or af_precision()
    if x.device.type == "cpu":
        return filtered_act_plane_bwd_plain(x, g, act, level)
    _check_bwd(x, g, act, False, "filtered_act_plane_bwd")
    x, g = _contiguous16(x), _contiguous16(g)
    dx = torch.empty_like(x)
    nplanes = x.shape[0] * x.shape[1]
    if nplanes == 0:
        return dx
    H, W = x.shape[-2:]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    suffix, key = _variant("filtered_act_plane_bwd", level, x.dtype)
    entry = getattr(kernels.library("filtered_act"),
                    f"filtered_act_plane_bwd{suffix}")
    if level != "highest":
        plan = plane_mma_bwd_plan(H, W, nplanes)
        err = entry(x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    *(o.data_ptr() for o in _mma_blobs(H, W, x.device,
                                                       True)),
                    nplanes, H, W, plan.planes_per_block,
                    LEVEL_PASSES[level], ACT_CODES[act], stream)
    else:
        plan = plane_bwd_plan(H, W, nplanes)
        err = entry(x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    *(o.data_ptr() for o in _plane_bwd_ops(H, W, x.device)),
                    nplanes, H, W, plan.planes_per_block, plan.tile_codes,
                    plan.threads, ACT_CODES[act], stream)
    kernels.check(err, key)
    kernels.LAUNCHES[key] += 1
    return dx


class _FilteredActPlane(torch.autograd.Function):
    """Saves x, not the 4x pre-activation (as ``_bwd_rule`` does), and the
    forward's precision level for the backward."""

    @staticmethod
    def forward(ctx, x, act):
        ctx.act, ctx.level = act, af_precision()
        ctx.save_for_backward(x)
        return _plane_forward(x, act, ctx.level)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return filtered_act_plane_bwd(x, g, ctx.act, ctx.level), None


def filtered_act_plane(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Kernel for planes up to 64 px, differentiable through
    ``filtered_act_plane_bwd``."""
    return _FilteredActPlane.apply(x, act)


# -- the banded chains (K1, K2): launches of one tiled GEMM ---------------

# the tiled GEMM's block tile sides, by the kernel's bit for a product
# (filtered_gemm.cuh): 128×128, or 64×64 for a launch short of a wave
GEMM_TILES = (128, 64)


def banded_products(H: int, W: int, planes: int) -> tuple:
    """(M, N, K, batch) of the banded forward's four GEMMs for a chunk of
    ``planes`` planes: t = x·U_wᵀ, hi = act(U_h·t), lo = hi·D_wᵀ and
    out = D_h·lo."""
    return ((planes * H, 2 * W, W, 1), (2 * H, 2 * W, H, planes),
            (planes * 2 * H, W, 2 * W, 1), (H, W, 2 * H, planes))


def banded_bwd_products(H: int, W: int, planes: int) -> tuple:
    """(M, N, K, batch) of the banded backward's six GEMMs for a chunk of
    ``planes`` planes: t = x·U_wᵀ, pre = U_h·t, v = g·D_w,
    m = act′(pre) ⊙ (D_hᵀ·v), s = m·U_w and dx = U_hᵀ·s."""
    return ((planes * H, 2 * W, W, 1), (2 * H, 2 * W, H, planes),
            (planes * H, 2 * W, W, 1), (2 * H, 2 * W, H, planes),
            (planes * 2 * H, W, 2 * W, 1), (H, W, 2 * H, planes))


def banded_scratch_bytes(H: int, W: int, planes: int) -> int:
    """Either chain's scratch for a chunk: 2·H·W floats a plane (the
    forward's t and then lo; the backward's t, v and then s) and 4·H·W
    (the forward's hi; the backward's pre and then m)."""
    return 4 * 6 * H * W * planes


def gemm_blocks(M: int, N: int, batch: int, tile: int) -> int:
    """Blocks of a GEMM launch in ``tile`` × ``tile`` block tiles."""
    return -(-M // tile) * -(-N // tile) * batch


class BandedChunk(NamedTuple):
    """One call of a banded chain's C entry: planes ``start`` to
    ``start + planes`` and each product's block tile side."""
    start: int
    planes: int
    tiles: tuple

    @property
    def tile_codes(self) -> int:
        """The C entry's ``tiles`` argument: bit i set gives product i + 1
        the 64×64 tile."""
        return sum(GEMM_TILES.index(t) << i for i, t in enumerate(self.tiles))


def _chunk_planes(nplanes: int, per: int) -> list:
    """(start, planes) of as few chunks of at most ``per`` planes as cover
    ``nplanes`` in order, their plane counts within one of each other."""
    n = -(-nplanes // per)
    base, extra = divmod(nplanes, n)
    starts = np.cumsum([0] + [base + (i < extra) for i in range(n)])
    return [(int(a), int(b - a)) for a, b in zip(starts[:-1], starts[1:])]


@functools.lru_cache(maxsize=None)
def banded_plan(H: int, W: int, nplanes: int, cap: int,
                products=banded_products) -> tuple:
    """A GEMM chain's chunks (``BandedChunk``), in order, covering every
    plane once: as few chunks as keep each chunk's scratch within ``cap``
    bytes (at least one plane a chunk, whatever its size), their plane
    counts within one of each other. Each of the chain's ``products``
    (``banded_products``: K1's f32 chain; ``banded_bwd_products``: K2's)
    takes the 128×128 tile unless that gives a grid short of a wave of
    NUM_SMS blocks, then the 64×64 tile. No chunks for 0 planes. K1's and
    K2's level chains have a plan of their own, ``banded_mma_plan``."""
    if nplanes == 0:
        return ()
    per = max(1, cap // banded_scratch_bytes(H, W, 1))
    return tuple(
        BandedChunk(start, planes, tuple(
            GEMM_TILES[0] if gemm_blocks(M, N, b, GEMM_TILES[0]) >= NUM_SMS
            else GEMM_TILES[1]
            for M, N, _, b in products(H, W, planes)))
        for start, planes in _chunk_planes(nplanes, per))


# -- K1's and K2's level chains: two fused launches (filtered_banded_mma.cu)

# the strip rows a block of K1's up launch (products 1 and 2, on the 2H
# side), of K2's (products 1 to 4, on the 2H side, t's and v's strips in
# shared memory) and of their down launch (K1's products 3 and 4, K2's 5
# and 6, on the H side): 64 where that block fits shared memory, else 32
K1_UP_ROWS = 64
K2_UP_ROWS = (64, 32)
K1_DOWN_ROWS = (64, 32)
# the columns a block's result takes at a time, and each launch's slab ring
# (filtered_banded_mma.cu::UpCfg, DownCfg): (depth, stages)
K1_COLS = 128
K1_UP_RING, K1_DOWN_RING = (16, 4), (32, 3)
# a chunk's hi pieces (K1's scratch; K2's: m's) stay under this, or hold
# one plane
BANDED_HI_BYTES = 256 * 2 ** 20


def _level_pieces(level: str) -> int:
    """bf16 pieces of a split operand at ``level``: hi and lo at 'high',
    hi alone at 'default'."""
    return 2 if level == "high" else 1


def banded_mma_smem_bytes(W: int, level: str, rows: int, down: bool,
                          x_bytes: int = 4, strips: int = 1) -> int:
    """Shared memory of a block of K1's or K2's up (or ``down``) launch at
    ``level`` with strips of ``rows`` rows (filtered_banded_mma.cu::
    Cfg::smem): ``strips`` strips' pieces (t's, and in K2's up launch v's,
    W wide; lo's or s's, 2W wide) and the launch's ring of slabs, each a
    k-major A slab (``rows`` wide), a B slab (K1_COLS wide) and, in an up
    launch, x's (g's) raw slab (``x_bytes`` an element)."""
    pieces = _level_pieces(level)
    depth, stages = K1_DOWN_RING if down else K1_UP_RING
    stage = 2 * pieces * depth * ((rows + 8) + (K1_COLS + 8))
    if not down:
        stage += depth * K1_COLS * x_bytes
    return (2 * strips * pieces * rows * mma_ld(2 * W if down else W)
            + stages * stage)


def banded_mma_down_rows(W: int, level: str) -> int:
    """The down launch's strip rows: the first of K1_DOWN_ROWS whose block
    fits SMEM_MAX_BYTES (32 at 'high' once 2W passes 512 px)."""
    return next(r for r in K1_DOWN_ROWS
                if banded_mma_smem_bytes(W, level, r, True) <= SMEM_MAX_BYTES)


def banded_mma_up_rows(W: int, level: str, bwd: bool = False) -> int:
    """The up launch's strip rows: K1_UP_ROWS for K1; for K2 the first of
    K2_UP_ROWS whose block, t's and v's strips and the ring, fits
    SMEM_MAX_BYTES (32 at 'high' once W passes 272 px)."""
    if not bwd:
        return K1_UP_ROWS
    return next(r for r in K2_UP_ROWS
                if banded_mma_smem_bytes(W, level, r, False, strips=2)
                <= SMEM_MAX_BYTES)


def banded_mma_scratch_bytes(H: int, W: int, planes: int,
                             level: str) -> int:
    """K1's or K2's level chain's scratch for a chunk: hi's (K2: m's) bf16
    pieces, 4·H·W elements a plane and piece (8·H·W bytes at 'default',
    16·H·W at 'high'); t and lo (K2: t, v, pre and s) stay on chip."""
    return 2 * 4 * H * W * planes * _level_pieces(level)


@functools.lru_cache(maxsize=None)
def banded_mma_plan(H: int, W: int, nplanes: int, level: str, cap: int,
                    bwd: bool = False) -> tuple:
    """K1's (``bwd``: K2's) level chain's chunks (``BandedChunk``), in
    order, covering every plane once: as few chunks as keep each chunk's
    hi (K2: m) pieces within ``cap`` bytes (``banded_mma_scratch_bytes``;
    at least one plane a chunk), their plane counts within one of each
    other; ``tiles`` holds the strip rows of its two launches
    (``banded_mma_up_rows`` and ``banded_mma_down_rows``). No chunks for 0
    planes."""
    if nplanes == 0:
        return ()
    per = max(1, cap // banded_mma_scratch_bytes(H, W, 1, level))
    rows = (banded_mma_up_rows(W, level, bwd),
            banded_mma_down_rows(W, level))
    return tuple(BandedChunk(start, planes, rows)
                 for start, planes in _chunk_planes(nplanes, per))


def _banded_ops(H: int, W: int, device) -> tuple:
    """(U_wᵀ, U_hᵀ, D_wᵀ, D_hᵀ): the forward chain's operators, the H-side
    ones in the k-major forms its batched products read."""
    _, uwT, _, dwT = _kernel_ops(H, W, device)
    dhT, _, _, uhT = _kernel_bwd_ops(H, W, device)
    return uwT, uhT, dwT, dhT


def _banded_bwd_ops(H: int, W: int, device) -> tuple:
    """(U_wᵀ, U_hᵀ, D_w, D_h, U_w, U_h): the backward chain's operators in
    the order of its products, the H-side ones (U_h, D_hᵀ, U_hᵀ) in the
    k-major forms its batched products read."""
    uh, uwT, dh, _ = _kernel_ops(H, W, device)
    _, dw, uw, uhT = _kernel_bwd_ops(H, W, device)
    return uwT, uhT, dw, dh, uw, uh


def _banded_mma_ops(H: int, W: int, device) -> tuple:
    """(U_hᵀ, U_wᵀ, D_hᵀ, D_wᵀ): the split blobs of K1's level chain's
    operators, K5's (``_mma_blobs``) in the order of its products."""
    uhT, uwT, dwT, dhT = _mma_blobs(H, W, device, False)
    return uhT, uwT, dhT, dwT


def _banded_mma_bwd_ops(H: int, W: int, device) -> tuple:
    """(U_hᵀ, D_h, U_wᵀ, D_w, U_w, U_h): the split blobs of K2's level
    chain's operators, K5b's (``_mma_blobs``), each in the k-major form its
    product reads, in the order its C entry takes them."""
    return _mma_blobs(H, W, device, True)


def _banded_entry(x, out, scratch, ops, chunk, act):
    """One chunk through the C entry ``filtered_act_banded_f32`` (its
    ``_xbf16`` twin for a bfloat16 x): the four GEMM launches on the
    current stream. x, out: the chunk's (P, H, W) planes, contiguous."""
    H, W = x.shape[-2:]
    suffix, _ = _variant("filtered_act_banded", "highest", x.dtype)
    err = getattr(kernels.library("filtered_act"),
                  f"filtered_act_banded{suffix}")(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        *(o.data_ptr() for o in ops), chunk.planes, H, W, chunk.tile_codes,
        ACT_CODES[act], torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "filtered_act_banded")


def _banded_bwd_entry(x, g, dx, scratch, ops, chunk, act):
    """One chunk through the C entry ``filtered_act_banded_bwd_f32`` (its
    ``_xbf16`` twin for bfloat16 x and g): the six GEMM launches on the
    current stream. x, g, dx: the chunk's (P, H, W) planes, contiguous."""
    H, W = x.shape[-2:]
    suffix, _ = _variant("filtered_act_banded_bwd", "highest", x.dtype)
    err = getattr(kernels.library("filtered_act"),
                  f"filtered_act_banded_bwd{suffix}")(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        *(o.data_ptr() for o in ops), chunk.planes, H, W, chunk.tile_codes,
        ACT_CODES[act], torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "filtered_act_banded_bwd")


def _banded_mma_entry(x, out, scratch, ops, chunk, act, level):
    """One chunk through ``filtered_act_banded_bf16`` (its ``_xbf16`` twin
    for a bfloat16 x) at ``level``: K1's up and down launches on the
    current stream, hi's pieces in the bf16 scratch."""
    H, W = x.shape[-2:]
    suffix, _ = _variant("filtered_act_banded", level, x.dtype)
    err = getattr(kernels.library("filtered_banded_mma"),
                  f"filtered_act_banded{suffix}")(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        *(o.data_ptr() for o in ops), chunk.planes, H, W, chunk.tiles[1],
        LEVEL_PASSES[level], ACT_CODES[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, f"filtered_act_banded:{level}")


def _banded_mma_bwd_entry(x, g, dx, scratch, ops, chunk, act, level):
    """One chunk through ``filtered_act_banded_bwd_bf16`` (its ``_xbf16``
    twin for bfloat16 x and g) at ``level``: K2's up and down launches on
    the current stream, m's pieces in the bf16 scratch."""
    H, W = x.shape[-2:]
    suffix, _ = _variant("filtered_act_banded_bwd", level, x.dtype)
    err = getattr(kernels.library("filtered_banded_mma"),
                  f"filtered_act_banded_bwd{suffix}")(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        *(o.data_ptr() for o in ops), chunk.planes, H, W, *chunk.tiles,
        LEVEL_PASSES[level], ACT_CODES[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, f"filtered_act_banded_bwd:{level}")


# the f32 GEMM chains' products and operators, by backward
_GEMM_CHAINS = {False: (banded_products, _banded_ops),
                True: (banded_bwd_products, _banded_bwd_ops)}


def _banded_setup(H: int, W: int, nplanes: int, level: str,
                  bwd: bool) -> tuple:
    """(chunks, operators, scratch numel, scratch dtype) of a banded chain
    at ``level``: at a reduced level K1's or K2's level chain's
    (``banded_mma_plan``, its split blobs, hi's or m's bf16 pieces), at
    'highest' the f32 GEMM chain's (``banded_plan``, f32 operators, f32
    intermediates)."""
    if level != "highest":
        plan = banded_mma_plan(H, W, nplanes, level, BANDED_HI_BYTES, bwd)
        size = banded_mma_scratch_bytes(
            H, W, max((c.planes for c in plan), default=0), level) // 2
        return (plan, _banded_mma_bwd_ops if bwd else _banded_mma_ops, size,
                torch.bfloat16)
    products, ops = _GEMM_CHAINS[bwd]
    plan = banded_plan(H, W, nplanes, BANDED_SCRATCH_BYTES, products)
    size = banded_scratch_bytes(
        H, W, max((c.planes for c in plan), default=0)) // 4
    return plan, ops, size, torch.float32


def _banded_chain(x: torch.Tensor, act: str, entry,
                  g: torch.Tensor = None,
                  level: str = "highest") -> torch.Tensor:
    """x (NCHW, contiguous) through the banded forward's chunks or, given
    the cotangent g (x's shape, contiguous), the backward's, at ``level``,
    with one scratch buffer for the largest chunk (``_banded_setup``). Each
    chunk goes through ``entry`` (on the card ``_banded_entry``,
    ``_banded_bwd_entry`` or at a reduced level their bf16 entries) as
    entry(x, out, scratch, ops, chunk, act), or entry(x, g, dx, ...), on
    its (P, H, W) planes."""
    H, W = x.shape[-2:]
    out = torch.empty_like(x)
    ins = [t.view(-1, H, W) for t in (x, g) if t is not None]
    plan, ops, size, dtype = _banded_setup(H, W, ins[0].shape[0], level,
                                           g is not None)
    if not plan:
        return out
    ops = ops(H, W, x.device)
    scratch = torch.empty(size, device=x.device, dtype=dtype)
    outs = out.view(-1, H, W)
    for c in plan:
        rows = slice(c.start, c.start + c.planes)
        entry(*(t[rows] for t in ins), outs[rows], scratch, ops, c, act)
    return out


def filtered_gemm_plain(a: torch.Tensor, b: torch.Tensor, act=None,
                        a_kmajor: bool = False,
                        grad_at: torch.Tensor = None,
                        level: str = "highest") -> torch.Tensor:
    """The plain version of ``filtered_gemm``: act(A · B), or
    act′(grad_at) ⊙ (A · B), with ``level_matmul`` at ``level`` (exact
    sums at a reduced level), A = aᵀ where ``a_kmajor``."""
    out = _mm(a.transpose(-1, -2) if a_kmajor else a, b, level)
    if grad_at is not None:
        return act_grad(grad_at, act) * out
    return out if act is None else _ACTS[act](out)


def _gemm_dims(a: torch.Tensor, b: torch.Tensor, a_kmajor: bool) -> tuple:
    """(batch, M, N, K) of ``filtered_gemm``'s operands, or ValueError:
    3D, one batch, one K, M, N and K multiples of 4 (K positive)."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError("filtered_gemm: 3D operands only, got shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch, K, N = b.shape
    ka, M = (a.shape[1], a.shape[2]) if a_kmajor else (a.shape[2],
                                                       a.shape[1])
    if a.shape[0] != batch or ka != K:
        raise ValueError(f"filtered_gemm: a {tuple(a.shape)} (k-major: "
                         f"{a_kmajor}) does not match b {tuple(b.shape)} in "
                         "batch or K")
    if M % 4 or N % 4 or K % 4 or K == 0:
        raise ValueError("filtered_gemm: M, N and K must be multiples of 4 "
                         f"and K positive, got {M}, {N}, {K}")
    return batch, M, N, K


def filtered_gemm(a: torch.Tensor, b: torch.Tensor, act=None,
                  a_kmajor: bool = False, small: bool = False,
                  grad_at: torch.Tensor = None, level: str = None):
    """C[i] = act(A[i] · B[i]) through the banded chains' tiled GEMM kernel
    alone, in the 64×64 block tile where ``small`` (its card tests'
    entry); given ``grad_at`` (batch, M, N), C[i] = act′(grad_at[i]) ⊙
    (A[i] · B[i]) through the epilogue that reads C (K2's fourth product),
    grad_at left as it is. a: (batch, M, K), or (batch, K, M) where
    ``a_kmajor``; b: (batch, K, N); M, N, K multiples of 4. On the card:
    float32, unit stride along the last dim, the other strides multiples
    of 4 (a batch stride of 0: expanded from one matrix) and 16-byte
    aligned data, as the kernel's 16-byte copies read them; an empty
    result launches nothing. At ``level`` (default: the current one) other
    than 'highest' the products run on the kernel's bf16 variant."""
    level = level or af_precision()
    batch, M, N, K = _gemm_dims(a, b, a_kmajor)
    if grad_at is not None and (act is None
                                or tuple(grad_at.shape) != (batch, M, N)):
        raise ValueError("filtered_gemm: grad_at needs an activation and "
                         f"the result's shape {(batch, M, N)}")
    if a.device.type == "cpu":
        return filtered_gemm_plain(a, b, act, a_kmajor, grad_at, level)
    if a.device != b.device or a.dtype != torch.float32 or (
            b.dtype != torch.float32):
        raise ValueError("filtered_gemm: float32 operands on one device "
                         "only")
    for t in (a, b):
        if (t.stride(-1) != 1 or t.stride(0) % 4 or t.stride(1) % 4
                or t.data_ptr() % 16):
            raise ValueError("filtered_gemm: operands need a unit last "
                             "stride, other strides multiples of 4 and "
                             "16-byte aligned data")
    if grad_at is None:
        out = torch.empty((batch, M, N), device=a.device,
                          dtype=torch.float32)
    else:  # the kernel reads act′'s argument from C and writes over it
        out = grad_at.to(device=a.device, dtype=torch.float32,
                         memory_format=torch.contiguous_format, copy=True)
    if out.numel() == 0:
        return out
    args = (a.data_ptr(), a.stride(1), a.stride(0), int(a_kmajor),
            b.data_ptr(), b.stride(1), b.stride(0), out.data_ptr(), N, M * N,
            batch, M, N, K, int(small))
    tail = (-1 if act is None else ACT_CODES[act], int(grad_at is not None),
            torch.cuda.current_stream(a.device).cuda_stream)
    lib = kernels.library("filtered_act")
    if level == "highest":
        name, err = "filtered_gemm", lib.filtered_gemm_f32(*args, *tail)
    else:
        name = f"filtered_gemm:{level}"
        err = lib.filtered_gemm_bf16(*args, LEVEL_PASSES[level], *tail)
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


def _banded_forward(x: torch.Tensor, act: str, level: str) -> torch.Tensor:
    level = _level_at(*x.shape[-2:], level)
    if x.device.type == "cpu":
        if level == "highest":
            # the JAX package's chain: matmul up to 512 px, spectral above
            # (the level is the current one: only the Function calls this),
            # in float32 for a bf16 x, rounded once
            dt = torch.promote_types(x.dtype, torch.float32)
            return filtered_nonlinearity(x.to(dt), act).to(x.dtype)
        return filtered_act_banded_plain(x, act, level)
    _check(x, act, True, "filtered_act_banded")
    _, name = _variant("filtered_act_banded", level, x.dtype)
    if level == "highest":
        entry = _banded_entry
    else:
        entry = functools.partial(_banded_mma_entry, level=level)
    out = _banded_chain(_contiguous16(x), act, entry, level=level)
    if out.numel():
        kernels.LAUNCHES[name] += 1
    return out


def filtered_act_banded_bwd(x: torch.Tensor, g: torch.Tensor,
                            act: str = "silu",
                            level: str = None) -> torch.Tensor:
    """The VJP of ``filtered_act_banded`` at x for the cotangent g (K2), at
    ``level`` (default: the current one; 'highest' above LEVEL_MAX): on the
    card a chunk of planes takes the f32 chain's six GEMM launches at
    'highest', the level chain's two fused launches at a reduced level."""
    level = _level_at(*x.shape[-2:], level)
    if x.device.type == "cpu":
        return filtered_act_banded_bwd_plain(x, g, act, level)
    _check_bwd(x, g, act, True, "filtered_act_banded_bwd")
    _, name = _variant("filtered_act_banded_bwd", level, x.dtype)
    if level == "highest":
        entry = _banded_bwd_entry
    else:
        entry = functools.partial(_banded_mma_bwd_entry, level=level)
    dx = _banded_chain(_contiguous16(x), act, entry, _contiguous16(g),
                       level)
    if dx.numel():
        kernels.LAUNCHES[name] += 1
    return dx


class _FilteredActBanded(torch.autograd.Function):
    """Saves x, not the 4x pre-activation (as ``_bwd_spatial`` does), and
    the forward's precision level for the backward."""

    @staticmethod
    def forward(ctx, x, act):
        ctx.act, ctx.level = act, af_precision()
        ctx.save_for_backward(x)
        return _banded_forward(x, act, ctx.level)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return filtered_act_banded_bwd(x, g, ctx.act, ctx.level), None


def filtered_act_banded(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Kernel chain for planes with max(H, W) above 64 px (H, W % 4 == 0),
    differentiable through ``filtered_act_banded_bwd``."""
    return _FilteredActBanded.apply(x, act)


def filtered_act_fused(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Dispatcher for the model's filtered activations.

    Below 4D: the plain activation. H or W not divisible by 4 (the UNet's
    2x2 level): the FFT ref chain, as in the JAX package, where that case
    never reaches a Pallas kernel either; autograd runs through
    ``torch.fft``. Otherwise ``filtered_act_plane`` up to 64 px and
    ``filtered_act_banded`` above, whose CPU version is the JAX package's
    chain (matmul up to 512 px, spectral above); both are differentiable
    at every size they take."""
    if x.ndim < 4:
        return _ACTS[act](x)
    H, W = x.shape[-2:]
    if H % 4 or W % 4:
        return filtered_nonlinearity(x, act)
    if max(H, W) <= PLANE_MAX:
        return filtered_act_plane(x, act)
    return filtered_act_banded(x, act)
