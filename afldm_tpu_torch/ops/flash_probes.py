"""Attribution probes of the flash forward (K3): P1 and P2 of the JAX
package's flash sweep (``scripts/bench_flash_sweep.py::dots_only_kernel``
and ``::stream_only_kernel``), with K3's grid, staging and tile loop
(``kernels/csrc/flash_tile.cuh``) and cut-down arithmetic.

- ``flash_probe_dots``: ``(q·kᵀ)·v``, the softmax replaced by the identity
  (no scale, no max, no exp): the matmul-plus-memory floor of K3.
- ``flash_probe_stream``: for each 64-row K/V tile ``acc += q +
  colsum(k_tile) + colsum(v_tile)``, so ``(Lk/64)·q + Σk + Σv``: the pure
  memory floor of K3's loads.

q: (..., Lq, D), k/v: (..., Lk, D), float32 or bfloat16 (one dtype for
all three), Lq and Lk multiples of 64, D <= 256. A CPU tensor goes to the
plain version; a CUDA tensor launches the kernel or raises, and returns its
empty output without a launch where there are no rows.

bfloat16 (on the card ``flash_probe_dots_bf16`` and
``flash_probe_stream/bf16``): the JAX bodies at bf16. P1 sums q·kᵀ in f32,
rounds it to bf16 (``s.astype(v_ref.dtype)``), sums s·v in f32 and rounds
the output to bf16 once, on K3/bf16's tiles (``q_tile`` rows,
``flash_bf16_key_tile`` keys); P2
sums in f32 and rounds the output once, on 64-row tiles.
"""

import torch

from .. import kernels
from .attention import FLASH_MAX_D, _as_4d, _kernel_dtype

PROBE_TILE = 64  # P2's K/V tile in rows, and the f32 kernels'


def q_tile(D: int, dtype=torch.float32) -> int:
    """Rows of the flash forward kernels' Q tile at head dim D and dtype
    (``kernels/csrc/flash_tile.cuh``): at f32 (``FlashCfg``) 128, or 64 at
    D > 160 (DP = 256); at bf16 (``FwdCfg``: K3, K6 and P1; ``MmaCfg``: P2)
    64."""
    if dtype == torch.bfloat16:
        return 64
    return 64 if D > 160 else 128


def flash_probe_dots_plain(q, k, v):
    """The plain version of ``flash_probe_dots``: (q·kᵀ)·v summed in f32,
    the scores rounded to q's dtype before the second product and the
    output rounded once (both no-ops at f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(q.dtype)
    return torch.matmul(s.float(), v.float()).to(q.dtype)


def flash_probe_stream_plain(q, k, v, block_k: int = PROBE_TILE):
    """The plain version of ``flash_probe_stream`` at K/V tile ``block_k``:
    for each tile ``acc += q + colsum(k_tile) + colsum(v_tile)`` in f32, the
    kernels' order, so ``(Lk/block_k)·q + Σk + Σv`` (sums over the rows),
    rounded once to q's dtype."""
    n_tiles = k.shape[-2] // block_k
    ck, cv = (t.float().unflatten(-2, (n_tiles, block_k)).sum(-2)
              for t in (k, v))
    qf = q.float()
    acc = torch.zeros_like(qf)
    for t in range(n_tiles):
        acc += qf + ck[..., t:t + 1, :] + cv[..., t:t + 1, :]
    return acc.to(q.dtype)


def _check(name, q, k, v):
    Lq, D = q.shape[-2:]
    Lk = k.shape[-2]
    if (k.shape[:-2] != q.shape[:-2] or v.shape != k.shape
            or k.shape[-1] != D or D > FLASH_MAX_D
            or (Lk == 0 and q.numel())
            or Lq % PROBE_TILE or Lk % PROBE_TILE):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}: Lq and Lk must be multiples of {PROBE_TILE}, "
            f"D <= {FLASH_MAX_D}, k and v of one shape")
    return _kernel_dtype((q, k, v), name)


def _launch(name, suffix, q, k, v):
    if not all(t.device == q.device and t.device.type == "cuda"
               for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must lie on one CUDA device")
    lead = q.shape[:-2]
    q4, k4, v4 = (_as_4d(t) for t in (q, k, v))
    q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q4, k4, v4))
    B1, B2, Lq, D = q4.shape
    out = torch.empty((B1, B2, Lq, D), device=q.device, dtype=q.dtype)
    if out.numel() == 0:  # no rows: nothing to launch
        return out.reshape(lead + (Lq, D))
    strides = [s for t in (q4, k4, v4) for s in t.stride()[:3]]
    err = getattr(kernels.library("flash_probe"), f"{name}_{suffix}")(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), B1, B2,
        Lq, k4.shape[2], D, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES[name if suffix == "f32" else f"{name}/bf16"] += 1
    return out.reshape(lead + (Lq, D))


def flash_probe_dots(q, k, v):
    """P1: ``(q·kᵀ)·v`` through K3's tiles. K/V expanded from one image
    (stride 0) are read without a copy."""
    suffix = _check("flash_probe_dots", q, k, v)
    if q.device.type == "cpu":
        return flash_probe_dots_plain(q, k, v)
    return _launch("flash_probe_dots", suffix, q, k, v)


def flash_probe_stream(q, k, v):
    """P2: ``(Lk/64)·q + Σk + Σv`` through K3's loads."""
    suffix = _check("flash_probe_stream", q, k, v)
    if q.device.type == "cpu":
        return flash_probe_stream_plain(q, k, v)
    return _launch("flash_probe_stream", suffix, q, k, v)
