"""Attention at the models' shapes on the card: the flash forward (K3,
through ``sdpa``), its plain version ``sdpa_eager``, and PyTorch's
``F.scaled_dot_product_attention`` as the yardstick (the role of the JAX
script's ``sdpa_xla``; the port never calls it). The counterpart of the
JAX package's ``scripts/bench_attention.py``: its SHAPES (:24-32),
``--iters``, ``--dtype`` and ``--grad`` (the gradient of sum(out²)
through ``sdpa``'s autograd Function, which runs K3, K4a and K4b, beside
autograd through the plain version and through the library call).

Each time is the best of 3 runs of ``--iters`` chained calls (the output
is the next call's q; with ``--grad`` ``max(iters // 3, 5)`` chained steps,
q's gradient the next q), from CUDA events on the card. The kernels have
one tile a head dim and dtype (``flash_probes.q_tile`` query rows; 64 keys
at f32, ``flash_bf16_key_tile`` at bf16), so a ``--block_q`` or
``--block_k`` other than that tile is refused.

One JSON row a shape, printed and appended to ``--out``, with the JAX
table's columns renamed: ``xla`` -> ``library_ms``, ``flash`` ->
``sdpa_ms``, ``speedup`` (library over sdpa), ``max err`` -> ``max_err``
(sdpa against sdpa_eager); added ``sdpa_eager_ms``, ``dtype`` and
``device``; with ``--grad`` the JAX line ``grad: xla= flash=`` as
``grad_library_ms`` and ``grad_sdpa_ms``, added ``grad_sdpa_eager_ms``.
Then the markdown table, as the JAX script prints it.

  python -m afldm_tpu_torch.scripts.bench_attention [--grad]   # on the card
  python -m afldm_tpu_torch.scripts.bench_attention --device cpu --iters 1
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_attention_torch.jsonl"

SHAPES = [
    # (B, heads, Lq, Lk, D)          # where it occurs
    (2, 8, 4096, 4096, 40),          # SD 64x64 self-attn (CFG batch 2)
    (8, 8, 4096, 4096, 40),          # video editing, 8 frames
    (2, 8, 1024, 1024, 80),          # SD 32x32 level
    (2, 8, 256, 256, 160),           # SD 16x16 level
    (1, 16, 1024, 1024, 24),         # FFHQ UNet 32x32 (head_dim 24)
    (8, 16, 1024, 1024, 24),         # batched FFHQ denoise
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--block_q", type=int, default=None,
                   help="must be the kernels' Q tile (flash_probes.q_tile)")
    p.add_argument("--block_k", type=int, default=None,
                   help="must be the kernels' K/V tile (64 at f32, "
                        "flash_bf16_key_tile at bf16)")
    p.add_argument("--grad", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


def check_blocks(block_q, block_k, dtype):
    """Refuse block sizes the kernels do not have: one tile a head dim and
    dtype, the same at every shape of SHAPES."""
    from ..ops.attention import flash_bf16_key_tile
    from ..ops.flash_probes import PROBE_TILE, q_tile
    tiles = {q_tile(s[-1], dtype) for s in SHAPES}
    keys = {flash_bf16_key_tile(s[-1]) if dtype == torch.bfloat16
            else PROBE_TILE for s in SHAPES}
    if ((block_k is not None and keys != {block_k})
            or (block_q is not None and tiles != {block_q})):
        raise SystemExit(
            f"--block_q {block_q} --block_k {block_k}: the port's flash "
            f"kernels have one tile a head dim and dtype ({sorted(tiles)} "
            f"query rows and {sorted(keys)} keys at these shapes), chosen "
            "at compile time; there is no block size to sweep")


def grad_step(attn):
    """q -> the gradient of sum(attn(q, k, v)²) in q (f32 square)."""
    def f(c, k, v):
        with torch.enable_grad():
            c = c.detach().requires_grad_()
            out = attn(c, k, v)
            (g,) = torch.autograd.grad(out.float().square().sum(), c)
        return g
    return f


@torch.no_grad()
def main(argv=None):
    from ..ops import sdpa, sdpa_eager, set_af_precision
    from ..pipelines.loading import resolve_device
    from .bench import device_name
    from .bench_flash_sweep import measure
    args = parse_args(argv)
    dtype = getattr(torch, args.dtype)
    check_blocks(args.block_q, args.block_k, dtype)
    device = resolve_device(args.device)
    set_af_precision("highest")  # TF32 off
    dev_name = device_name(device)
    print(f"device={dev_name} dtype={args.dtype}", flush=True)
    arms = {"library": F.scaled_dot_product_attention, "sdpa": sdpa,
            "sdpa_eager": sdpa_eager}
    rows = []
    for (B, H, Lq, Lk, D) in SHAPES:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, L, D))
                                    .astype(np.float32)).to(device, dtype)
                   for L in (Lq, Lk, Lk))
        row = {"shape": [B, H, Lq, Lk, D], "dtype": args.dtype,
               "device": dev_name}
        for name, fn in arms.items():
            row[f"{name}_ms"] = measure(fn, q, (k, v), args.iters, device)
        row["speedup"] = row["library_ms"] / row["sdpa_ms"]
        row["max_err"] = float((sdpa(q, k, v).float()
                                - sdpa_eager(q, k, v).float()).abs().max())
        if args.grad:
            it = max(args.iters // 3, 5)
            for name, fn in arms.items():
                row[f"grad_{name}_ms"] = measure(grad_step(fn), q, (k, v),
                                                 it, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print(f"\n| (B, heads, Lq, Lk, D) {args.dtype} | library | sdpa | "
          "sdpa_eager | speedup | max err |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {tuple(r['shape'])} | {r['library_ms']:.3f} | "
              f"{r['sdpa_ms']:.3f} | {r['sdpa_eager_ms']:.3f} | "
              f"{r['speedup']:.2f}x | {r['max_err']:.1e} |")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
