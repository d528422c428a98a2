"""The filtered activation (2x ideal upsample -> act -> ideal LPF ->
decimate) at the models' sizes on the card: ``filtered_act_fused`` (the
kernel K5 up to 64 px, the banded chain K1 above; with ``--grad`` its
backward K5b or K2), the plain matmul version ``filtered_act_plain`` and
the FFT reference chain (``filtered_nonlinearity(impl="spectral")``). The
counterpart of the JAX package's ``scripts/bench_filtered_act.py``: its
SHAPES (:25-33, NHWC there; the port's tensors are NCHW with the same
values), ``--iters`` and ``--grad``; the port adds ``--af_precision``
(the level of the circulant products, which the kernels and the plain
version both follow) and ``--dtype`` (of x).

Each time is the best of 3 runs of ``--iters`` chained applications
(``max(iters // 3, 5)`` chained gradients of sum(f(x)²) with ``--grad``),
from CUDA events on the card. One JSON row a shape, printed and appended to
``--out``, with the JAX table's columns renamed: ``pallas`` ->
``fused_ms``, ``xla_matmul`` -> ``plain_matmul_ms``, ``xla_spectral`` ->
``fft_ms``, ``speedup vs best XLA`` -> ``speedup_vs_best_plain``, ``max
err`` -> ``max_err`` (fused against the plain matmul version), ``mode``
("plane": K5, "banded": K1); added ``dtype``, ``af_precision`` and
``device``; with ``--grad`` the JAX line ``grad: pallas= xla_matmul=`` as
``grad_fused_ms`` and ``grad_plain_matmul_ms``. Then the markdown table.

  python -m afldm_tpu_torch.scripts.bench_filtered_act [--grad]  # the card
  python -m afldm_tpu_torch.scripts.bench_filtered_act --device cpu
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_filtered_act_torch.jsonl"

SHAPES = [
    # (N, H, W, C)                  # where it occurs
    (1, 32, 32, 768),               # FFHQ UNet latent, deep blocks
    (8, 32, 32, 768),               # batched denoise
    (1, 64, 64, 512),               # SD latent / VAE 64px stage
    (1, 128, 128, 256),             # VAE 128px stage
    (1, 256, 256, 128),             # VAE 256px stage
    (4, 256, 256, 128),             # batched VAE
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--grad", action="store_true",
                   help="also bench the backward pass")
    p.add_argument("--af_precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


def grad_of(fn):
    """x -> the gradient of sum(fn(x)²) in x (f32 square)."""
    def g(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(fn(x).float().square().sum(), x)
        return dx
    return g


@torch.no_grad()
def main(argv=None):
    from ..ops import (filtered_act_fused, filtered_act_plain,
                       filtered_nonlinearity, set_af_precision)
    from ..ops.filtered_act import PLANE_MAX
    from ..pipelines.loading import resolve_device
    from .bench import device_name
    from .bench_flash_sweep import measure
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    dev_name = device_name(device)
    set_af_precision(args.af_precision)
    print(f"device={dev_name} dtype={args.dtype} "
          f"af_precision={args.af_precision}", flush=True)
    arms = {
        "fused": lambda z: filtered_act_fused(z, "silu"),
        "plain_matmul": lambda z: filtered_act_plain(z, "silu"),
        "fft": lambda z: filtered_nonlinearity(z, "silu", impl="spectral"),
    }
    rows = []
    try:
        for shape in SHAPES:
            x = (torch.from_numpy(np.random.default_rng(0).standard_normal(
                shape).astype(np.float32)).permute(0, 3, 1, 2).contiguous()
                .to(device, dtype))
            row = {"shape": list(shape),
                   "mode": "plane" if max(shape[1:3]) <= PLANE_MAX
                   else "banded",
                   "dtype": args.dtype, "af_precision": args.af_precision,
                   "device": dev_name}
            for name, fn in arms.items():
                row[f"{name}_ms"] = measure(lambda c: fn(c), x, (),
                                            args.iters, device)
            row["speedup_vs_best_plain"] = (
                min(row["plain_matmul_ms"], row["fft_ms"]) / row["fused_ms"])
            row["max_err"] = float((arms["fused"](x).float()
                                    - arms["plain_matmul"](x).float())
                                   .abs().max())
            if args.grad:
                it = max(args.iters // 3, 5)
                for name in ("fused", "plain_matmul"):
                    row[f"grad_{name}_ms"] = measure(grad_of(arms[name]), x,
                                                     (), it, device)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        set_af_precision("highest")

    print("\n| shape | mode | plain_matmul | fft | fused | speedup vs best "
          "plain | max err |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {tuple(r['shape'])} | {r['mode']} | "
              f"{r['plain_matmul_ms']:.3f} | {r['fft_ms']:.3f} | "
              f"{r['fused_ms']:.3f} | {r['speedup_vs_best_plain']:.2f}x | "
              f"{r['max_err']:.1e} |")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
