"""The fused two-KV blended attention of CFA interpolation against its
unfused form on the card, at SD sizes: ``sdpa2`` (the kernel K6, both
attentions in one pass over Q) against two ``sdpa`` passes (K3 each) and
the blend ``(1 - α)·o0 + α·o1``, both arms composed here. The counterpart
of the JAX package's ``scripts/bench_sdpa2.py``, with its flags and row.

Each time is the best of 3 runs of ``--iters`` chained calls (each output,
cast to ``--dtype``, the next call's q), from CUDA events on the card. The
row (printed and appended to ``--out``) has the JAX script's keys:
``shape``, ``dtype``, ``unfused_ms``, ``fused_ms``, ``speedup``,
``max_abs_diff`` (fused against unfused, in f32); added ``device``.

  python -m afldm_tpu_torch.scripts.bench_sdpa2 [--dtype bf16]  # the card
  python -m afldm_tpu_torch.scripts.bench_sdpa2 --device cpu --frames 2 \\
      --tokens 128 --dim 8 --heads 1 --iters 1
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_sdpa2_torch.jsonl"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=17)   # interp default
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--tokens", type=int, default=4096)  # SD 64x64 latents
    p.add_argument("--dim", type=int, default=80)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


@torch.no_grad()
def main(argv=None):
    from ..ops import sdpa, sdpa2, set_af_precision
    from ..pipelines.loading import resolve_device
    from .bench import device_name
    from .bench_flash_sweep import DTYPES, measure
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_af_precision("highest")  # TF32 off
    dt = DTYPES[args.dtype]
    B, H, L, D = args.frames, args.heads, args.tokens, args.dim
    r = np.random.default_rng(0)

    def rand():
        return torch.from_numpy(r.standard_normal((B, H, L, D))
                                .astype(np.float32)).to(device, dt)

    q, k0, v0, k1, v1 = (rand() for _ in range(5))
    alpha = torch.from_numpy(np.linspace(0, 1, B).astype(np.float32)).to(
        device)
    a4 = alpha[:, None, None, None]

    def fused(c, k0, v0, k1, v1):
        return sdpa2(c, k0, v0, k1, v1, alpha).to(dt)

    def unfused(c, k0, v0, k1, v1):
        o0, o1 = sdpa(c, k0, v0), sdpa(c, k1, v1)
        return ((1.0 - a4) * o0 + a4 * o1).to(dt)

    kv = (k0, v0, k1, v1)
    t_un = measure(unfused, q, kv, args.iters, device)
    t_fu = measure(fused, q, kv, args.iters, device)
    d = float((fused(q, *kv).float() - unfused(q, *kv).float()).abs().max())
    row = {"shape": [B, H, L, D], "dtype": args.dtype, "unfused_ms": t_un,
           "fused_ms": t_fu, "speedup": t_un / t_fu, "max_abs_diff": d,
           "device": device_name(device)}
    print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


if __name__ == "__main__":
    main()
