"""The flash attention's forward-and-backward chain on the card, the
training step's use of it: ``sdpa``'s autograd Function runs the forward
K3 and the backward K4a (dq) and K4b (dk, dv). The counterpart of the JAX
package's ``scripts/bench_flash_bwd_sweep.py`` (its flags, its
``--iters`` chain of dependent gradient steps and its forward-only chain,
best of 3).

The JAX script sweeps (block_q, block_k) pairs, one row a pair, and a
summary row naming the best pair. The port's kernels have one tile a head
dim and dtype (the forward's ``flash_probes.q_tile`` query rows, and 64
keys at f32, ``flash_bf16_key_tile`` at bf16; the backward's tiling is
fixed by D as well), so there
is nothing to sweep: one row a shape and dtype, with the forward's tile as
``bq`` and ``bk``, and no summary row.

Each gradient step is q + 1e-6·(dq + dk + dv) of sum(out²) (every step
depends on the one before), the forward step out = sdpa(q, k, v); times
from CUDA events on the card. The row has the JAX script's keys (``kind``
"bwd_sweep", ``bq``, ``bk``, ``dtype``, ``shape``, ``iters``,
``grad_ms``, ``fwd_ms``, ``bwd_ms`` = grad - fwd); added ``device``. Rows
go to ``--out`` as the JAX script writes them: ``{"rows": [...], "args":
{...}}``, the rows of other dtypes from an earlier run kept.

  python -m afldm_tpu_torch.scripts.bench_flash_bwd_sweep [--dtype f32]
  python -m afldm_tpu_torch.scripts.bench_flash_bwd_sweep --device cpu \\
      --batch 1 --heads 1 --tokens 128 --dim 8 --iters 1
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_flash_bwd_sweep_torch.json"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--tokens", type=int, default=4096)
    p.add_argument("--dim", type=int, default=80)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


def main(argv=None):
    from ..ops import sdpa, set_af_precision
    from ..ops.attention import flash_bf16_key_tile
    from ..ops.flash_probes import PROBE_TILE, q_tile
    from ..pipelines.loading import resolve_device
    from .bench import device_name
    from .bench_flash_sweep import DTYPES, measure
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_af_precision("highest")  # TF32 off
    dt = DTYPES[args.dtype]
    B, H, L, D = args.batch, args.heads, args.tokens, args.dim
    r = np.random.default_rng(0)
    q0, k0, v0 = (torch.from_numpy(r.standard_normal((B, H, L, D))
                                   .astype(np.float32)).to(device, dt)
                  for _ in range(3))

    def grad_step(c, k, v):
        leaves = [t.detach().requires_grad_() for t in (c, k, v)]
        out = sdpa(*leaves)
        dq, dk, dv = torch.autograd.grad(out.float().square().sum(), leaves)
        # fold all three into the carry: each step depends on the last
        return (c + 1e-6 * (dq + dk + dv)).to(dt).detach()

    def fwd_step(c, k, v):
        with torch.no_grad():
            return sdpa(c, k, v).to(dt)

    grad_ms = measure(grad_step, q0, (k0, v0), args.iters, device)
    fwd_ms = measure(fwd_step, q0, (k0, v0), args.iters, device)
    bk = flash_bf16_key_tile(D) if dt == torch.bfloat16 else PROBE_TILE
    row = dict(kind="bwd_sweep", bq=q_tile(D, dt), bk=bk,
               dtype=args.dtype, shape=[B, H, L, D], iters=args.iters,
               grad_ms=grad_ms, fwd_ms=fwd_ms, bwd_ms=grad_ms - fwd_ms,
               device=device_name(device))
    print(json.dumps(row), flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = [row]
    if out.exists():  # keep the rows of the other dtype
        try:
            prev = json.loads(out.read_text()).get("rows", [])
            rows = [p for p in prev if p.get("dtype") != args.dtype] + rows
        except ValueError:
            pass
    out.write_text(json.dumps({"rows": rows, "args": vars(args)}, indent=1))
    print("wrote", out)
    return row


if __name__ == "__main__":
    main()
