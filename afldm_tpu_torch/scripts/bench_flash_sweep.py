"""Flash-attention timing and bottleneck attribution on the card: the
single-KV flash forward (K3, through ``sdpa``) and the fused two-KV one
(K6, through ``sdpa2``) at the flagship shapes, then the attribution probes
at K3's shape: P1 (``flash_probe_dots``, the softmax replaced by the
identity: the matmul-plus-memory floor) and P2 (``flash_probe_stream``,
K3's loads with trivial work: the memory floor). ``1 - dots/flash`` is the
online softmax's share of K3's time, ``stream/flash`` its loads' share.

The kernels have one tile at a head dim and dtype (``flash_probes.q_tile``
query rows: at f32 64 keys and 128 query rows, 64 at D > 160; at bf16 64
query rows and, for K3, K6 and P1, ``flash_bf16_key_tile(D)`` keys, while
P2 keeps 64), so the sweep is one row per op at K3's tile. ``--dtype``
(bf16 by default, as in the JAX script) sets the dtype of q, k and v for all four kernels, and every row carries
it; the probe row carries K3's own time at that dtype. Each time is the
best of 3 runs of ``--iters`` chained calls (each call's output is the next
one's q), from CUDA events. Rows are printed as JSON lines and appended to
``--out``.

  python -m afldm_tpu_torch.scripts.bench_flash_sweep          # on the card
  python -m afldm_tpu_torch.scripts.bench_flash_sweep --device cpu \\
      --tokens 128 --dim 8 --heads 1 --batch 1 --frames 2 --iters 1
"""

import argparse
import json
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_flash_sweep_torch.jsonl"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=17)
    p.add_argument("--batch", type=int, default=8,
                   help="single-KV sdpa batch (the roofline denoise batch)")
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--tokens", type=int, default=4096)
    p.add_argument("--dim", type=int, default=80)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"],
                   help="dtype of q, k and v (default bf16, the JAX "
                        "script's)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


def measure(f1, x0, xs, iters, device, repeats=3):
    """Best of ``repeats`` mean times (ms) of ``iters`` chained calls
    ``c = f1(c, *xs)`` after one warm-up chain; CUDA events on the card,
    the host clock on the CPU."""
    def chain():
        c = x0
        for _ in range(iters):
            c = f1(c, *xs)
        return c

    chain()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            chain()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms / iters)
    return best


@torch.inference_mode()
def main(argv=None):
    from ..ops import sdpa, sdpa2, set_af_precision
    from ..ops.attention import flash_bf16_key_tile
    from ..ops.flash_probes import (PROBE_TILE, flash_probe_dots,
                                    flash_probe_stream, q_tile)
    from ..pipelines.loading import resolve_device
    from .bench import device_name
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_af_precision("highest")
    H, L, D = args.heads, args.tokens, args.dim
    gen = torch.Generator().manual_seed(0)
    dtype = DTYPES[args.dtype]

    def rand(B):
        return torch.randn((B, H, L, D), generator=gen).to(device, dtype)

    rows = []

    def record(**kw):
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    def timed(f1, x0, xs):
        return measure(f1, x0, xs, args.iters, device)

    bk = flash_bf16_key_tile(D) if dtype == torch.bfloat16 else PROBE_TILE
    tile = dict(bq=q_tile(D, dtype), bk=bk, dtype=args.dtype)
    q1, k1, v1 = rand(args.batch), rand(args.batch), rand(args.batch)
    flash_ms = timed(sdpa, q1, (k1, v1))
    record(kind="sweep", op="sdpa", **tile, shape=[args.batch, H, L, D],
           ms=flash_ms)

    q2, k20, v20, k21, v21 = (rand(args.frames) for _ in range(5))
    alpha = torch.linspace(0, 1, args.frames, device=device)
    ms = timed(lambda c, k0, v0, k1_, v1_: sdpa2(c, k0, v0, k1_, v1_, alpha),
               q2, (k20, v20, k21, v21))
    record(kind="sweep", op="sdpa2", **tile,
           shape=[args.frames, H, L, D], ms=ms)
    del q2, k20, v20, k21, v21

    dots_ms = timed(flash_probe_dots, q1, (k1, v1))
    stream_ms = timed(flash_probe_stream, q1, (k1, v1))
    record(kind="probe", op="sdpa", **tile, shape=[args.batch, H, L, D],
           device=device_name(device),
           flash_ms=flash_ms, dots_only_ms=dots_ms,
           stream_only_ms=stream_ms, softmax_share=1.0 - dots_ms / flash_ms,
           mem_share=stream_ms / flash_ms)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
