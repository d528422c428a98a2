"""Training-step throughput on the card: the flagship training workload
(FFHQ-256 LDM: the alias-free UNet of ``configs/ldm/model_unet.json`` over
the frozen AF-VAE of ``configs/vae/model_afvae.json``, shift loss, CFA and
EMA, batch 16, as ``configs/ldm/train_unet_ffhq.json`` trains it) through
the port's ``LDMTrainer``, one ``training_step`` a step, random weights
from seed 0. The counterpart of the JAX package's
``scripts/bench_train.py``, with every flag of it but ``--cpu``, which is
``--device`` here.

Reports steps/s and images/s (the best of ``--steps`` steps after a first
one, each ending in the host read of its losses), the peak device memory,
and the step's FLOPs: ``FlopCounterMode`` over one step of the same
trainer at batch 1 on the CPU, where the plain versions run the kernels'
products, scaled by the batch (as ``scripts/bench.py::unet_flops`` counts
the denoise; FFTs and elementwise work are not counted, and the JAX
script's ``cost_analysis`` counts what XLA compiled). TFLOP/s is held
against the H100 SXM's dense peak of the step's dtype (``bench.py``'s
``PEAK_F32_TFLOPS`` / ``PEAK_BF16_TFLOPS``, as ``chip_smoke.py``'s).

The JSON row (printed and appended to ``--out``) has the JAX script's keys,
``mfu_vs_197tflops_bf16`` renamed ``mfu_vs_67tflops_f32`` (f32) or
``mfu_vs_989tflops_bf16`` (bf16); added ``first_step_s``,
``peak_memory_gib`` and ``device``.

  python -m afldm_tpu_torch.scripts.bench_train [--mixed_precision bf16]
  python -m afldm_tpu_torch.scripts.bench_train --device cpu --batch 2 \\
      --resolution 64 --steps 1            # the CPU needs tiny configs
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "configs"
OUT = REPO / "results" / "bench_train_torch.jsonl"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--mixed_precision", default="no", choices=["no", "bf16"])
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--remat_policy", default="full", choices=["full", "dots"],
                   help="remat selectivity under --gradient_checkpointing")
    p.add_argument("--no_shift_loss", action="store_true")
    p.add_argument("--naive", action="store_true",
                   help="af_models=False (the alias-free training tax is "
                        "full minus this)")
    p.add_argument("--af_precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="precision of the alias-free circulant products")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT),
                   help="JSONL sink ('' to disable)")
    return p.parse_args(argv)


def model_configs():
    """(vae, unet, scheduler) config dicts of the flagship run."""
    def read(rel):
        return json.loads((CONFIGS / rel).read_text())
    return (read("vae/model_afvae.json"), read("ldm/model_unet.json"),
            read("ldm/noise_scheduler.json"))


def build_trainer(args, batch, device, mixed_precision):
    """The LDM trainer of the JAX script's configs, prepared from seed 0."""
    from .. import train as T
    vae_cfg, unet_cfg, sched_cfg = model_configs()
    base = T.BaseTrainingConfig(
        resolution=args.resolution, train_batch_size=batch, num_epochs=1,
        seed=0, mixed_precision=mixed_precision,
        gradient_checkpointing=args.gradient_checkpointing,
        remat_policy=args.remat_policy, af_precision=args.af_precision)
    ldm = T.LDMTrainingConfig(
        af_models=not args.naive, use_shift_loss=not args.no_shift_loss,
        use_ema=True, use_cross_attn=not args.no_shift_loss)
    tr = T.create_trainer("ldm", base, ldm, device=device)
    tr.init_modules(vae_config=vae_cfg, unet_config=unet_cfg,
                    scheduler_config=sched_cfg)
    tr.init_optimizers()
    tr.prepare_modules(seed=0)
    return tr


def images(batch, resolution):
    """The JAX script's batch: N(0, 0.25) NHWC images from seed 0."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((batch, resolution, resolution, 3))
            * 0.5).astype(np.float32)


def step_flops(args):
    """FLOPs of one training step: FlopCounterMode over the step at batch 1
    on the CPU (f32; the count does not depend on the dtype), times the
    batch. FFTs and elementwise work are not counted."""
    from torch.utils.flop_counter import FlopCounterMode
    tr = build_trainer(args, 1, "cpu", "no")
    counter = FlopCounterMode(display=False)
    with counter:
        tr.training_step(0, {"input": images(1, args.resolution)})
    return counter.get_total_flops() * args.batch


def main(argv=None):
    from ..ops import set_af_precision
    from ..pipelines.loading import resolve_device
    from .bench import PEAK_BF16_TFLOPS, PEAK_F32_TFLOPS, device_name
    args = parse_args(argv)
    device = resolve_device(args.device)
    try:
        tr = build_trainer(args, args.batch, device, args.mixed_precision)
        batch = {"input": images(args.batch, args.resolution)}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        logs = tr.training_step(0, batch)  # floats: synchronises
        first_s = time.perf_counter() - t0
        print(f"first step: {first_s:.1f}s loss={logs['train_loss']:.4f}",
              file=sys.stderr)
        best = float("inf")
        for i in range(args.steps):
            t0 = time.perf_counter()
            logs = tr.training_step(i + 1, batch)
            best = min(best, time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None)
        del tr
        if device.type == "cuda":
            torch.cuda.empty_cache()
        flops = step_flops(args)
    finally:
        set_af_precision("highest")
    bf16 = args.mixed_precision == "bf16"
    peak_tflops = PEAK_BF16_TFLOPS if bf16 else PEAK_F32_TFLOPS
    out = {
        "workload": "ldm_train_step_ffhq256",
        "batch": args.batch,
        "mixed_precision": args.mixed_precision,
        "gradient_checkpointing": args.gradient_checkpointing,
        "remat_policy": args.remat_policy,
        "af_precision": args.af_precision,
        "af_models": not args.naive,
        "shift_loss": not args.no_shift_loss,
        "steps_per_s": 1.0 / best,
        "images_per_s": args.batch / best,
        "final_loss": logs["train_loss"],
        "program_gflop": flops / 1e9,
        "tflop_per_s": flops / best / 1e12,
        ("mfu_vs_989tflops_bf16" if bf16 else "mfu_vs_67tflops_f32"):
            flops / best / 1e12 / peak_tflops,
        "first_step_s": first_s,
        "peak_memory_gib": peak,
        "device": device_name(device),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
