#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``afldm_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # 50 DDIM steps, 16 shifts
    python3 chip_smoke.py --steps 10 # fewer steps if time is short

Phases, each of which fails the run:
1. build every CUDA kernel from ``afldm_tpu_torch/kernels/csrc`` (nvcc);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version, the library call
   where one exists, and the bound (the larger of FLOPs / 67 TFLOP/s f32
   and bytes / 3.35 TB/s);
3. run the tiny pipeline on the card and on the CPU with the same weights
   and compare (the end-to-end reference check);
4. the main path at full width (274M UNet, AF-VAE at 256 px, random
   weights from seed 0): ``shift_equivariance_eval`` with 16 shifts in one
   LOAD pass, with every launch counter set to 0 just before and read just
   after; every kernel must have launched and all PSNRs must be finite.

The second-to-last line is the kernels JSON, the last the device JSON.
Exits non-zero without a GPU or without the package beside it.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 without tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3

KERNELS = {
    "filtered_act_plane": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:175",
        shapes=[(16, 192, 32, 32), (16, 1536, 4, 4), (16, 512, 64, 64)]),
    "filtered_act_banded": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:228",
        shapes=[(16, 256, 128, 128), (16, 512, 128, 128)]),
    "flash_fwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="afldm_tpu/ops/attention.py:59",
        # (images, heads, L, D, K/V images): the LOAD pass at 32 px and 2 px
        shapes=[(16, 8, 1024, 24, 1), (16, 32, 4, 24, 1)]),
}
# a kernel agrees with its plain version when |got - want| <= ATOL + RTOL|want|
# (f32 sums in another order: ~1e-6 relative)
TOL = {"filtered_act_plane": (3e-5, 1e-4), "filtered_act_banded": (3e-5, 1e-4),
       "flash_fwd": (2e-5, 1e-4)}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def filtered_act_work(shape):
    """FLOPs of the four products per plane (8H²W + 16HW², = 24S³ square)
    and bytes: x read once, out written once, the four operators read once."""
    n, c, h, w = shape
    flops = n * c * (8 * h * h * w + 16 * h * w * w)
    nbytes = 4 * (2 * n * c * h * w + 4 * h * h + 4 * w * w)
    return flops, nbytes


def flash_work(shape):
    """FLOPs of q·kᵀ and p·v (4·B·L²·D, D unpadded); bytes: q, the unique
    K/V rows, out and lse, each once."""
    n, heads, L, d, n_kv = shape
    flops = 4 * n * heads * L * L * d
    nbytes = 4 * (2 * n * heads * L * d + 2 * n_kv * heads * L * d
                  + n * heads * L)
    return flops, nbytes


def check_kernels(torch, report):
    import torch.nn.functional as F
    from afldm_tpu_torch.ops import attention as A
    from afldm_tpu_torch.ops import filtered_act as FA
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    split = {k: {"operations": 0.0, "bytes": 0.0} for k in KERNELS}
    for name, spec in KERNELS.items():
        atol, rtol = TOL[name]
        row = report[name]
        for shape in spec["shapes"]:
            if name == "flash_fwd":
                n, heads, L, d, n_kv = shape
                q = torch.randn(n, heads, L, d, device=dev, generator=g)
                k, v = (torch.randn(n_kv, heads, L, d, device=dev,
                                    generator=g).expand(n, -1, -1, -1)
                        for _ in range(2))
                got = A.flash_fwd(q, k, v)
                want = A._attention_plain(q, k, v)
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                good = all(torch.allclose(a, b, atol=atol, rtol=rtol)
                           for a, b in zip(got, want))
                t = time_ms(lambda: A.flash_fwd(q, k, v))
                tp = time_ms(lambda: A._attention_plain(q, k, v))
                tl = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                work = flash_work(shape)
            else:
                x = torch.randn(shape, device=dev, generator=g)
                fn = getattr(FA, name)
                got = fn(x, "silu")
                want = FA.filtered_act_plain(x, "silu")
                err = float((got - want).abs().max())
                good = torch.allclose(got, want, atol=atol, rtol=rtol)
                t = time_ms(lambda: fn(x, "silu"))
                tp = time_ms(lambda: FA.filtered_act_plain(x, "silu"))
                tl = None
                work = filtered_act_work(shape)
                del x, got, want
            b, by = bound_ms(*work)
            log(f"check {name} {shape}: max_abs_err {err:.3e} "
                f"(atol {atol}, rtol {rtol}) {'ok' if good else 'FAIL'}; "
                f"kernel {t:.4f} ms, plain {tp:.4f} ms, "
                f"library {'n/a' if tl is None else f'{tl:.4f} ms'}, "
                f"bound {b:.4f} ms ({by}-bound, {work[0] / 1e9:.3f} GFLOP, "
                f"{work[1] / 1e6:.3f} MB)")
            ok &= bool(good)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += t
            row["plain_ms"] += tp
            row["bound_ms"] += b
            split[name][by] += b
            if tl is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + tl
            torch.cuda.empty_cache()
        # the row's bound is a sum over shapes: name what bounds most of it
        row["bound_by"] = max(split[name], key=split[name].get)
    return ok


def check_tiny_reference(torch):
    """The tiny pipeline with the same weights on the card (kernels) and on
    the CPU (plain versions): per-shift PSNR within 0.05 dB and images
    within 1e-3 of their scale (f32 rounding compounds over 6 UNet passes
    and 3 decodes; cuDNN picks other summation orders than the CPU)."""
    import numpy as np
    from afldm_tpu_torch.pipelines import (init_random_pipeline,
                                           shift_equivariance_eval)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    cfgs = load_configs(tiny=True)
    lat = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = init_random_pipeline(*cfgs, seed=0, device=dev)
        res[dev] = shift_equivariance_eval(pipe, init_latent=lat,
                                           num_inference_steps=4,
                                           num_shift_steps=4)
    d_psnr = float(np.abs(res["cuda"].psnrs - res["cpu"].psnrs).max())
    scale = float(np.abs(res["cpu"].outputs).max())
    d_img = float(np.abs(res["cuda"].outputs - res["cpu"].outputs).max())
    ok = (np.isfinite(res["cuda"].psnrs).all() and d_psnr <= 0.05
          and d_img <= 1e-3 * scale)
    log(f"tiny reference (card vs CPU, 4 steps, 4 shifts): max |dPSNR| "
        f"{d_psnr:.2e} dB (limit 0.05), max |d image| {d_img:.2e} "
        f"(limit {1e-3 * scale:.2e}) {'ok' if ok else 'FAIL'}")
    return ok


def run_main_path(torch, steps):
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import (init_random_pipeline,
                                           shift_equivariance_eval)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    t0 = time.perf_counter()
    pipe = init_random_pipeline(*load_configs(), seed=0, device="cuda")
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"main path: full-width pipeline built in "
        f"{time.perf_counter() - t0:.1f} s (UNet {n_params / 1e6:.1f}M "
        f"params, VAE at {pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio} px)")
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = shift_equivariance_eval(pipe, generator=gen,
                                  num_inference_steps=steps,
                                  num_shift_steps=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    log(f"main path: shift_equivariance_eval {steps} steps x 16 shifts in "
        f"{wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main path PSNRs (dB): " + " ".join(f"{p:.3f}" for p in res.psnrs))
    log(f"main path launches: {json.dumps(counts)}")
    ok = (res.psnrs.shape == (16,) and bool(np.isfinite(res.psnrs).all())
          and res.outputs.shape == (16, 256, 256, 3)
          and bool(np.isfinite(res.outputs).all()))
    if not ok:
        log("main path: FAIL (non-finite or misshapen results)")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        log(f"main path: FAIL, never launched: {missing}")
    return ok and not missing, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the main path (default 50)")
    args = ap.parse_args(argv)

    if not (REPO / "afldm_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: afldm_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.ops import set_af_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    set_af_precision("highest")
    report = {k: dict(name=k, route=v["route"], source=v["source"],
                      replaces=v["replaces"], launches=0, max_abs_err=0.0,
                      ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
                      library_ms=None)
              for k, v in KERNELS.items()}
    ok = check_kernels(torch, report)
    ok &= check_tiny_reference(torch)
    main_ok, counts = run_main_path(torch, args.steps)
    ok &= main_ok
    for k, row in report.items():
        row["launches"] = counts[k]
    log(json.dumps({"kernels": list(report.values())}))
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
