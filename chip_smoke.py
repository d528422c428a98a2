#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``afldm_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # 50 DDIM steps, 16 shifts, 4 + 8 steps
    python3 chip_smoke.py --steps 10 --train_steps 3 --vae_steps 8

Phases, each of which fails the run:
1. build every CUDA kernel from ``afldm_tpu_torch/kernels/csrc`` (nvcc, one
   process per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time kernel, plain version, the library call
   where one exists, and the bound (the larger of FLOPs / 67 TFLOP/s f32
   and bytes / 3.35 TB/s);
3. run the tiny pipeline on the card and on the CPU with the same weights
   and compare (the end-to-end reference check of serving);
4. the serving path at full width (256.4M-parameter UNet, AF-VAE at
   256 px, random weights from seed 0): ``shift_equivariance_eval`` with
   16 shifts in one LOAD pass, with every launch counter set to 0 just
   before and read just after; every kernel of that path must have launched
   and all PSNRs must be finite;
5. one step of the tiny LDM trainer on the card and on the CPU with the
   same weights and draws: loss and every gradient compared (the
   end-to-end reference check of training);
6. the training path at full width: ``configs/ldm/train_unet_ffhq.json`` as
   it stands (batch 16, 256 px, gradient checkpointing, EMA, eps-MSE +
   CFA shift loss), synthetic data, random weights from seed 0, counters
   set to 0 just before the steps and read just after; every loss must be
   finite, the parameters must have moved and all six kernels launched;
7. one step of a tiny AF-VAE trainer (128 px, so that its top level takes
   the banded kernels) with a discriminator, on the card and on the CPU
   with the same weights, images and draws: the generator's losses and
   every VAE gradient, then the discriminator's loss and every
   discriminator gradient, compared as in 5;
8. the AF-VAE training path at full width:
   ``configs/vae/train_afvae_imagenet.json`` as it stands (the AF-VAE of
   ``model_afvae.json`` at 256 px, batch 4, shift loss, no GAN, gradient
   accumulation 2), synthetic data, random weights from seed 0,
   ``--vae_steps`` micro-steps with the counters set to 0 just before and
   read just after; every loss must be finite, every VAE parameter must
   have moved and the filtered-activation kernels (K1, K2, K5, K5b) must
   have launched.

The second-to-last line is the kernels JSON (``launches``: the sum over the
serving, LDM-training and VAE-training runs), the last the device JSON.
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
    "filtered_act_plane_bwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:328",
        # the training step's 32 px and 4 px levels
        shapes=[(16, 192, 32, 32), (16, 1536, 4, 4)]),
    "flash_bwd_dq": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="afldm_tpu/ops/attention.py:142",
        # pass 1 (K/V per image) at 32 px and 2 px; pass 2 (K/V from the
        # stored maps of the same batch) has the same shapes; one case with
        # K/V expanded from one image (stride 0)
        shapes=[(16, 8, 1024, 24, 16), (16, 32, 4, 24, 16),
                (16, 8, 1024, 24, 1)]),
    "flash_bwd_dkv": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="afldm_tpu/ops/attention.py:168",
        shapes=[(16, 8, 1024, 24, 16), (16, 32, 4, 24, 16),
                (16, 8, 1024, 24, 1)]),
    "filtered_act_banded_bwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:261",
        # the AF-VAE's 128 px level at batch 4: the encoder's first resnet
        # (128 channels), the 256-channel resnets, the decoder's first
        # resnet after the 512-channel upsampler
        shapes=[(4, 128, 128, 128), (4, 256, 128, 128), (4, 512, 128, 128)]),
}
# a kernel agrees with its plain version when |got - want| <= ATOL + RTOL|want|
# (f32 sums in another order: ~1e-6 relative; the backwards chain six
# products or sum over up to 1024 rows)
TOL = {"filtered_act_plane": (3e-5, 1e-4), "filtered_act_banded": (3e-5, 1e-4),
       "flash_fwd": (2e-5, 1e-4), "filtered_act_plane_bwd": (1e-4, 1e-4),
       "flash_bwd_dq": (1e-4, 1e-4), "flash_bwd_dkv": (1e-4, 1e-4),
       "filtered_act_banded_bwd": (1e-4, 1e-4)}
# card vs CPU for one tiny training step: the loss within LOSS_RTOL of the
# CPU's; each gradient within GRAD_RTOL of its tensor's max abs, with that
# scale floored at GRAD_FLOOR of the largest gradient: the attention's
# to_k bias has a gradient of zero in exact arithmetic (softmax ignores a
# shift of every key), so both devices compute rounding noise there
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-4
# the discriminator's floor: the biases of its convs that an instance norm
# follows also have a gradient of zero in exact arithmetic (the norm
# removes each channel's mean)
DISC_GRAD_FLOOR = 1e-3


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


def filtered_act_bwd_work(shape):
    """FLOPs of the six products per plane in both backward kernels' order
    (U_h·x and D_hᵀ·g: 4H²W each; ·U_wᵀ, ·D_w and ·U_w: 8HW² each; U_hᵀ·t:
    4H²W; together 12H²W + 24HW², = 36S³ square) and bytes: x and g read
    once, dx written once, the six operators read once."""
    n, c, h, w = shape
    flops = n * c * (12 * h * h * w + 24 * h * w * w)
    nbytes = 4 * (3 * n * c * h * w + 6 * h * h + 6 * w * w)
    return flops, nbytes


def flash_bwd_work(name, shape):
    """dq: q·kᵀ, dO·vᵀ and ds·k (6·B·L²·D); dkv adds dsᵀ·q and pᵀ·dO in
    place of ds·k (8·B·L²·D). Bytes: q, dO, lse, delta and the unique K/V
    rows read once; dq, or dk and dv (dense per image), written once."""
    n, heads, L, d, n_kv = shape
    rows = n * heads * L
    reads = 2 * rows * d + 2 * rows + 2 * n_kv * heads * L * d
    if name == "flash_bwd_dq":
        return 6 * rows * L * d, 4 * (reads + rows * d)
    return 8 * rows * L * d, 4 * (reads + 2 * rows * d)


def _case(torch, name, shape, dev, g):
    """Inputs at ``shape`` and, for ``name``: the kernel's call, its plain
    version, the library call (or None) and the work."""
    import torch.nn.functional as F
    from afldm_tpu_torch.ops import attention as A
    from afldm_tpu_torch.ops import filtered_act as FA
    if name.startswith("filtered_act"):
        x = torch.randn(shape, device=dev, generator=g)
        fn = getattr(FA, name)
        if name.endswith("_bwd"):
            gr = torch.randn(shape, device=dev, generator=g)
            return (lambda: fn(x, gr, "silu"),
                    lambda: FA.filtered_act_plane_bwd_plain(x, gr, "silu"),
                    None, filtered_act_bwd_work(shape))
        return (lambda: fn(x, "silu"),
                lambda: FA.filtered_act_plain(x, "silu"), None,
                filtered_act_work(shape))
    n, heads, L, d, n_kv = shape
    q = torch.randn(n, heads, L, d, device=dev, generator=g)
    k, v = (torch.randn(n_kv, heads, L, d, device=dev,
                        generator=g).expand(n, -1, -1, -1)
            for _ in range(2))
    if name == "flash_fwd":
        return (lambda: A.flash_fwd(q, k, v),
                lambda: A._attention_plain(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v),
                flash_work(shape))
    out, lse = A.flash_fwd(q, k, v)
    do = torch.randn(n, heads, L, d, device=dev, generator=g)
    delta = A._delta(do, out)
    scale = 1.0 / d ** 0.5
    if name == "flash_bwd_dq":
        return (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta),
                lambda: A._bwd_dq_plain(q, k, v, do, lse, delta, scale),
                None, flash_bwd_work(name, shape))
    # the library yardstick of the K4 pair: autograd through SDPA, the
    # forward excluded
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl)
    return (lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: A._bwd_dkv_plain(q, k, v, do, lse, delta, scale),
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                        retain_graph=True),
            flash_bwd_work(name, shape))


def check_kernels(torch, report):
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    split = {k: {"operations": 0.0, "bytes": 0.0} for k in KERNELS}
    for name, spec in KERNELS.items():
        atol, rtol = TOL[name]
        row = report[name]
        for shape in spec["shapes"]:
            run, plain, library, work = _case(torch, name, shape, dev, g)
            got, want = run(), plain()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            good = all(torch.allclose(a, b, atol=atol, rtol=rtol)
                       for a, b in zip(got, want))
            del got, want
            t = time_ms(run)
            tp = time_ms(plain)
            tl = None if library is None else time_ms(library)
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
            del run, plain, library
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


# the kernels each full-width path must launch
SERVING_KERNELS = ("filtered_act_plane", "filtered_act_banded", "flash_fwd")
TRAINING_KERNELS = ("filtered_act_plane", "filtered_act_banded", "flash_fwd",
                    "filtered_act_plane_bwd", "flash_bwd_dq", "flash_bwd_dkv")
VAE_TRAINING_KERNELS = ("filtered_act_plane", "filtered_act_banded",
                        "filtered_act_plane_bwd", "filtered_act_banded_bwd")


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
    missing = [k for k in SERVING_KERNELS if counts[k] == 0]
    if missing:
        log(f"main path: FAIL, never launched: {missing}")
    return ok and not missing, counts


def _tiny_trainer(device):
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    base = T.BaseTrainingConfig(resolution=64, train_batch_size=2, seed=0,
                                gradient_checkpointing=True)
    cfg = T.LDMTrainingConfig(af_models=True, use_shift_loss=True,
                              use_cross_attn=True, use_ema=True)
    tr = T.create_trainer("ldm", base, cfg, device=device)
    tr.init_modules(vae_config=vcfg, unet_config=ucfg, scheduler_config=scfg)
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    return tr


def _grads_close(got: dict, want: dict, floor: float = GRAD_FLOOR):
    """(worst error over tensors in units of the tensor's scale, its name):
    the scale is the tensor's max abs, floored at ``floor`` of the largest
    gradient of all."""
    largest = max(float(g.abs().max()) for g in want.values())
    worst, worst_name = 0.0, None
    for n, g in want.items():
        scale = max(float(g.abs().max()), floor * largest)
        r = float((got[n] - g).abs().max()) / scale
        if r > worst:
            worst, worst_name = r, n
    return worst, worst_name


def check_tiny_training(torch):
    """One step of the tiny LDM trainer (64 px, batch 2) with the same
    weights, images and draws on the card (kernels) and on the CPU (plain
    versions): the loss and every UNet gradient, within LOSS_RTOL and
    GRAD_RTOL."""
    import numpy as np
    from afldm_tpu_torch import train as T
    images = next(T.epoch_batches(T.SyntheticDataset(resolution=64,
                                                     length=2), 2))["input"]
    res = {}
    for dev in ("cuda", "cpu"):
        tr = _tiny_trainer(dev)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
        loss, logs = tr.loss_fn(x.to(dev), tr.draw(0, 2))
        loss.backward()
        res[dev] = ({k: float(v) for k, v in logs.items()},
                    {n: p.grad.detach().cpu()
                     for n, p in tr.unet.named_parameters()})
    (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
    d_loss = max(abs(lc[k] - lp[k]) / abs(lp[k]) for k in lp)
    worst, worst_name = _grads_close(gc, gp)
    ok = (all(np.isfinite(v) for v in lc.values()) and d_loss <= LOSS_RTOL
          and worst <= GRAD_RTOL)
    log(f"tiny training reference (card vs CPU, one step): losses "
        f"{json.dumps(lc)}; max loss rel err {d_loss:.2e} (limit "
        f"{LOSS_RTOL}), max grad err {worst:.2e} of its tensor's scale at "
        f"{worst_name} (limit {GRAD_RTOL}) {'ok' if ok else 'FAIL'}")
    return ok


def run_training(torch, n_steps):
    """The full-width LDM trainer of configs/ldm/train_unet_ffhq.json as it
    stands (``profile_main_path.ffhq_trainer``: the VAE from
    configs/vae/model_afvae.json, since vae_path holds no checkpoint;
    SyntheticDataset, since train_data_dir is absent; random weights)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.profile_main_path import ffhq_trainer
    t0 = time.perf_counter()
    tr, ds = ffhq_trainer(device="cuda", seed=0)
    base, cfg = tr.base_cfg, tr.cfg
    p0 = [p.detach().clone() for p in tr.unet.parameters()]
    batches = T.epoch_batches(ds, base.train_batch_size, seed=0)
    log(f"training: full-width LDM trainer built in "
        f"{time.perf_counter() - t0:.1f} s (UNet "
        f"{sum(p.numel() for p in p0) / 1e6:.1f}M params, batch "
        f"{base.train_batch_size}, {base.resolution} px, gradient "
        f"checkpointing {base.gradient_checkpointing} "
        f"({base.remat_policy}), EMA {cfg.use_ema}, shift loss "
        f"{cfg.use_shift_loss}, CFA {cfg.use_cross_attn})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for step in range(n_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        logs = tr.training_step(step, batch)  # floats: synchronises
        times.append(time.perf_counter() - t0)
        losses.append(logs)
        log(f"training step {step}: {time.perf_counter() - t0:.3f} s "
            f"{json.dumps(logs)} (lr of the next update {tr.opt.lr:.3g})")
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = times[1:] or times
    med = float(np.median(steady))
    log(f"training: median step {med:.3f} s over steps 1..{n_steps - 1} "
        f"({base.train_batch_size / med:.2f} images/s), first step "
        f"{times[0]:.3f} s, peak device memory {peak:.2f} GiB")
    log(f"training launches: {json.dumps(counts)}")
    moved = sum(not torch.equal(a, p)
                for a, p in zip(p0, tr.unet.parameters()))
    finite = all(np.isfinite(v) for d in losses for v in d.values())
    log(f"training: {moved} of {len(p0)} parameter tensors moved; losses "
        f"finite: {finite}")
    missing = [k for k in TRAINING_KERNELS if counts[k] == 0]
    if missing:
        log(f"training: FAIL, never launched: {missing}")
    ok = finite and moved == len(p0) and not missing
    if not ok:
        log("training: FAIL")
    return ok, counts


# the tiny AF-VAE of the card-vs-CPU step: every level filtered, so the
# 128 px level takes K1/K2 and the 64 and 32 px levels K5/K5b
TINY_VAE = dict(block_out_channels=[16, 16, 16], layers_per_block=1,
                latent_channels=4, norm_num_groups=8, sample_size=128,
                alias_free=True, down_filtered_act=[True, True, True],
                up_filtered_act=[True, True, True], up_rescale=[True, True])


def _tiny_vae_trainer(device):
    from afldm_tpu_torch import train as T
    base = T.BaseTrainingConfig(resolution=128, train_batch_size=2, seed=0)
    cfg = T.VAETrainingConfig(use_shift_loss=True, use_disc=True,
                              use_ema=True)
    tr = T.create_trainer("vae", base, cfg, device=device)
    tr.init_modules(vae_config=TINY_VAE,
                    disc_config={"depth": 3, "hidden_channels": 32})
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    return tr


def check_tiny_vae_training(torch):
    """One generator step (MSE + perceptual + KL + shift + adaptive-weight
    GAN term) and one discriminator step of the tiny AF-VAE trainer (128
    px, batch 2) with the same weights, images and draws on the card
    (kernels) and on the CPU (plain versions): the losses within LOSS_RTOL
    and every VAE, then every discriminator, gradient within GRAD_RTOL
    (the discriminator's scales floored at DISC_GRAD_FLOOR)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    images = next(T.epoch_batches(T.SyntheticDataset(resolution=128,
                                                     length=2), 2))["input"]
    res = {}
    for dev in ("cuda", "cpu"):
        tr = _tiny_vae_trainer(dev)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(dev)
        draws = tr.draw(0, 2)
        if dev == "cuda":
            kernels.reset_launch_counts()
        logs = tr.generator_backward(x, draws)
        logs.update(tr.disc_backward(x, draws))
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = dict(kernels.LAUNCHES)
        res[dev] = ({k: float(v) for k, v in logs.items()},
                    {n: p.grad.detach().cpu()
                     for n, p in tr.vae.named_parameters()},
                    {n: p.grad.detach().cpu()
                     for n, p in tr.disc.named_parameters()})
    (lc, gc, dc), (lp, gp, dp) = res["cuda"], res["cpu"]
    # relative to the loss, floored at 1e-2: the GAN term is a mean of
    # logits of either sign and may sit near 0
    d_loss = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-2) for k in lp)
    worst_g, name_g = _grads_close(gc, gp)
    worst_d, name_d = _grads_close(dc, dp, DISC_GRAD_FLOOR)
    missing = [k for k in VAE_TRAINING_KERNELS if launched[k] == 0]
    ok = (all(np.isfinite(v) for v in lc.values()) and d_loss <= LOSS_RTOL
          and worst_g <= GRAD_RTOL and worst_d <= GRAD_RTOL and not missing)
    log(f"tiny VAE training reference (card vs CPU, one generator and one "
        f"discriminator step): losses {json.dumps(lc)}; max loss rel err "
        f"{d_loss:.2e} (limit {LOSS_RTOL}), max VAE grad err {worst_g:.2e} "
        f"of its tensor's scale at {name_g}, max discriminator grad err "
        f"{worst_d:.2e} at {name_d} (limit {GRAD_RTOL}); launches "
        f"{json.dumps(launched)} {'ok' if ok else 'FAIL'}")
    return ok


def run_vae_training(torch, n_steps):
    """The full-width AF-VAE trainer of configs/vae/train_afvae_imagenet.json
    as it stands (``profile_main_path.afvae_trainer``: SyntheticDataset,
    since train_data_dir is absent; random weights)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.profile_main_path import afvae_trainer
    t0 = time.perf_counter()
    tr, ds = afvae_trainer(device="cuda", seed=0)
    base, cfg = tr.base_cfg, tr.cfg
    p0 = [p.detach().clone() for p in tr.vae.parameters()]
    batches = T.epoch_batches(ds, base.train_batch_size, seed=0)
    log(f"VAE training: full-width AF-VAE trainer built in "
        f"{time.perf_counter() - t0:.1f} s (VAE "
        f"{sum(p.numel() for p in p0) / 1e6:.1f}M params, batch "
        f"{base.train_batch_size}, {base.resolution} px, gradient "
        f"accumulation {cfg.gradient_accumulation_steps}, gradient "
        f"checkpointing {base.gradient_checkpointing}, shift loss "
        f"{cfg.use_shift_loss}, GAN {cfg.use_disc}, EMA {cfg.use_ema}, "
        f"lr {cfg.learning_rate} with {cfg.lr_warmup_steps} warmup updates)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for step in range(n_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        logs = tr.training_step(step, batch)  # floats: synchronises
        times.append(time.perf_counter() - t0)
        losses.append(logs)
        note = ""
        if tr.opt.micro_step == 0:  # an update was applied
            moved = sum(not torch.equal(a, p)
                        for a, p in zip(p0, tr.vae.parameters()))
            note = f"; {moved} of {len(p0)} tensors moved so far"
        log(f"VAE training micro-step {step}: {times[-1]:.3f} s "
            f"{json.dumps(logs)}{note}")
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(times[1:] or times))
    log(f"VAE training: median micro-step {med:.3f} s over micro-steps "
        f"1..{n_steps - 1} ({base.train_batch_size / med:.2f} images/s), "
        f"first {times[0]:.3f} s, peak device memory {peak:.2f} GiB")
    log(f"VAE training launches: {json.dumps(counts)}")
    moved = sum(not torch.equal(a, p)
                for a, p in zip(p0, tr.vae.parameters()))
    finite = all(np.isfinite(v) for d in losses for v in d.values())
    log(f"VAE training: {moved} of {len(p0)} parameter tensors moved after "
        f"{n_steps // cfg.gradient_accumulation_steps} updates; losses "
        f"finite: {finite}")
    missing = [k for k in VAE_TRAINING_KERNELS if counts[k] == 0]
    if missing:
        log(f"VAE training: FAIL, never launched: {missing}")
    ok = finite and moved == len(p0) and not missing
    if not ok:
        log("VAE training: FAIL")
    return ok, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the serving path (default 50)")
    ap.add_argument("--train_steps", type=int, default=4,
                    help="steps of the full-width training path (default 4)")
    ap.add_argument("--vae_steps", type=int, default=8,
                    help="micro-steps of the full-width VAE training path "
                         "(default 8: 4 updates, the first ones far into "
                         "the lr warmup)")
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
    torch.cuda.empty_cache()
    ok &= check_tiny_training(torch)
    train_ok, train_counts = run_training(torch, args.train_steps)
    ok &= train_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_vae_training(torch)
    vae_ok, vae_counts = run_vae_training(torch, args.vae_steps)
    ok &= vae_ok
    for k, row in report.items():
        row["launches"] = counts[k] + train_counts[k] + vae_counts[k]
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
