"""Where a main path's device time goes, under ``torch.profiler``, after an
untraced warm-up. ``--path serve``: one full-width
``shift_equivariance_eval`` (random weights, seed 0). ``--path train``:
``--train_steps`` steps of the full-width LDM trainer of
``configs/ldm/train_unet_ffhq.json`` (``ffhq_trainer``). ``--path
vae_train``: ``--train_steps`` micro-steps of the full-width AF-VAE trainer
of ``configs/vae/train_afvae_imagenet.json`` (``afvae_trainer``). ``--path
interp``: the full-width SD image interpolation of the CLI
(``scripts/image_interpolation.py``: random weights from seed 0, its
synthetic 512 px pair and Lucas-Kanade flow) of ``--frames`` frames with
``--steps`` DDIM steps; the flow is estimated once, outside the runs. Prints
the device time by kernel name (top 25, and every one of the port's
kernels) and by group (the port's kernels, convolutions, GEMMs, FFTs,
...), the sum of device time against the traced
wall time, and the wall time of the untraced run.

  python -m afldm_tpu_torch.scripts.profile_main_path --steps 50
  python -m afldm_tpu_torch.scripts.profile_main_path --path train
  python -m afldm_tpu_torch.scripts.profile_main_path --path train \
      --mixed_precision bf16
  python -m afldm_tpu_torch.scripts.profile_main_path --path vae_train
  python -m afldm_tpu_torch.scripts.profile_main_path --path interp --steps 10
"""

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

CONFIGS = Path(__file__).resolve().parents[2] / "configs"


def ffhq_trainer(device=None, seed: int = 0, mixed_precision=None):
    """The LDM trainer of ``configs/ldm/train_unet_ffhq.json`` as it stands,
    prepared with random weights from ``seed``, and its dataset. The
    config's vae_path holds no checkpoint in the repository, so the VAE is
    built from ``configs/vae/model_afvae.json``; without train_data_dir
    ``make_dataset`` gives SyntheticDataset. ``mixed_precision="bf16"``
    makes it the JAX package's flagship LDM run (``scripts/flagship_ab.py``
    trains this UNet at bf16 with gradient checkpointing, the shift loss,
    CFA and EMA). Returns (trainer, dataset)."""
    from .. import train as T
    cfgs = T.load_training_config(str(CONFIGS / "ldm" /
                                      "train_unet_ffhq.json"))
    base, cfg = cfgs["base"], cfgs["ldm"]
    if mixed_precision is not None:
        base.mixed_precision = mixed_precision
    root = CONFIGS.parent
    cfg.unet_config = str(root / cfg.unet_config)
    cfg.scheduler_path = str(root / cfg.scheduler_path)
    tr = T.create_trainer("ldm", base, cfg, device=device)
    tr.init_modules(vae_config=json.loads(
        (CONFIGS / "vae" / "model_afvae.json").read_text()))
    ds = T.make_dataset(base)
    tr.init_optimizers(len(ds) // base.train_batch_size * base.num_epochs)
    tr.prepare_modules(seed=seed)
    return tr, ds


def i2sb_trainer(device=None, seed: int = 0, mixed_precision=None):
    """The I2SB trainer of ``configs/sr/train_i2sb_imagenet.json`` as it
    stands (the FFHQ UNet of ``configs/ldm/model_unet.json``, batch 16 at
    256 px, CFA shift loss), prepared with random weights from ``seed``,
    and its dataset. Its vae_path holds no checkpoint in the repository,
    so the VAE is built from ``configs/vae/model_afvae.json``; without
    train_data_dir ``make_dataset`` gives SyntheticDataset. Returns
    (trainer, dataset); ``mixed_precision`` replaces the config's."""
    from .. import train as T
    cfgs = T.load_training_config(str(CONFIGS / "sr" /
                                      "train_i2sb_imagenet.json"))
    base, cfg = cfgs["base"], cfgs["i2sb"]
    if mixed_precision is not None:
        base.mixed_precision = mixed_precision
    root = CONFIGS.parent
    cfg.unet_config = str(root / cfg.unet_config)
    cfg.scheduler_path = str(root / cfg.scheduler_path)
    tr = T.create_trainer("i2sb", base, cfg, device=device)
    tr.init_modules(vae_config=json.loads(
        (CONFIGS / "vae" / "model_afvae.json").read_text()))
    ds = T.make_dataset(base)
    tr.init_optimizers(len(ds) // base.train_batch_size * base.num_epochs)
    tr.prepare_modules(seed=seed)
    return tr, ds


def afvae_trainer(device=None, seed: int = 0, af_precision=None,
                  mixed_precision=None):
    """The VAE trainer of ``configs/vae/train_afvae_imagenet.json`` as it
    stands (the AF-VAE of ``model_afvae.json`` at 256 px, batch 4, shift
    loss, no GAN, gradient accumulation 2), prepared with random weights
    from ``seed``, and its dataset: without its train_data_dir
    ``make_dataset`` gives SyntheticDataset. ``af_precision`` replaces the
    config's level of the circulant products, ``mixed_precision`` its
    mixed precision. Returns (trainer, dataset)."""
    from .. import train as T
    cfgs = T.load_training_config(str(CONFIGS / "vae" /
                                      "train_afvae_imagenet.json"))
    base, cfg = cfgs["base"], cfgs["vae"]
    if af_precision is not None:
        base.af_precision = af_precision
    if mixed_precision is not None:
        base.mixed_precision = mixed_precision
    cfg.model_cfg = str(CONFIGS.parent / cfg.model_cfg)
    tr = T.create_trainer("vae", base, cfg, device=device)
    tr.init_modules()
    ds = T.make_dataset(base)
    tr.init_optimizers(len(ds) // base.train_batch_size * base.num_epochs)
    tr.prepare_modules(seed=seed)
    return tr, ds


def _serve_run(args):
    from ..pipelines import init_random_pipeline, shift_equivariance_eval
    from .shift_ldm_ffhq import load_configs
    pipe = init_random_pipeline(*load_configs(), seed=0)

    def run():
        gen = torch.Generator(pipe.device).manual_seed(0)
        shift_equivariance_eval(pipe, generator=gen,
                                num_inference_steps=args.steps,
                                num_shift_steps=16)
    return run


def _train_run(args):
    from ..train import epoch_batches
    tr, ds = ffhq_trainer(mixed_precision=args.mixed_precision)
    batches = epoch_batches(ds, tr.base_cfg.train_batch_size, seed=0)

    def run():
        for _ in range(args.train_steps):
            tr.training_step(tr.step, next(batches))
    return run


def _vae_train_run(args):
    from ..train import epoch_batches
    tr, ds = afvae_trainer(mixed_precision=args.mixed_precision)
    batches = epoch_batches(ds, tr.base_cfg.train_batch_size, seed=0)
    step = [0]

    def run():
        for _ in range(args.train_steps):
            tr.training_step(step[0], next(batches))
            step[0] += 1
    return run


def _interp_run(args):
    from ..pipelines import init_random_interp_pipeline
    from ..shift.simple_flow import predict_flow
    from .image_interpolation import image_pair, load_configs
    pipe = init_random_interp_pipeline(*load_configs(), seed=0)
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    img0, img1 = (t.to(pipe.device) for t in image_pair(res))
    flows = predict_flow(img0, img1)

    def run():
        pipe(img0, img1, num_frames=args.frames,
             num_inference_steps=args.steps,
             generator=torch.Generator().manual_seed(1), flows=flows)
    return run


# kernel-name groups of the breakdown, first match wins. cuDNN runs some
# f32 convolutions as FFT tiles (r2c, a complex GEMM, c2r), which land in
# "FFT and complex GEMM" with torch.fft's own kernels
# (the banded chains K1 and K2 run as filtered_gemm_kernel launches)
PORT_KERNELS = ("filtered_act", "filtered_gemm", "flash_", "flash2_")
GROUPS = (("port kernels", PORT_KERNELS),
          ("FFT and complex GEMM", ("fft", "cf32")),
          ("convolution", ("conv", "cudnn", "implicit", "winograd", "wgrad",
                           "dgrad", "fprop")),
          ("GEMM", ("gemm", "cutlass", "gemv")),
          ("norm", ("norm", "welford")),
          ("reduce", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized")))


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)),
                "other")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["serve", "train", "vae_train",
                                       "interp"], default="serve")
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the serving and interp paths")
    ap.add_argument("--frames", type=int, default=17,
                    help="frames of the interp path")
    ap.add_argument("--train_steps", type=int, default=2,
                    help="training (micro-)steps per run (warm-up and "
                         "traced)")
    ap.add_argument("--mixed_precision", choices=["bf16"], default=None,
                    help="the train and vae_train paths' mixed_precision "
                         "(default: the config's)")
    args = ap.parse_args(argv)
    body = {"serve": _serve_run, "train": _train_run,
            "vae_train": _vae_train_run,
            "interp": _interp_run}[args.path](args)

    def run():
        body()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        traced_wall = time.perf_counter() - t0

    rows = {}  # device-side events only: each kernel counted once
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (e.self_device_time_total / 1e3, e.count)
    total = sum(ms for ms, _ in rows.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"path {args.path}: untraced wall {wall:.3f} s; traced wall "
          f"{traced_wall:.3f} s; device time {total / 1e3:.3f} s "
          f"({100 * total / 1e3 / traced_wall:.1f}% of traced wall)")
    ours = {k: v for k, v in rows.items()
            if any(p in k for p in PORT_KERNELS)}
    ours_ms = sum(ms for ms, _ in ours.values())
    print(f"port kernels: {ours_ms:.1f} ms ({100 * ours_ms / total:.1f}% of "
          f"device time)")
    for k, (ms, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        print(f"port kernel {ms:10.2f} ms {100 * ms / total:5.1f}% {n:7d}x  "
              f"{k[:110]}")
    groups = {}
    for k, (ms, _) in rows.items():
        groups[group_of(k)] = groups.get(group_of(k), 0.0) + ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"group {g}: {ms:.1f} ms ({100 * ms / total:.1f}%)")
    for k, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{ms:10.2f} ms {100 * ms / total:5.1f}% {n:7d}x  {k[:110]}")
    print(json.dumps({"path": args.path, "wall_s": wall,
                      "traced_wall_s": traced_wall,
                      "device_s": total / 1e3, "port_kernels_ms": ours_ms,
                      "groups_ms": groups}))


if __name__ == "__main__":
    main()
