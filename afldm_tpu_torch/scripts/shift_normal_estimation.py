"""Normal-estimation shift sweep on random weights: the alias-free SD-family
UNet (``UNet2DConditionConfig(alias_free=True)``: SD-1.5 widths, 64×64
latents) with the latent ControlNet of ``ControlNetConfig.from_unet_config``
and the AF-VAE of ``configs/vae/model_afvae.json`` at 512 px. YOSO (one
step at t = 999 from a zero latent) or, with ``--no_yoso``, the multi-step
DDIM branch; the start latent and the condition latent shift together by
1/8 .. ``--shift_steps``/8 latent px, and each shifted output is scored by
masked PSNR against the pixel-shifted base output. The input is a ``.npy``
image ((H, W, 3) in [0, 1], at 512 px) or a synthetic blocky pattern.
``--pipeline_dir`` takes the UNet, ControlNet and VAE (and text encoder)
of a pipeline directory instead, as ``load_sd_components`` reads it.
Prints the PSNRs; writes the normals, (1 + shifts, H, W, 3) in [0, 1], and
beside them ``<name>_diffs.npy``, the absolute difference of each shifted
output from the shifted base.

  python -m afldm_tpu_torch.scripts.shift_normal_estimation   # on the card
  python -m afldm_tpu_torch.scripts.shift_normal_estimation --tiny \\
      --device cpu --shift_steps 2
"""

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..shift.shifters import ImageShifter
from .image_interpolation import load_configs as _sd_configs

# the JAX script's scheduler: DDIMScheduler(num_train_timesteps=1000)
NORMAL_DDIM = dict(num_train_timesteps=1000)


def load_configs(tiny: bool = False):
    """(unet, vae, scheduler) config dicts of the normal-estimation
    pipeline (the SD UNet and AF-VAE of the image interpolation)."""
    ucfg, vcfg, _ = _sd_configs(tiny)
    return ucfg, vcfg, dict(NORMAL_DDIM)


def synthetic_image(res: int) -> torch.Tensor:
    """The JAX script's input: tanh of a blocky gaussian image, (1, 3,
    res, res) in [-1, 1]."""
    rng = np.random.default_rng(0)
    low = rng.standard_normal((res // 8, res // 8, 3))
    img = np.tanh(np.kron(low, np.ones((8, 8, 1))))[None].astype(np.float32)
    return torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shift_steps", type=int, default=16)
    p.add_argument("--output_path", default="results/shift_normal.npy")
    p.add_argument("--input_path", default=None,
                   help=".npy image, (H, W, 3) in [0, 1] at the model's "
                        "resolution")
    p.add_argument("--no_yoso", action="store_true",
                   help="the multi-step DDIM branch")
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--guess_mode", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the multi-step branch's start noise")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--pipeline_dir", default=None,
                   help="a pipeline directory (load_sd_components' layout) "
                        "whose UNet, ControlNet and VAE to use")
    return p.parse_args(argv)


def build_pipeline(tiny=False, pipeline_dir=None, device=None):
    """The normal-estimation pipeline: random weights from seed 0 on the
    CLI's configs, or the UNet, ControlNet and VAE of ``pipeline_dir``
    (``load_sd_components``; its text encoder too, where it has one),
    with the JAX script's DDIM. A directory without a ControlNet
    raises."""
    from ..pipelines import (NormControlPipeline, init_random_normal_pipeline,
                             load_sd_components)
    from ..schedulers import DDIMScheduler
    if not pipeline_dir:
        return init_random_normal_pipeline(*load_configs(tiny), seed=0,
                                           device=device)
    parts = load_sd_components(pipeline_dir, device=device)
    if "controlnet" not in parts:
        raise FileNotFoundError(
            f"{pipeline_dir!r} holds no controlnet_config.json: normal "
            "estimation needs a ControlNet")
    return NormControlPipeline(parts["vae"], parts["unet"],
                               parts["controlnet"],
                               DDIMScheduler.from_config(NORMAL_DDIM),
                               text_encoder=parts.get("text_encoder"))


def main(argv=None):
    args = parse_args(argv)
    pipe = build_pipeline(args.tiny, args.pipeline_dir, args.device)
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    if args.input_path:
        img = np.load(args.input_path).astype(np.float32)
        if img.shape != (res, res, 3):
            raise ValueError(f"{args.input_path}: shape {img.shape}, "
                             f"expected ({res}, {res}, 3)")
        image = torch.from_numpy(img * 2 - 1).permute(2, 0, 1)[None]
    else:
        image = synthetic_image(res)
    t0 = time.perf_counter()
    out = pipe(image, num_shift_steps=args.shift_steps,
               is_yoso=not args.no_yoso,
               generator=torch.Generator().manual_seed(args.seed),
               num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale,
               guess_mode=args.guess_mode)
    wall = time.perf_counter() - t0

    normals = np.clip(out.normals / 2 + 0.5, 0, 1)
    base = torch.from_numpy(normals[0:1]).permute(0, 3, 1, 2)
    shifter = ImageShifter()
    diffs = np.stack([
        np.abs(normals[k] - shifter.shift(base, 0.0, float(k))[0][0]
               .permute(1, 2, 0).numpy())
        for k in range(1, args.shift_steps + 1)])
    path = Path(args.output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, normals)
    np.save(path.with_name(path.stem + "_diffs.npy"), diffs)

    for k, p in enumerate(out.psnrs, 1):
        print(f"shift {k}/8 px: masked PSNR {p:.3f} dB")
    print(f"mean shift-equivariance PSNR: {out.mean_psnr:.3f} dB")
    peak = ""
    if pipe.device.type == "cuda":
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mode = ("YOSO" if not args.no_yoso
            else f"{args.num_inference_steps} DDIM steps")
    print(f"estimated {len(normals)} normal maps at {res} px in {wall:.2f} s "
          f"({mode}){peak} -> {path}")
    return out


if __name__ == "__main__":
    main()
