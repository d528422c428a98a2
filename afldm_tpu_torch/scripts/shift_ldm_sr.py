"""Latent-I2SB super-resolution shift-equivariance test: degrade the input
4x (bicubic, then nearest re-upsample), encode it (posterior mean) as the
bridge start, run the I2SB ODE (the final step skipped) with cross-frame
attention in STORE mode, denoise the 1/8..k/8 px latent shifts in one LOAD
pass, decode, and print the masked PSNR per shift. The input is the JAX
script's synthetic image (blocky tanh noise, seed 0). Writes the frames
(output, target, |output - target| stacked along the height, per shift) as
one (shifts, 3H, W, 3) ``.npy`` in [0, 1].

  python -m afldm_tpu_torch.scripts.shift_ldm_sr                 # on the card
  python -m afldm_tpu_torch.scripts.shift_ldm_sr --tiny --device cpu \\
      --num_inference_steps 2 --shift_steps 2
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .image_interpolation import image_pair
from .shift_ldm_ffhq import CONFIGS, load_configs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--shift_steps", type=int, default=16)
    p.add_argument("--output_path", default="results/shift_sr.npy")
    p.add_argument("--pipeline_dir", default=None,
                   help="a directory this port's LDMTrainer.save_pipeline "
                        "wrote")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def i2sb_scheduler_config():
    return json.loads((CONFIGS / "sr" / "i2sb_scheduler.json").read_text())


def build_pipeline(tiny=False, pipeline_dir=None, device=None, seed=0):
    """The I2SB pipeline: the FFHQ UNet and AF-VAE (or their tiny
    versions) on random weights from ``seed``, or a saved pipeline; the
    scheduler of ``configs/sr/i2sb_scheduler.json``."""
    from ..pipelines import (I2SBLDMPipeline, init_random_pipeline,
                             load_pipeline)
    if pipeline_dir:
        return load_pipeline(pipeline_dir, cls=I2SBLDMPipeline,
                             device=device,
                             scheduler_config=i2sb_scheduler_config())
    ucfg, vcfg, _ = load_configs(tiny)
    return init_random_pipeline(ucfg, vcfg, i2sb_scheduler_config(),
                                seed=seed, device=device,
                                cls=I2SBLDMPipeline)


def run(pipe, num_inference_steps=50, shift_steps=16):
    """Degrade the synthetic input, encode it and run the shift protocol.
    Returns the ``ShiftEvalResult``."""
    from ..pipelines import shift_equivariance_eval
    from ..train.i2sb_trainer import degrade_sr4x
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    img = image_pair(res)[0].to(pipe.device)
    init_latent = pipe.encode(degrade_sr4x(img))
    return shift_equivariance_eval(pipe, init_latent=init_latent,
                                   num_inference_steps=num_inference_steps,
                                   num_shift_steps=shift_steps)


def main(argv=None):
    args = parse_args(argv)
    pipe = build_pipeline(args.tiny, args.pipeline_dir, args.device)
    t0 = time.perf_counter()
    res = run(pipe, args.num_inference_steps, args.shift_steps)
    wall = time.perf_counter() - t0
    frames = np.concatenate([res.outputs, res.targets,
                             np.abs(res.outputs - res.targets)], axis=1)
    out = Path(args.output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, np.clip(frames / 2 + 0.5, 0, 1))
    ratio = pipe.vae.config.downsample_ratio
    for k, p in enumerate(res.psnrs, 1):
        print(f"shift {k}/{ratio} px: masked PSNR {p:.3f} dB")
    peak = ""
    if pipe.device.type == "cuda":
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"mean shift-equivariance PSNR: {res.mean_psnr:.3f} dB "
          f"({wall:.2f} s wall{peak})")
    print(f"wrote {out}")
    return res


if __name__ == "__main__":
    main()
