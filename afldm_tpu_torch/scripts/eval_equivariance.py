"""StyleGAN-3 equivariance of the AF-LDM generator: EQ-T and EQ-T_frac of
generate(z | T) = decode(denoise(T z)), where T translates the initial
latent (the ``ideal`` shifter at the latent rate) and cross-frame
attention is pinned: STORE on the untransformed call, LOAD on the
translated ones. Random weights from seed 0 unless ``--pipeline_dir``.

  python -m afldm_tpu_torch.scripts.eval_equivariance \\
      --out results/eq_torch.json                   # on the card
  python -m afldm_tpu_torch.scripts.eval_equivariance --tiny --device cpu \\
      --num_samples 2 --steps 2
"""

import argparse
import json
import time
from pathlib import Path

import torch

from .shift_ldm_ffhq import load_configs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--translate_max", type=float, default=0.125)
    p.add_argument("--pipeline_dir", default=None,
                   help="a directory this port's LDMTrainer.save_pipeline "
                        "wrote")
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA UNet (the flagship evaluation's)")
    p.add_argument("--out", default=None, help="write the metrics as JSON")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def build_pipeline(tiny=False, pipeline_dir=None, use_ema=False, device=None,
                   seed=0):
    """The FFHQ pipeline (or its tiny version) on random weights from
    ``seed``, or a saved pipeline."""
    from ..pipelines import init_random_pipeline, load_pipeline
    if pipeline_dir:
        return load_pipeline(pipeline_dir, device=device, use_ema=use_ema)
    return init_random_pipeline(*load_configs(tiny), seed=seed,
                                device=device)


def latent_draw(pipe, batch_size, seed=0):
    """``draw(batch_index) -> (batch_size, C, h, w)`` initial latents on
    the pipeline's device, from a CPU generator seeded ``seed + index``,
    so every call of one batch gets the same latents."""
    cfg = pipe.unet.config

    def draw(index):
        gen = torch.Generator().manual_seed(seed + index)
        return torch.randn((batch_size, cfg.in_channels, cfg.sample_size,
                            cfg.sample_size), generator=gen).to(pipe.device)
    return draw


def run(pipe, num_samples=8, batch_size=1, steps=20, translate_max=0.125,
        draw=None):
    """(EQ-T, EQ-T_frac) in dB over ``num_samples`` generations, the
    initial latents from ``draw(batch_index)`` (default ``latent_draw``)."""
    from ..shift.equivariance import compute_equivariance_metrics
    from ..shift.shifters import ImageShifter
    if draw is None:
        draw = latent_draw(pipe, batch_size)
    ratio = pipe.vae.config.downsample_ratio
    sample = pipe.unet.config.sample_size
    shifter = ImageShifter("ideal", upsample_ratio=ratio)
    kv_store = {}

    def generate(index, M):
        """M is the 3x3 input transform: its translation (M[0, 2],
        M[1, 2]), fractions of the image, applied to the latent."""
        z = draw(index)
        tx = -float(M[0, 2]) * sample  # latent pixels
        ty = -float(M[1, 2]) * sample
        if (tx, ty) != (0.0, 0.0):
            z = shifter.shift(z, ty, tx)[0]
            lat, _ = pipe.denoise(z, steps, kv_traj=kv_store[index])
        else:
            lat, kv_store[index] = pipe.denoise(z, steps, collect_kv=True)
        return pipe.decode(lat)

    return compute_equivariance_metrics(
        generate, num_samples, batch_size, sample * ratio,
        translate_max=translate_max, compute_eqt_int=True,
        compute_eqt_frac=True)


def main(argv=None):
    args = parse_args(argv)
    pipe = build_pipeline(args.tiny, args.pipeline_dir, args.use_ema,
                          args.device)
    t0 = time.perf_counter()
    eq_t, eq_t_frac = run(pipe, args.num_samples, args.batch_size,
                          args.steps, args.translate_max)
    wall = time.perf_counter() - t0
    print(f"EQ-T: {eq_t:.3f} dB  EQ-T_frac: {eq_t_frac:.3f} dB "
          f"({args.num_samples} samples, {args.steps} steps, {wall:.2f} s "
          f"wall on {pipe.device.type})")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "eq_t_db": round(float(eq_t), 3),
            "eq_t_frac_db": round(float(eq_t_frac), 3),
            "num_samples": args.num_samples, "steps": args.steps,
            "translate_max": args.translate_max, "use_ema": args.use_ema,
            "pipeline_dir": args.pipeline_dir}, indent=2))
    return float(eq_t), float(eq_t_frac)


if __name__ == "__main__":
    main()
