"""Accuracy cost of the reduced af_precision levels on the shift-equivariance
protocol: the same protocol (one initial latent from ``--seed``, DDIM
denoise, the 1/8..k/8 px latent shifts in one LOAD pass, masked PSNR per
shift) once at 'highest', the golden arm, and once at each other level,
each on a fresh pipeline, and the mean PSNR's difference from 'highest'.
Random weights from seed 0 unless ``--pipeline_dir``.

  python -m afldm_tpu_torch.scripts.eval_af_precision \\
      --precisions highest,high,default                 # on the card
  python -m afldm_tpu_torch.scripts.eval_af_precision --tiny --device cpu \\
      --eval_steps 2 --shift_steps 2

Writes the JSON keys of the JAX package's ``scripts/eval_af_precision.py``:
per level ``mean_masked_psnr`` and ``psnrs``, ``<level>_minus_highest_db``,
``within_0p1_db`` (for 'high'), ``eval_steps`` and ``shift_steps``.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .shift_ldm_ffhq import load_configs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pipeline_dir", default=None,
                   help="a directory this port's LDMTrainer.save_pipeline "
                        "wrote (its EMA UNet where saved)")
    p.add_argument("--eval_steps", type=int, default=50)
    p.add_argument("--shift_steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--precisions", default="highest,high",
                   help="comma list from {highest,high,default}; 'highest' "
                        "is always prepended as the golden arm")
    p.add_argument("--out", default="results/af_precision_eval_torch.json")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def build_pipeline(level, tiny=False, pipeline_dir=None, device=None):
    """A fresh pipeline at ``level``: random weights from seed 0 (the FFHQ
    pipeline or its tiny version), or a saved one."""
    from ..pipelines import init_random_pipeline, load_pipeline
    if pipeline_dir:
        return load_pipeline(pipeline_dir, device=device, use_ema=True,
                             af_precision=level)
    return init_random_pipeline(*load_configs(tiny), seed=0, device=device,
                                af_precision=level)


def eval_level(level, eval_steps=50, shift_steps=8, seed=7, tiny=False,
               pipeline_dir=None, device=None):
    """The protocol at ``level`` on a fresh pipeline; the initial latent
    from a CPU generator seeded ``seed``, the same at every level. The
    level is reset to 'highest' afterwards, whatever happens."""
    from ..ops import set_af_precision
    from ..pipelines import shift_equivariance_eval
    try:
        pipe = build_pipeline(level, tiny, pipeline_dir, device)
        cfg = pipe.unet.config
        lat = torch.randn((1, cfg.in_channels, cfg.sample_size,
                           cfg.sample_size),
                          generator=torch.Generator().manual_seed(seed))
        return shift_equivariance_eval(
            pipe, init_latent=lat, num_inference_steps=eval_steps,
            num_shift_steps=shift_steps, batch_shifts=True)
    finally:
        set_af_precision("highest")


def summarize(psnrs: dict, eval_steps: int, shift_steps: int) -> dict:
    """The JAX script's JSON rows from {level: per-shift PSNRs}."""
    rows = {}
    for level, p in psnrs.items():
        p = np.asarray(p, np.float64)
        rows[level] = {"mean_masked_psnr": round(float(p.mean()), 4),
                       "psnrs": [round(float(v), 3) for v in p]}
    for level in psnrs:
        if level != "highest":
            rows[f"{level}_minus_highest_db"] = round(
                rows[level]["mean_masked_psnr"]
                - rows["highest"]["mean_masked_psnr"], 4)
    if "high" in rows:
        rows["within_0p1_db"] = abs(rows["high_minus_highest_db"]) <= 0.1
    rows["eval_steps"] = eval_steps
    rows["shift_steps"] = shift_steps
    return rows


def main(argv=None):
    args = parse_args(argv)
    levels = [s.strip() for s in args.precisions.split(",") if s.strip()]
    if "highest" not in levels:
        levels.insert(0, "highest")
    psnrs = {level: eval_level(level, args.eval_steps, args.shift_steps,
                               args.seed, args.tiny, args.pipeline_dir,
                               args.device).psnrs
             for level in levels}
    rows = summarize(psnrs, args.eval_steps, args.shift_steps)
    print(json.dumps(rows, indent=2))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
