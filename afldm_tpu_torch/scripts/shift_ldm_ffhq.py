"""FFHQ-256 fractional-shift equivariance test on random weights: denoise a
latent with cross-frame attention in STORE mode, denoise the 1/8..k/8 px
latent shifts in one LOAD pass, decode, and print the masked PSNR per
shift.

  python -m afldm_tpu_torch.scripts.shift_ldm_ffhq --num_inference_steps 50 \\
      --shift_steps 16                      # on the card
  python -m afldm_tpu_torch.scripts.shift_ldm_ffhq --tiny --device cpu \\
      --num_inference_steps 2 --shift_steps 2
  python -m afldm_tpu_torch.scripts.shift_ldm_ffhq --af_precision high
  python -m afldm_tpu_torch.scripts.shift_ldm_ffhq --bf16

``--af_precision`` sets the level of the circulant products for the run
(``ops.set_af_precision``). ``--bf16`` runs the UNet and the VAE in
bfloat16 (float32 weights; the circulant and FFT islands filter in
float32 and return bf16; latents, the sampler and the PSNR stay float32),
``ops.set_af_bf16_split`` as set by the caller.
"""

import argparse
import json
from pathlib import Path

import torch

CONFIGS = Path(__file__).resolve().parents[2] / "configs"

# --tiny: the reduced model of the JAX script, for smoke runs
TINY_UNET = dict(sample_size=8, block_out_channels=[32, 64],
                 down_block_types=["AttnDownBlock2D", "DownBlock2D"],
                 up_block_types=["UpBlock2D", "AttnUpBlock2D"],
                 layers_per_block=1, attention_head_dim=8, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=[16, 16, 16, 16], layers_per_block=1,
                norm_num_groups=8, down_filtered_act=[False, True, True, True])


def load_configs(tiny: bool = False):
    """(unet, vae, scheduler) config dicts of the FFHQ pipeline."""
    def read(rel):
        return json.loads((CONFIGS / rel).read_text())
    ucfg = read("ldm/model_unet.json")
    vcfg = read("vae/model_afvae.json")
    scfg = read("ldm/noise_scheduler.json")
    if tiny:
        ucfg.update(TINY_UNET)
        vcfg.update(TINY_VAE)
    return ucfg, vcfg, scfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--shift_steps", type=int, default=16)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--af_precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="circulant products' level: 'highest' exact f32, "
                        "'high' 3 bf16 passes, 'default' 1")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the UNet and the VAE")
    return p.parse_args(argv)


def build(args):
    """The pipeline of the parsed flags: random weights from seed 0, the
    level set, the compute dtype bf16 with ``--bf16``."""
    from ..pipelines import init_random_pipeline
    return init_random_pipeline(
        *load_configs(args.tiny), seed=0, device=args.device,
        af_precision=args.af_precision,
        dtype=torch.bfloat16 if args.bf16 else torch.float32)


def evaluate(pipe, args):
    """The protocol on ``pipe`` from seed 0's latent."""
    from ..pipelines import shift_equivariance_eval
    gen = torch.Generator(pipe.device).manual_seed(0)
    return shift_equivariance_eval(
        pipe, generator=gen, num_inference_steps=args.num_inference_steps,
        num_shift_steps=args.shift_steps)


def main(argv=None):
    args = parse_args(argv)
    pipe = build(args)
    res = evaluate(pipe, args)
    ratio = pipe.vae.config.downsample_ratio
    for k, p in enumerate(res.psnrs, 1):
        print(f"shift {k}/{ratio} px: masked PSNR {p:.3f} dB")
    print(f"mean shift-equivariance PSNR: {res.mean_psnr:.3f} dB")
    return res


if __name__ == "__main__":
    main()
