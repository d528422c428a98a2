"""Image interpolation by flow-warped noise and cross-frame-attention
blending on random weights: the alias-free SD-family UNet
(``UNet2DConditionConfig(alias_free=True)``: SD-1.5 widths, 64×64 latents)
with the AF-VAE of ``configs/vae/model_afvae.json`` at 512 px, between a
synthetic image pair (a blocky random image and its copy rolled by 1/8 of
the width). The flow comes from the built-in Lucas-Kanade estimator or from
``--flow_npz``. Writes the frames as one (frames, H, W, 3) ``.npy`` in
[0, 1].

  python -m afldm_tpu_torch.scripts.image_interpolation      # on the card
  python -m afldm_tpu_torch.scripts.image_interpolation --tiny --device cpu \\
      --num_frames 3 --num_inference_steps 2
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

CONFIGS = Path(__file__).resolve().parents[2] / "configs"

# the JAX script's scheduler (SD 1.5's)
SD_DDIM = dict(beta_end=0.012, beta_schedule="scaled_linear",
               beta_start=0.00085, clip_sample=False,
               num_train_timesteps=1000, set_alpha_to_one=False,
               steps_offset=1, timestep_spacing="leading")
# --tiny: the reduced models of the JAX script, for smoke runs
TINY_UNET = dict(sample_size=8, block_out_channels=[16, 32],
                 down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                 up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"],
                 layers_per_block=1, attention_head_dim=2,
                 cross_attention_dim=16, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=[8, 8, 8, 8], layers_per_block=1,
                norm_num_groups=4, down_filtered_act=[False, True, True, True])


def load_configs(tiny: bool = False):
    """(unet, vae, scheduler) config dicts of the interpolation pipeline;
    the UNet dict holds only what differs from the config's defaults."""
    vcfg = json.loads((CONFIGS / "vae" / "model_afvae.json").read_text())
    ucfg = {}
    if tiny:
        ucfg = dict(TINY_UNET)
        vcfg.update(TINY_VAE)
    return ucfg, vcfg, dict(SD_DDIM)


def image_pair(res: int):
    """The JAX script's synthetic pair, (1, 3, res, res) each in [-1, 1]."""
    rng = np.random.default_rng(0)
    low = np.tanh(rng.standard_normal((res // 8, res // 8, 3)))
    base = np.kron(low, np.ones((8, 8, 1)))
    pair = (base, np.roll(base, res // 8, axis=1))
    return tuple(torch.from_numpy(p[None].astype(np.float32))
                 .permute(0, 3, 1, 2).contiguous() for p in pair)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_frames", type=int, default=17)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--output_path", default="results/interpolation.npy")
    p.add_argument("--flow_npz", default=None,
                   help=".npz with fwd_flow/fwd_occ/bwd_flow/bwd_occ, "
                        "(1, 2|1, H, W) each")
    p.add_argument("--no_slerp", action="store_true")
    p.add_argument("--decode_chunk", type=int, default=None,
                   help="decode this many frames at a time")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--gmflow_ckpt", default=None,
                   help="not ported: the GMFlow checkpoint is not in the "
                        "repository")
    p.add_argument("--shard_frames", action="store_true",
                   help="not ported: frame sharding needs the multi-card "
                        "layer")
    return p.parse_args(argv)


def main(argv=None):
    from ..pipelines import init_random_interp_pipeline
    from ..shift.simple_flow import predict_flow
    args = parse_args(argv)
    if args.gmflow_ckpt:
        raise NotImplementedError(
            "--gmflow_ckpt: GMFlow is not ported (its checkpoint is not in "
            "the repository); the built-in Lucas-Kanade flow is the default")
    if args.shard_frames:
        raise NotImplementedError(
            "--shard_frames: frame sharding over several cards is not "
            "ported; the frames run batched on one card")
    pipe = init_random_interp_pipeline(*load_configs(args.tiny), seed=0,
                                       device=args.device)
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    img0, img1 = (t.to(pipe.device) for t in image_pair(res))
    t0 = time.perf_counter()
    if args.flow_npz:
        z = np.load(args.flow_npz)
        flows = tuple(torch.from_numpy(z[k]).float() for k in
                      ("fwd_flow", "fwd_occ", "bwd_flow", "bwd_occ"))
    else:
        flows = predict_flow(img0, img1)
    frames = pipe(img0, img1, num_frames=args.num_frames,
                  num_inference_steps=args.num_inference_steps,
                  generator=torch.Generator().manual_seed(1), flows=flows,
                  use_slerp=not args.no_slerp,
                  decode_chunk=args.decode_chunk)
    wall = time.perf_counter() - t0
    out = Path(args.output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, frames)
    peak = ""
    if pipe.device.type == "cuda":
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"interpolated {len(frames)} frames at {res} px in {wall:.2f} s "
          f"(flow to decode, {args.num_inference_steps} steps){peak} "
          f"-> {out}")
    return frames


if __name__ == "__main__":
    main()
