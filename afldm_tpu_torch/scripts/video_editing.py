"""Video editing with cross-frame attention on random weights: the
alias-free SD-family UNet (``UNet2DConditionConfig(alias_free=True)``:
SD-1.5 widths, 64×64 latents; ``--no_af`` the vanilla one) with the AF-VAE
of ``configs/vae/model_afvae.json`` at 512 px and SD 1.5's DDIM, editing
the frames of ``--input_video`` (a directory of ``.npy`` frames, each
(H, W, 3) in [0, 1], resized to 512 px) or a synthetic translating pattern.
SDEdit at ``--strength`` or, with ``--use_inversion``, DDIM inversion; the
prompts are zero embeddings (the port has no text encoder). Writes the
frames as one (frames, H, W, 3) ``.npy`` in [0, 1].

  python -m afldm_tpu_torch.scripts.video_editing          # on the card
  python -m afldm_tpu_torch.scripts.video_editing --tiny --device cpu \\
      --num_inference_steps 2 --max_frames 2
"""

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .image_interpolation import load_configs


def synthetic_frames(size: int, n: int) -> np.ndarray:
    """The JAX script's translating pattern: a blocky random image rolled
    2 px further along the width each frame, (n, size, size, 3) in
    [-1, 1]."""
    rng = np.random.default_rng(0)
    low = np.tanh(rng.standard_normal((size // 8, size // 8, 3)))
    base = np.kron(low, np.ones((8, 8, 1)))
    return np.stack([np.roll(base, i * 2, axis=1)
                     for i in range(n)]).astype(np.float32)


def load_frames(path, size: int, max_frames: int) -> torch.Tensor:
    """(frames, 3, size, size) in [-1, 1]: the first ``max_frames``
    ``.npy`` files of the directory ``path`` in name order (bicubic
    resize where their size differs), or the synthetic pattern."""
    if path is None:
        frames = torch.from_numpy(synthetic_frames(size, max_frames))
        return frames.permute(0, 3, 1, 2).contiguous()
    path = Path(path)
    if not path.is_dir():
        raise ValueError(f"--input_video {path}: pass a directory of .npy "
                         f"frames (video files are not read)")
    files = sorted(path.glob("*.npy"))[:max_frames]
    if not files:
        raise ValueError(f"no .npy frames in {path}")
    out = []
    for f in files:
        img = torch.from_numpy(np.load(f).astype(np.float32))
        img = img.permute(2, 0, 1)[None] * 2 - 1
        if img.shape[-2:] != (size, size):
            img = F.interpolate(img, size=(size, size), mode="bicubic",
                                align_corners=False, antialias=True)
        out.append(img)
    return torch.cat(out)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_video", default=None,
                   help="directory of .npy frames, (H, W, 3) in [0, 1]")
    p.add_argument("--prompt", default="a video")
    p.add_argument("--n_prompt", default="")
    p.add_argument("--strength", type=float, default=0.7)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--max_frames", type=int, default=8)
    p.add_argument("--use_inversion", action="store_true")
    p.add_argument("--no_af", action="store_true",
                   help="vanilla (non-alias-free) backbone")
    p.add_argument("--output_path", default="results/video_edit.npy")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models for smoke runs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--pipeline_dir", default=None,
                   help="refused: the JAX CLI parses it and never reads it")
    p.add_argument("--shard_frames", action="store_true",
                   help="not ported: frame sharding needs the multi-card "
                        "layer")
    return p.parse_args(argv)


def main(argv=None):
    from ..pipelines import init_random_video_editing_pipeline
    args = parse_args(argv)
    if args.pipeline_dir:
        raise NotImplementedError(
            "--pipeline_dir: the JAX video-editing CLI parses this flag and "
            "never reads it, so there is no behaviour to port (ROADMAP "
            "Queue 3); the pipeline runs on random weights")
    if args.shard_frames:
        raise NotImplementedError(
            "--shard_frames: frame sharding over several cards is not "
            "ported (ROADMAP Queue 1 item 9); the frames run batched on "
            "one card")
    ucfg, vcfg, scfg = load_configs(args.tiny)
    ucfg["alias_free"] = not args.no_af
    pipe = init_random_video_editing_pipeline(ucfg, vcfg, scfg, seed=0,
                                              device=args.device)
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    frames = load_frames(args.input_video, res, args.max_frames)
    t0 = time.perf_counter()
    out = pipe(frames, args.prompt, args.n_prompt, strength=args.strength,
               num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale,
               use_inversion=args.use_inversion,
               generator=torch.Generator().manual_seed(1))
    wall = time.perf_counter() - t0
    path = Path(args.output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, out)
    peak = ""
    if pipe.device.type == "cuda":
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mode = "inversion" if args.use_inversion else "SDEdit"
    print(f"edited {len(out)} frames at {res} px in {wall:.2f} s ({mode}, "
          f"{len(pipe.get_timesteps(args.num_inference_steps, args.strength))}"
          f" of {args.num_inference_steps} steps){peak} -> {path}")
    return out


if __name__ == "__main__":
    main()
