"""End-to-end pipeline throughput on the card at production size, random
weights from seed 0 (model-shape-true performance, not output quality):

- video editing (``video_editing.sh``'s workload): ``--frames`` frames at
  ``--resolution`` px, SDEdit at strength 0.7, frame-0 CFA, CFG batch 2
  a frame;
- image interpolation (``image_interpolation.sh``): ``--interp_frames``
  frames, DDIM inversion of both ends and the joint CFA-interp denoise,
  Lucas-Kanade flow;
- latent I2SB SR (``shift_ldm_sr.sh``): 4x bicubic degrade and the ODE
  bridge denoise, the FFHQ UNet and the AF-VAE at 256 px;
- normal estimation (``shift_normal_estimation.sh``): YOSO through the
  latent ControlNet over the full 16-shift sweep in one batch.

The counterpart of the JAX package's ``scripts/bench_pipelines.py``, with
its flags, its models (SD-1.5 widths at ``--resolution // 8`` latents,
``configs/vae/model_afvae.json``, the FFHQ UNet of
``UNet2DConfig(alias_free=True)``; one SD UNet and one VAE shared by the
SD pipelines, the VAE also by the SR one) and its result: frames/s end to
end (encode, denoise, decode), each pipeline's first call (warm-up) and
second call timed, a call ending in the host copy of its output. The JSON
has the JAX script's keys; added ``device``. ``--attn xla`` is refused:
the port has one attention, the flash kernels, and no switch to another.

  python -m afldm_tpu_torch.scripts.bench_pipelines               # the card
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "configs"
OUT = REPO / "results" / "bench_pipelines_torch.json"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--interp_frames", type=int, default=5)
    p.add_argument("--skip_video", action="store_true")
    p.add_argument("--skip_interp", action="store_true")
    p.add_argument("--skip_sr", action="store_true")
    p.add_argument("--skip_normal", action="store_true")
    p.add_argument("--attn", default="auto", choices=["auto", "xla"],
                   help="'auto' only: the port has no attention switch")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    if args.attn != "auto":
        raise SystemExit("--attn xla: the port has one attention (the flash "
                         "kernels K3/K6 and their plain versions on the "
                         "CPU) and no switch to an XLA-style einsum path")
    return args


def model_configs(resolution):
    """(SD UNet, VAE, FFHQ UNet) configs of the JAX script."""
    from ..models import (AutoencoderKLConfig, UNet2DConditionConfig,
                          UNet2DConfig)
    vcfg = AutoencoderKLConfig.from_diffusers(json.loads(
        (CONFIGS / "vae" / "model_afvae.json").read_text()))
    return (UNet2DConditionConfig(alias_free=True,
                                  sample_size=resolution // 8),
            vcfg, UNet2DConfig(alias_free=True))


def _random(module, gen, device):
    from ..pipelines.loading import init_random_weights
    init_random_weights(module, gen)
    return module.to(device).eval()


def _timed(call):
    """(first call s, second call s, the second call's output)."""
    t0 = time.perf_counter()
    call()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = call()
    return first, time.perf_counter() - t0, out


def nchw(a):
    """NHWC numpy images as a contiguous NCHW float32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).permute(
        0, 3, 1, 2).contiguous()


def main(argv=None):
    from ..models import (AutoencoderKL, ControlNetConfig, ControlNetModel,
                          UNet2DConditionModel, UNet2DModel)
    from ..ops import set_af_precision
    from ..pipelines import (I2SBLDMPipeline, ImageInterpolationPipeline,
                             NormControlPipeline, VideoEquivEditingPipeline)
    from ..pipelines.loading import resolve_device
    from ..schedulers import DDIMScheduler, I2SBScheduler
    from ..shift.simple_flow import predict_flow
    from ..train.i2sb_trainer import degrade_sr4x
    from .bench import device_name
    from .image_interpolation import SD_DDIM
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_af_precision("highest")  # TF32 off
    res = args.resolution
    ucfg, vcfg, ffhq_cfg = model_configs(res)
    gen = torch.Generator().manual_seed(0)
    print("initializing weights...", file=sys.stderr)
    unet = _random(UNet2DConditionModel(ucfg), gen, device)
    vae = _random(AutoencoderKL(vcfg), gen, device)

    rng = np.random.default_rng(0)
    results = {"resolution": res, "steps": args.steps, "attn": args.attn,
               "device": device_name(device)}

    if not args.skip_video:
        ve = VideoEquivEditingPipeline(vae, unet, DDIMScheduler(**SD_DDIM))
        frames = nchw(np.stack(
            [np.roll(rng.standard_normal((res, res, 3)) * 0.3, 3 * i,
                     axis=1) for i in range(args.frames)]))
        first, dt, out = _timed(lambda: ve(
            frames, "a photo", strength=0.7, num_inference_steps=args.steps,
            generator=torch.Generator().manual_seed(1)))
        results["video_editing"] = {
            "frames": args.frames, "first_call_s": first, "seconds": dt,
            "frames_per_s": args.frames / dt,
            "finite": bool(np.isfinite(out).all())}
        print("video:", results["video_editing"], file=sys.stderr)

    if not args.skip_interp:
        pipe = ImageInterpolationPipeline(vae, unet, DDIMScheduler(**SD_DDIM),
                                          flow_fn=predict_flow)
        img0 = nchw(rng.standard_normal((1, res, res, 3)) * 0.3)
        img1 = torch.roll(img0, res // 16, dims=3)
        first, dt, out = _timed(lambda: pipe(
            img0, img1, num_frames=args.interp_frames,
            num_inference_steps=args.steps,
            generator=torch.Generator().manual_seed(2)))
        results["interpolation"] = {
            "frames": args.interp_frames, "first_call_s": first,
            "seconds": dt, "frames_per_s": args.interp_frames / dt,
            "finite": bool(np.isfinite(out).all())}
        print("interp:", results["interpolation"], file=sys.stderr)

    if not args.skip_sr:
        i2sb_cfg = json.loads((CONFIGS / "sr" / "i2sb_scheduler.json")
                              .read_text())
        ffhq_unet = _random(UNet2DModel(ffhq_cfg), gen, device)
        # the VAE is fully convolutional: the SD pipelines' one at 256 px
        sr_pipe = I2SBLDMPipeline(vae, ffhq_unet,
                                  I2SBScheduler.from_config(i2sb_cfg))
        size = ffhq_cfg.sample_size * vcfg.downsample_ratio
        hq = nchw(rng.standard_normal((1, size, size, 3)) * 0.3).to(device)
        lq = degrade_sr4x(hq)
        first, dt, out = _timed(lambda: sr_pipe(
            lq, num_inference_steps=args.steps))
        results["i2sb_sr"] = {
            "first_call_s": first, "seconds": dt, "images_per_s": 1 / dt,
            "finite": bool(np.isfinite(out).all())}
        print("sr:", results["i2sb_sr"], file=sys.stderr)
        del ffhq_unet, sr_pipe

    if not args.skip_normal:
        cn = _random(ControlNetModel(ControlNetConfig.from_unet_config(ucfg)),
                     gen, device)
        cn.zero_controls_()
        norm_pipe = NormControlPipeline(
            vae, unet, cn, DDIMScheduler(num_train_timesteps=1000))
        img = nchw(rng.standard_normal((1, res, res, 3)) * 0.3)
        first, dt, nres = _timed(lambda: norm_pipe(img, num_shift_steps=16))
        results["normal_yoso_sweep"] = {
            "shift_steps": 16, "first_call_s": first, "seconds": dt,
            "estimates_per_s": 17 / dt,
            "finite": bool(np.isfinite(nres.mean_psnr))}
        print("normal:", results["normal_yoso_sweep"], file=sys.stderr)

    print(json.dumps(results), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
