"""The five acceptance configurations of BASELINE.json (``configs``), end
to end on the card, with a JSON summary: the FFHQ-256 shift protocol, the
latent-I2SB SR shift protocol, the normal-estimation shift sweep, video
editing and image interpolation. The counterpart of the JAX package's
``scripts/run_all_benchmarks.py``, with its flags (``--platform`` is
``--device`` here) and summary keys: each configuration's record (the mean
masked PSNR, the FFHQ per-shift PSNRs, the frames and their finiteness),
``seconds`` since the start and ``weights``; ``_provenance`` says for each
whether its weights are 'trained' (a trainer's ``save_pipeline``
directory), 'converted' (``scripts.convert_reference_checkpoint``) or
'random' (seed 0). Added ``_device``. PSNRs are parity evidence only with
real weights; on random ones the run checks the plumbing.

``--ldm_pipeline_dir`` and ``--sr_pipeline_dir`` are read by
``load_pipeline`` (the SR one with ``configs/sr/i2sb_scheduler.json``),
``--sd_pipeline_dir`` by ``load_sd_components`` (a ControlNet and a text
encoder where the directory has them, else a random ControlNet and zero
text embeddings). Without them the models are the configs' (``--tiny``:
the JAX script's reduced ones) with random weights.

  python -m afldm_tpu_torch.scripts.run_all_benchmarks         # the card
  python -m afldm_tpu_torch.scripts.run_all_benchmarks --tiny --device cpu \\
      --steps 2 --shift_steps 2
"""

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .bench_pipelines import nchw
from .image_interpolation import TINY_UNET as TINY_SD_UNET
from .shift_ldm_ffhq import TINY_UNET, TINY_VAE

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "configs"
OUT = REPO / "results" / "benchmarks_torch.json"
def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--shift_steps", type=int, default=16)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--ldm_pipeline_dir", default=None)
    p.add_argument("--sr_pipeline_dir", default=None)
    p.add_argument("--sd_pipeline_dir", default=None,
                   help="SD pipeline directory (conditional UNet + VAE + "
                        "optional controlnet / text_encoder) for the "
                        "normal, video and interpolation configs")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def provenance(d):
    """'converted' (the marker ``convert_reference_checkpoint`` writes),
    'trained' (a trainer's ``save_pipeline`` directory), or 'random'."""
    if not d:
        return "random"
    m = os.path.join(d, "provenance.json")
    if os.path.exists(m):
        with open(m) as f:
            return json.load(f).get("provenance", "converted")
    return "trained"


def _read(rel):
    return json.loads((CONFIGS / rel).read_text())


def sd_parts(args, device):
    """(unet, vae, controlnet, text_encoder or None, whether the
    ControlNet is random) of the SD configs: the directory's, or random
    from seed 0."""
    from ..models import (AutoencoderKL, AutoencoderKLConfig,
                          ControlNetConfig, ControlNetModel,
                          UNet2DConditionConfig, UNet2DConditionModel)
    from ..pipelines.loading import init_random_weights, load_sd_components
    gen = torch.Generator().manual_seed(0)

    def rand(m):
        init_random_weights(m, gen)
        return m.to(device).eval()

    if args.sd_pipeline_dir:
        parts = load_sd_components(args.sd_pipeline_dir, device=device)
        unet, vae = parts["unet"], parts["vae"]
        cn = parts.get("controlnet")
        if cn is not None:
            return unet, vae, cn, parts.get("text_encoder"), False
        # a converted SD directory without a ControlNet: a random one
        cn = rand(ControlNetModel(
            ControlNetConfig.from_unet_config(unet.config)))
        cn.zero_controls_()
        return unet, vae, cn, parts.get("text_encoder"), True
    vcfg = _read("vae/model_afvae.json")
    if args.tiny:
        vcfg.update(TINY_VAE)
    ucfg = UNet2DConditionConfig(alias_free=True,
                                 **(TINY_SD_UNET if args.tiny else {}))
    unet = rand(UNet2DConditionModel(ucfg))
    vae = rand(AutoencoderKL(AutoencoderKLConfig.from_diffusers(vcfg)))
    cn = rand(ControlNetModel(ControlNetConfig.from_unet_config(ucfg)))
    cn.zero_controls_()
    return unet, vae, cn, None, True


def main(argv=None):
    from ..pipelines import (I2SBLDMPipeline, ImageInterpolationPipeline,
                             NormControlPipeline, VideoEquivEditingPipeline,
                             init_random_pipeline, shift_equivariance_eval)
    from ..pipelines.loading import load_pipeline, resolve_device
    from ..schedulers import DDIMScheduler
    from ..shift.simple_flow import predict_flow
    from ..train.i2sb_trainer import degrade_sr4x
    from .bench import device_name
    from .image_interpolation import SD_DDIM
    args = parse_args(argv)
    device = resolve_device(args.device)
    results = {"_provenance": {
        "ffhq_shift": provenance(args.ldm_pipeline_dir),
        "i2sb_sr_shift": provenance(args.sr_pipeline_dir),
        "normal_shift": provenance(args.sd_pipeline_dir),
        "video_editing": provenance(args.sd_pipeline_dir),
        "interpolation": provenance(args.sd_pipeline_dir),
    }, "_device": device_name(device)}
    t_start = time.time()

    def record(name, **kw):
        kw["seconds"] = time.time() - t_start
        kw["weights"] = results["_provenance"].get(name, "random")
        results[name] = kw
        print(f"[{kw['seconds']:7.1f}s] {name}: "
              f"{ {k: v for k, v in kw.items() if k != 'seconds'} }",
              flush=True)

    ucfg, vcfg = _read("ldm/model_unet.json"), _read("vae/model_afvae.json")
    scfg, i2sb_cfg = (_read("ldm/noise_scheduler.json"),
                      _read("sr/i2sb_scheduler.json"))
    if args.tiny:
        ucfg.update(TINY_UNET)
        vcfg.update(TINY_VAE)

    # 1. FFHQ-256 unconditional shift (shift_ldm_ffhq.sh)
    pipe = (load_pipeline(args.ldm_pipeline_dir, device=device)
            if args.ldm_pipeline_dir
            else init_random_pipeline(ucfg, vcfg, scfg, device=device))
    res = shift_equivariance_eval(
        pipe, generator=torch.Generator(pipe.device).manual_seed(0),
        num_inference_steps=args.steps, num_shift_steps=args.shift_steps)
    record("ffhq_shift", mean_psnr=float(res.mean_psnr),
           psnrs=[float(v) for v in res.psnrs])
    del pipe

    # 2. latent-I2SB SR shift (shift_ldm_sr.sh), fixed degradation
    sr_pipe = (load_pipeline(args.sr_pipeline_dir, cls=I2SBLDMPipeline,
                             scheduler_config=i2sb_cfg, device=device)
               if args.sr_pipeline_dir
               else init_random_pipeline(ucfg, vcfg, i2sb_cfg,
                                         cls=I2SBLDMPipeline, device=device))
    img_res = (sr_pipe.unet.config.sample_size
               * sr_pipe.vae.config.downsample_ratio)
    rng = np.random.default_rng(0)
    low = np.tanh(rng.standard_normal((img_res // 8, img_res // 8, 3)))
    img = nchw(np.kron(low, np.ones((8, 8, 1)))[None]).to(device)
    init_latent = sr_pipe.encode(degrade_sr4x(img))
    res = shift_equivariance_eval(sr_pipe, num_inference_steps=args.steps,
                                  num_shift_steps=args.shift_steps,
                                  init_latent=init_latent)
    record("i2sb_sr_shift", mean_psnr=float(res.mean_psnr))
    del sr_pipe

    # 3. normal-estimation shift (shift_normal_estimation.sh)
    unet, vae, cn, text_encoder, cn_random = sd_parts(args, device)
    if cn_random:
        results["_provenance"]["normal_shift"] = "random"
    sres = unet.config.sample_size * vae.config.downsample_ratio
    norm_pipe = NormControlPipeline(vae, unet, cn,
                                    DDIMScheduler(num_train_timesteps=1000),
                                    text_encoder=text_encoder)
    low = np.tanh(rng.standard_normal((sres // 8, sres // 8, 3)))
    nimg = nchw(np.kron(low, np.ones((8, 8, 1)))[None])
    nres = norm_pipe(nimg, num_shift_steps=args.shift_steps)
    record("normal_shift", mean_psnr=float(nres.mean_psnr))

    # 4. video editing (video_editing.sh)
    ve = VideoEquivEditingPipeline(vae, unet, DDIMScheduler(**SD_DDIM),
                                   text_encoder=text_encoder)
    frames = torch.cat([torch.roll(nimg, 2 * i, dims=3)
                        for i in range(args.frames)])
    out = ve(frames, "a clip", strength=0.6,
             num_inference_steps=max(args.steps // 10, 2),
             guidance_scale=2.0, generator=torch.Generator().manual_seed(1))
    record("video_editing", frames=int(out.shape[0]),
           finite=bool(np.isfinite(out).all()))

    # 5. image interpolation with flow-warped noise (image_interpolation.sh)
    interp = ImageInterpolationPipeline(vae, unet, DDIMScheduler(**SD_DDIM))
    interp.text_encoder = text_encoder
    img1 = torch.roll(nimg, sres // 8, dims=3)
    out = interp(nimg, img1, num_frames=3,
                 num_inference_steps=max(args.steps // 10, 2),
                 generator=torch.Generator().manual_seed(2),
                 flows=predict_flow(nimg.to(device), img1.to(device)))
    record("interpolation", frames=int(out.shape[0]),
           finite=bool(np.isfinite(out).all()))

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    merged = {}
    try:  # keep sibling keys other runs wrote into the same file
        merged = json.loads(out_path.read_text())
    except (FileNotFoundError, ValueError):
        pass
    merged.update(results)
    out_path.write_text(json.dumps(merged, indent=2))
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
