"""The SD UNet's interp denoise on the card, the loop of the image
interpolation (``pipelines/interpolation.py``): two STORE denoises of the
endpoint latents keep every step's attention maps, then the interp denoise
of ``--frames`` frames reads both maps at each step and blends the two
attentions with one alpha a frame. SD-1.5 widths at 64x64 latents
(``UNet2DConditionConfig(alias_free=True)``), zero text embeddings of 77
tokens, SD 1.5's DDIM, random weights from seed 0. The counterpart of the
JAX package's ``scripts/bench_interp_denoise.py``, with its flags.

That script times its interp scan twice, with ``set_sdpa2_fused(False)``
and ``(True)`` (:79-95), as an A/B of the fused two-KV kernel. But the SD
UNet's attention is ``attention_blocks.CrossAttention``, which blends two
``sdpa`` passes after ``to_out`` (``afldm_tpu/models/attention_blocks.py``
:54-65) and never reaches ``sdpa2``: only ``layers.Attention`` does
(``afldm_tpu/models/layers.py``:197-208), and ``unet2d_condition.py``
(:17-20) does not import it. Its two arms run one program. This script
times that program once (K3 twice a self-attention, and over the 77 text
tokens, K5 and K1 for the filtered activations) and has no knob.

The interp denoise is timed as the mean of ``--iters`` runs after one
warm-up, each ending in a host read of its sum. The row (printed and
appended to ``--out``) keeps the JAX keys ``frames``, ``steps``,
``dtype`` and ``latent``; the arms' ``unfused_s``/``fused_s`` become
``seconds`` and ``unfused_ms_per_step``/``fused_ms_per_step`` become
``ms_per_step``; ``speedup`` and ``checksum_rel_diff``, which compare the
arms, are gone; added ``checksum`` (the output's sum), ``store_s`` (both
STORE denoises, not timed in the JAX script) and ``device``.

  python -m afldm_tpu_torch.scripts.bench_interp_denoise          # the card
  python -m afldm_tpu_torch.scripts.bench_interp_denoise --tiny --device cpu \\
      --frames 3 --steps 2 --iters 1
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_interp_denoise_torch.jsonl"
# --tiny: the JAX script's tiny UNet
TINY_UNET = dict(alias_free=True, sample_size=16, block_out_channels=(32, 64),
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 layers_per_block=1, attention_head_dim=2,
                 cross_attention_dim=32, norm_num_groups=8)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=17)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--tiny", action="store_true",
                   help="tiny UNet for CPU smoke tests (NOT a benchmark)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main(argv=None):
    from ..models import UNet2DConditionConfig, UNet2DConditionModel
    from ..ops import set_af_precision
    from ..pipelines.loading import init_random_weights, resolve_device
    from ..schedulers import DDIMScheduler
    from .bench import device_name
    from .bench_flash_sweep import DTYPES
    from .image_interpolation import SD_DDIM
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_af_precision("highest")  # TF32 off
    cfg = (UNet2DConditionConfig(**TINY_UNET) if args.tiny
           else UNet2DConditionConfig(alias_free=True))
    unet = UNet2DConditionModel(cfg, dtype=DTYPES[args.dtype])
    init_random_weights(unet, torch.Generator().manual_seed(0))
    unet = unet.to(device).eval()
    sched = DDIMScheduler(**SD_DDIM)
    ts = sched.set_timesteps(args.steps)
    ts_prev = ts - sched.num_train_timesteps // args.steps
    steps = [(int(t), int(pt)) for t, pt in zip(ts, ts_prev)]

    S, C = cfg.sample_size, cfg.in_channels
    ehs1 = torch.zeros((1, 77, cfg.cross_attention_dim), device=device)

    def store(latents):
        x, kvs = latents, []
        for t, pt in steps:
            eps, kv = unet(x, t, ehs1)
            x, _ = sched.step(eps, t, x, prev_timestep=pt)
            kvs.append(kv)
        return kvs

    r = np.random.default_rng(0)
    inv0, inv1 = (torch.from_numpy(r.standard_normal((1, C, S, S))
                                   .astype(np.float32)).to(device)
                  for _ in range(2))
    t0 = time.perf_counter()
    kv0, kv1 = store(inv0), store(inv1)
    _sync(device)
    store_s = time.perf_counter() - t0

    F = args.frames
    noises = torch.randn((F, C, S, S),
                         generator=torch.Generator().manual_seed(1)).to(
        device)
    ehsN = ehs1.expand(F, -1, -1)
    alphas = torch.linspace(0, 1, F, device=device)[:, None, None]

    def interp():
        x = noises
        for (t, pt), k0, k1 in zip(steps, kv0, kv1):
            eps, _ = unet(x, t, ehsN, kv_in=k0, kv_in2=k1, alpha=alphas)
            x, _ = sched.step(eps, t, x, prev_timestep=pt)
        return x

    checksum = float(interp().sum())  # warm-up
    t0 = time.perf_counter()
    for _ in range(args.iters):
        float(interp().sum())
    secs = (time.perf_counter() - t0) / args.iters
    row = {"frames": F, "steps": args.steps, "dtype": args.dtype,
           "latent": S, "seconds": secs,
           "ms_per_step": secs / args.steps * 1e3, "checksum": checksum,
           "store_s": store_s, "device": device_name(device)}
    print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


if __name__ == "__main__":
    main()
