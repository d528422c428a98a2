"""Op-class attribution of the batch-8 FFHQ UNet denoise step on the card:
time the full alias-free step, then ablate one op class at a time and
give the time it loses to that class. The counterpart of the JAX
package's ``scripts/roofline_denoise.py``: its ablations (:47-66,
:118-134), built from ``configs/ldm/model_unet.json`` as there
(``add_attention=False`` with the attention blocks swapped for plain
ones, ``alias_free=False``, ``filtered_act=False|True``), and its rows:

- ``full_af_step_ms``: the alias-free UNet (K5 for its filtered
  activations, K3 for its attention, FFT resamplers);
- ``full_af_step_prec_high_ms`` / ``_default_ms``: the same at the
  reduced ``af_precision`` levels (the kernels' bf16 tensor-core variants);
  at ``--dtype bf16`` also ``full_af_step_bf16_split_ms``
  (``set_af_bf16_split(True)``);
- ``no_attention_ms``, ``naive_resample_plain_act_ms``,
  ``af_resample_plain_act_ms``, ``naive_resample_filtered_act_ms`` and
  ``conv_core_ms`` (no attention, no alias-free resampling or filtering);
- the shares ``attention_share`` = 1 - no_attention/full,
  ``af_machinery_share`` = 1 - naive/full, ``filtered_act_share`` = 1 -
  plain_act/full and ``af_resample_share`` = (plain_act - naive)/full;
- ``gflop_per_step`` (``FlopCounterMode`` over one step of an f32 copy on
  the CPU at batch 1, times the batch: the plain versions run the kernels'
  products; FFTs and elementwise work are not counted) and the step's
  share of the H100 SXM's dense peak of its dtype: the JAX script's
  ``mfu_vs_197tflops_bf16`` renamed ``mfu_vs_989tflops_bf16`` (bf16) or
  ``mfu_vs_67tflops_f32`` (f32); added ``device``.

Each time is the best of ``--repeats`` runs of ``--iters`` chained steps
(each step's eps the next step's input, timestep 0, zero latents, random
weights from seed 0), from CUDA events on the card. Writes ``--out``.

  python -m afldm_tpu_torch.scripts.roofline_denoise [--dtype f32]  # card
"""

import argparse
import json
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "roofline_denoise_torch.json"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--iters", type=int, default=20,
                   help="chained steps a timed run")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed runs; the best is reported")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    return p.parse_args(argv)


def unet_json():
    return json.loads((REPO / "configs" / "ldm" / "model_unet.json")
                      .read_text())


def ablation(cfg_json, alias_free=True, add_attention=True,
             filtered_act=None):
    """The JAX script's ``build`` config: without attention the attention
    blocks become plain ones; ``filtered_act`` None follows alias_free."""
    from ..models import UNet2DConfig
    cfg_d = dict(cfg_json)
    if not add_attention:
        cfg_d["down_block_types"] = [
            t.replace("AttnDownBlock2D", "DownBlock2D")
            for t in cfg_d["down_block_types"]]
        cfg_d["up_block_types"] = [
            t.replace("AttnUpBlock2D", "UpBlock2D")
            for t in cfg_d["up_block_types"]]
        cfg_d["add_attention"] = False
    if filtered_act is not None:
        cfg_d["filtered_act"] = filtered_act
    return UNet2DConfig.from_diffusers(cfg_d, alias_free=alias_free)


# row name -> ablation arguments, in the JAX script's order
ABLATIONS = {
    "no_attention_ms": dict(add_attention=False),
    "naive_resample_plain_act_ms": dict(alias_free=False),
    "af_resample_plain_act_ms": dict(filtered_act=False),
    "naive_resample_filtered_act_ms": dict(alias_free=False,
                                           filtered_act=True),
    "conv_core_ms": dict(alias_free=False, add_attention=False),
}


@torch.no_grad()
def main(argv=None):
    from ..models import UNet2DModel
    from ..ops import set_af_bf16_split, set_af_precision
    from ..pipelines.loading import init_random_weights, resolve_device
    from .bench import (PEAK_BF16_TFLOPS, PEAK_F32_TFLOPS, device_name,
                        unet_flops)
    from .bench_flash_sweep import DTYPES, measure
    args = parse_args(argv)
    device = resolve_device(args.device)
    dt = DTYPES[args.dtype]
    cfg_json = unet_json()
    set_af_precision("highest")

    def step_ms(cfg):
        unet = UNet2DModel(cfg, dtype=dt)
        init_random_weights(unet, torch.Generator().manual_seed(0))
        unet = unet.to(device).eval()
        lat = torch.zeros((args.batch, cfg.in_channels, cfg.sample_size,
                           cfg.sample_size), device=device)
        ms = measure(lambda c: unet(c, 0)[0], lat, (), args.iters, device,
                     args.repeats)
        del unet
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return ms

    rows = {}
    full = ablation(cfg_json)
    base = step_ms(full)
    rows["full_af_step_ms"] = base
    lat1 = torch.zeros((1, full.in_channels, full.sample_size,
                        full.sample_size))
    flops = unet_flops(UNet2DModel(full), lat1, 0) * args.batch
    peak = PEAK_BF16_TFLOPS if args.dtype == "bf16" else PEAK_F32_TFLOPS
    rows["gflop_per_step"] = flops / 1e9
    rows[f"mfu_vs_{peak:.0f}tflops_{args.dtype}"] = (
        flops / (base / 1e3) / (peak * 1e12))
    for prec in ("high", "default"):
        set_af_precision(prec)
        try:
            rows[f"full_af_step_prec_{prec}_ms"] = step_ms(full)
        finally:
            set_af_precision("highest")
    if args.dtype == "bf16":
        set_af_bf16_split(True)
        try:
            rows["full_af_step_bf16_split_ms"] = step_ms(full)
        finally:
            set_af_bf16_split(False)
    for name, kw in ABLATIONS.items():
        rows[name] = step_ms(ablation(cfg_json, **kw))

    plain_act = rows["af_resample_plain_act_ms"]
    rows["attention_share"] = 1 - rows["no_attention_ms"] / base
    rows["af_machinery_share"] = 1 - rows["naive_resample_plain_act_ms"] / base
    rows["filtered_act_share"] = 1 - plain_act / base
    rows["af_resample_share"] = (
        plain_act - rows["naive_resample_plain_act_ms"]) / base
    rows["batch"] = args.batch
    rows["dtype"] = args.dtype
    rows["device"] = device_name(device)
    print(json.dumps(rows, indent=2), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
