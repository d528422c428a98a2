"""Headline benchmark of the port: AF-LDM UNet denoising throughput
(steps/s) of the FFHQ-256 configuration (``UNet2DConfig(alias_free=True)``,
the defaults of ``configs/ldm/model_unet.json``), batch 1, random weights
from seed 0: one 50-step DDIM denoise (the workload of
``scripts.shift_ldm_ffhq``), best of 3 after one warm-up, each run ending in
a host read of the result's sum.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N}

``vs_baseline`` is steps/s over this port's own CPU steps/s for the same
program, measured once in a subprocess with ``--device cpu`` and cached in
``results/bench_torch_cpu_baseline.json``. Every run is appended to
``results/bench_torch_history.jsonl``; a drop of more than 10 % below the
best earlier run is flagged on stderr. ``--full`` also writes
``results/bench_torch_extra.json``: the b1 and b8 denoise with FLOPs per
step, TFLOP/s and the share of the 67 TFLOP/s f32 peak; the same at bf16
(the UNet computing in bfloat16 with its weights cast to bf16, as the root
``bench.py``'s ``cast_params`` does, TFLOP/s also against the 989 TFLOP/s
bf16 peak), and at bf16 with the circulant products at ``af_precision``
'default'; AF-VAE encode+decode images/s at b4, 256 px, exact, with the
circulant products at 'high', and at bf16; the SD UNet at b2, 50 steps.
The headline stays float32.

  python -m afldm_tpu_torch.scripts.bench [--full]     # on the card
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
RESULTS = REPO / "results"
PEAK_F32_TFLOPS = 67.0  # H100 SXM, f32 without tensor cores
PEAK_BF16_TFLOPS = 989.0  # H100 SXM, bf16 dense tensor cores


def cpu_baseline_path():
    return RESULTS / "bench_torch_cpu_baseline.json"


def history_path():
    return RESULTS / "bench_torch_history.jsonl"


def extra_path():
    return RESULTS / "bench_torch_extra.json"


def unet_config():
    from ..models import UNet2DConfig
    return UNet2DConfig(alias_free=True)  # the defaults are the FFHQ config


def scheduler():
    """The DDIM scheduler of the headline (the FFHQ pipeline's)."""
    from ..pipelines.loading import DEFAULT_SCHEDULER
    from ..schedulers import DDIMScheduler
    return DDIMScheduler.from_config(DEFAULT_SCHEDULER)


def timesteps(n_steps=50):
    """(ts, ts_prev) of the headline: 50 leading steps, ``ts - 20``."""
    ts = scheduler().set_timesteps(50)
    return ts[:n_steps], (ts - 20)[:n_steps]


def _best_of(run, repeats):
    """One warm-up, then the best wall time (s) of ``repeats`` runs; each
    ``run()`` returns a tensor whose sum is read on the host."""
    run().sum().item()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run().sum().item()
        best = min(best, time.perf_counter() - t0)
    return best


def _random_module(module, device, seed=0, cast_params=False):
    """Weights from ``seed`` (float32, as every loader draws them), cast
    to the module's compute dtype where ``cast_params``."""
    from ..pipelines.loading import init_random_weights
    init_random_weights(module, torch.Generator().manual_seed(seed))
    if cast_params:
        module = module.to(module.dtype)
    return module.to(device).eval()


def unet_flops(unet, x, t):
    """FLOPs of one UNet forward, counted by ``FlopCounterMode`` on the CPU
    (the plain versions do the kernels' products; FFTs are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode
    unet_cpu = unet.to("cpu")
    counter = FlopCounterMode(display=False)
    with counter:
        unet_cpu(x.cpu(), t)
    return counter.get_total_flops()


@torch.inference_mode()
def measure(n_steps=50, repeats=3, batch=1, device=None,
            return_details=False, dtype=torch.float32, cast_params=False):
    """Steps/s of the ``n_steps``-step denoise at ``batch`` with the UNet
    computing in ``dtype`` (its weights cast to it where ``cast_params``),
    at the current ``af_precision``; with ``return_details`` a dict with
    FLOPs per step and the peak shares."""
    from ..models import UNet2DModel
    from ..ops import af_precision, set_af_precision
    from ..pipelines.loading import resolve_device
    device = resolve_device(device)
    set_af_precision(af_precision())  # the current level; TF32 off
    cfg = unet_config()
    unet = _random_module(UNet2DModel(cfg, dtype=dtype), device,
                          cast_params=cast_params)
    sched = scheduler()
    ts, ts_prev = timesteps(n_steps)
    lat = torch.randn((batch, cfg.in_channels, cfg.sample_size,
                       cfg.sample_size),
                      generator=torch.Generator().manual_seed(1)).to(device)

    def denoise():
        x = lat
        for t, pt in zip(ts, ts_prev):
            eps, _ = unet(x, int(t))
            x, _ = sched.step(eps, int(t), x, prev_timestep=int(pt))
        return x

    sps = n_steps / _best_of(denoise, repeats)
    if not return_details:
        return sps
    name = device_name(device)
    flops = unet_flops(unet, lat, int(ts[0]))
    tflops = flops * sps / 1e12
    d = {"steps_per_s": sps, "batch": batch,
         "dtype": str(dtype).removeprefix("torch."),
         "weights": str(next(unet.parameters()).dtype).removeprefix(
             "torch."), "af_precision": af_precision(), "device": name,
         "gflop_per_step": flops / 1e9, "tflop_per_s": tflops,
         "mfu_vs_67tflops_f32": tflops / PEAK_F32_TFLOPS}
    if dtype == torch.bfloat16:
        d["mfu_vs_989tflops_bf16"] = tflops / PEAK_BF16_TFLOPS
    return d


@torch.inference_mode()
def measure_vae(batch=4, res=256, repeats=3, device=None,
                dtype=torch.float32):
    """AF-VAE encode (mean) + decode images/s at ``res`` px, computing in
    ``dtype`` (bf16: its weights cast to bf16 too)."""
    from ..models import AutoencoderKL, AutoencoderKLConfig
    from ..pipelines.loading import resolve_device
    device = resolve_device(device)
    vae = _random_module(
        AutoencoderKL(AutoencoderKLConfig(alias_free=True, sample_size=res),
                      dtype=dtype), device,
        cast_params=dtype != torch.float32)
    x = torch.randn((batch, 3, res, res),
                    generator=torch.Generator().manual_seed(1)).to(device)

    def roundtrip():
        dec, mean, _ = vae(x)
        return dec.sum() + mean.sum()

    return batch / _best_of(roundtrip, repeats)


@torch.inference_mode()
def measure_sd(batch=2, repeats=3, n_steps=50, device=None):
    """SD-1.5-size conditional UNet denoise at 64x64 latents (4096-token
    self-attention), zero text embeddings, ``x - 0.01 * eps`` per step."""
    from ..models import UNet2DConditionConfig, UNet2DConditionModel
    from ..pipelines.loading import resolve_device
    device = resolve_device(device)
    cfg = UNet2DConditionConfig(alias_free=True)
    unet = _random_module(UNet2DConditionModel(cfg), device)
    ehs = torch.zeros((batch, 77, cfg.cross_attention_dim), device=device)
    x0 = torch.randn((batch, cfg.in_channels, 64, 64),
                     generator=torch.Generator().manual_seed(1)).to(device)

    def denoise():
        x = x0
        for t in range(n_steps):
            eps, _ = unet(x, t, ehs)
            x = x - 0.01 * eps
        return x

    return n_steps / _best_of(denoise, repeats)


def device_name(device):
    """The card's name, or "cpu": every result names where it ran."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def cpu_baseline():
    """This port's CPU steps/s of the headline program: cached, else
    measured once in a subprocess pinned to the CPU."""
    cache = cpu_baseline_path()
    if cache.exists():
        d = json.loads(cache.read_text())
        if d.get("n_steps") == 50:
            return d["cpu_steps_per_s"]
    code = ("import sys; sys.path.insert(0, %r); "
            "from afldm_tpu_torch.scripts import bench; "
            "print('CPURESULT', bench.measure(repeats=1, device='cpu'))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], timeout=3600,
                         capture_output=True, text=True)
    for line in out.stdout.splitlines():
        if line.startswith("CPURESULT"):
            v = float(line.split()[1])
            cache.parent.mkdir(parents=True, exist_ok=True)
            cache.write_text(json.dumps({"cpu_steps_per_s": v,
                                         "n_steps": 50}))
            return v
    print(f"CPU baseline failed (rc {out.returncode}): "
          f"{out.stderr[-2000:]}", file=sys.stderr)
    return None


def record_history(sps):
    """Append this run to the history; warn on a >10 % drop below the best
    earlier run. A truncated line (a run killed mid-write) is skipped."""
    path = history_path()
    vals = []
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                vals.append(float(json.loads(line)["steps_per_s"]))
            except (ValueError, KeyError, TypeError):
                continue
    best_prior = max(vals) if vals else None
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"ts": time.time(), "steps_per_s": sps,
                            "vs_best_prior": (sps / best_prior
                                              if best_prior else None)})
                + "\n")
    if best_prior and sps < 0.9 * best_prior:
        print(f"DRIFT WARNING: {sps:.1f} steps/s is "
              f"{(1 - sps / best_prior) * 100:.1f}% below the best recorded "
              f"run ({best_prior:.1f}); re-measure before trusting either",
              file=sys.stderr)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="also the b1/b8 FLOP rows, the VAE and the SD UNet, "
                        "written to results/bench_torch_extra.json")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.full:
        # stdout stays ONE JSON line: the extra rows go to a file and stderr
        from ..ops import set_af_precision
        extras = {}
        bf = dict(dtype=torch.bfloat16, cast_params=True)
        for batch in (1, 8):
            for name, kw in (("f32", {}), ("bf16", bf)):
                d = measure(batch=batch, device=args.device,
                            return_details=True, **kw)
                extras[f"unet_denoise_b{batch}_{name}"] = d
                print(f"unet b{batch} {name}: {d}", file=sys.stderr)
        # bf16 with the circulant products at 'default' (one bf16 pass a
        # product), as the root bench.py's rows
        set_af_precision("default")
        try:
            for batch in (1, 8):
                d = measure(batch=batch, device=args.device,
                            return_details=True, **bf)
                extras[f"unet_denoise_b{batch}_bf16_afprec_default"] = d
                print(f"unet b{batch} bf16 afprec=default: {d}",
                      file=sys.stderr)
        finally:
            set_af_precision("highest")
        extras["flop_count_note"] = ("FlopCounterMode over one UNet forward "
                                     "on the CPU; FFTs not counted")
        extras["vae_enc_dec_b4_f32_img_per_s"] = measure_vae(
            device=args.device)
        extras["vae_enc_dec_b4_bf16_img_per_s"] = measure_vae(
            device=args.device, dtype=torch.bfloat16)
        # the circulant products at 'high' (3 bf16 passes a product, the
        # filtered activations' bf16 kernels); the headline stays exact
        set_af_precision("high")
        try:
            extras["vae_enc_dec_b4_f32_high_img_per_s"] = measure_vae(
                device=args.device)
        finally:
            set_af_precision("highest")
        extras["sd_unet_denoise_b2_steps_per_s"] = measure_sd(
            device=args.device)
        print(f"vae b4: {extras['vae_enc_dec_b4_f32_img_per_s']} img/s, "
              f"{extras['vae_enc_dec_b4_bf16_img_per_s']} at bf16; sd "
              f"unet b2: {extras['sd_unet_denoise_b2_steps_per_s']} steps/s",
              file=sys.stderr)
        path = extra_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(extras, indent=2))

    from ..ops import set_af_precision
    set_af_precision("highest")
    sps = measure(device=args.device)
    cpu_sps = cpu_baseline()
    record_history(sps)
    line = {"metric": "af_unet_denoise_steps_per_s_ffhq256", "value": sps,
            "unit": "steps/s",
            "vs_baseline": (sps / cpu_sps) if cpu_sps else None}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
