"""Serving throughput of the sampler service at full width: the FFHQ-256
pipeline (the 256.4M-parameter alias-free UNet's 50-step denoise and the
AF-VAE decode at 256 px, random weights from seed 0) behind
``afldm_tpu_torch.serve.SamplerService``, as ``scripts.serve_ldm`` runs
it. Reports samples/s and per-request latency for

  - serial:     one client issuing requests back-to-back (bucket 1)
  - concurrent: N clients in flight (microbatching packs them into shared
                denoise passes)

and their ratio. Every ``sample()`` returns decoded images as host numpy,
so the timing includes the device-to-host read. Writes ``--out``.

  python -m afldm_tpu_torch.scripts.bench_serve                # on the card
  python -m afldm_tpu_torch.scripts.bench_serve --tiny --device cpu
"""

import argparse
import json
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "results" / "bench_serve_torch.json"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests_per_client", type=int, default=3)
    p.add_argument("--serial_requests", type=int, default=8)
    p.add_argument("--batch_window_ms", type=float, default=30.0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model, 2 steps, few requests (CPU-runnable)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    if args.tiny:
        args.steps = 2
        args.serial_requests = 2
        args.clients = 2
        args.requests_per_client = 1
    return args


def build_pipeline(tiny: bool, device=None):
    """The FFHQ pipeline, or the JAX script's tiny smoke model."""
    from ..models import AutoencoderKLConfig, UNet2DConfig
    from ..pipelines import init_random_pipeline
    from .shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs()
    if tiny:
        ucfg = UNet2DConfig(
            sample_size=8, in_channels=4, out_channels=4,
            down_block_types=("DownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "UpBlock2D"),
            block_out_channels=(8, 16), layers_per_block=1,
            attention_head_dim=8, norm_num_groups=4, alias_free=True)
        vcfg = AutoencoderKLConfig(
            block_out_channels=(8, 8), layers_per_block=1,
            norm_num_groups=4, sample_size=16, scaling_factor=0.6)
    return init_random_pipeline(ucfg, vcfg, scfg, seed=0, device=device)


def main(argv=None):
    from ..serve import SamplerService
    from .bench import device_name
    args = parse_args(argv)
    t0 = time.perf_counter()
    pipe = build_pipeline(args.tiny, args.device)
    print(f"pipeline built in {time.perf_counter() - t0:.1f} s", flush=True)

    svc = SamplerService(pipe, batch_window_ms=args.batch_window_ms,
                         max_batch=8)
    try:
        # one num_images=b request per bucket the phases can reach, so
        # first-call costs (cuDNN plans, kernel loads) stay out of them
        for b in svc.buckets:
            t0 = time.perf_counter()
            svc.sample(b, args.steps, seed=100 + b)
            print(f"bucket-{b} warm in {time.perf_counter() - t0:.1f} s",
                  flush=True)

        lat = []
        t0 = time.perf_counter()
        for s in range(args.serial_requests):
            lat.append(svc.sample(1, args.steps, seed=s)["latency_s"])
        serial_sps = args.serial_requests / (time.perf_counter() - t0)

        base_batches = svc.stats["batches"]
        n_total = args.clients * args.requests_per_client

        def client(cid):
            return [svc.sample(1, args.steps,
                               seed=1000 + cid * 97 + i)["latency_s"]
                    for i in range(args.requests_per_client)]

        lat2 = []
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.clients) as ex:
            for res in ex.map(client, range(args.clients)):
                lat2.extend(res)
        conc_sps = n_total / (time.perf_counter() - t0)

        out = {
            "workload": ("tiny-smoke" if args.tiny else "FFHQ-256 AF-LDM")
                        + f" {args.steps}-step denoise + VAE decode, "
                        "per-request num_images=1",
            "device": device_name(pipe.device),
            "steps": args.steps,
            "serial": {"requests": args.serial_requests,
                       "samples_per_s": serial_sps,
                       "p50_latency_s": statistics.median(lat)},
            "concurrent": {"clients": args.clients,
                           "requests": n_total,
                           "samples_per_s": conc_sps,
                           "p50_latency_s": statistics.median(lat2),
                           "device_batches": (svc.stats["batches"]
                                              - base_batches)},
            "microbatching_speedup": conc_sps / serial_sps,
        }
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=2))
        print(json.dumps(out))
        return out
    finally:
        svc.close()


if __name__ == "__main__":
    main()
