"""Run the persistent sampler service on a saved (or random) LDM pipeline.

  python -m afldm_tpu_torch.scripts.serve_ldm --pipeline_dir out/pipeline \\
      --port 8763                                            # on the card
  python -m afldm_tpu_torch.scripts.serve_ldm --tiny --device cpu
  curl -X POST localhost:8763/sample -d '{"num_images":1,"seed":3}'

``--pipeline_dir`` takes a directory that this port's
``LDMTrainer.save_pipeline`` wrote; without it the FFHQ pipeline (or its
tiny version) runs on random weights from seed 0.
"""

import argparse

from .shift_ldm_ffhq import load_configs

# --tiny: the JAX script's reduced VAE (the UNet is the shift CLI's)
TINY_VAE = dict(block_out_channels=[16, 16], layers_per_block=1,
                norm_num_groups=8, down_filtered_act=[False, True],
                up_filtered_act=[True, False], up_rescale=[True])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pipeline_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8763)
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--af_precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="circulant products' level: 'highest' exact f32, "
                        "'high' 3 bf16 passes, 'default' 1")
    return p.parse_args(argv)


def build_pipeline(args):
    from ..pipelines import init_random_pipeline, load_pipeline
    if args.pipeline_dir:
        return load_pipeline(args.pipeline_dir, device=args.device,
                             af_precision=args.af_precision)
    ucfg, vcfg, scfg = load_configs(tiny=args.tiny)
    if args.tiny:
        vcfg.update(TINY_VAE)
    return init_random_pipeline(ucfg, vcfg, scfg, seed=0, device=args.device,
                                af_precision=args.af_precision)


def main(argv=None):
    from ..serve import serve
    args = parse_args(argv)
    pipe = build_pipeline(args)
    server, service = serve(pipe, host=args.host, port=args.port,
                            batch_window_ms=args.batch_window_ms,
                            max_batch=args.max_batch)
    print(f"sampler service on http://{args.host}:{args.port} "
          f"(POST /sample, GET /healthz /stats)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
