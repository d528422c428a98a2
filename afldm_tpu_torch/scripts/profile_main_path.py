"""Where the main path's device time goes: one full-width
``shift_equivariance_eval`` (random weights, seed 0) under
``torch.profiler``, after one untraced warm-up run. Prints the device time
by kernel name (top 25), the share of the port's own kernels, the
sum of device time against the traced wall time, and the wall time of the
untraced run.

  python -m afldm_tpu_torch.scripts.profile_main_path --steps 50
"""

import argparse
import json
import subprocess
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)

    from ..pipelines import init_random_pipeline, shift_equivariance_eval
    from .shift_ldm_ffhq import load_configs

    pipe = init_random_pipeline(*load_configs(), seed=0)

    def run():
        gen = torch.Generator(pipe.device).manual_seed(0)
        out = shift_equivariance_eval(pipe, generator=gen,
                                      num_inference_steps=args.steps,
                                      num_shift_steps=16)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        traced_wall = time.perf_counter() - t0

    rows = {}  # device-side events only: each kernel counted once
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (e.self_device_time_total / 1e3, e.count)
    total = sum(ms for ms, _ in rows.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"untraced wall {wall:.3f} s; traced wall {traced_wall:.3f} s; "
          f"device time {total / 1e3:.3f} s "
          f"({100 * total / 1e3 / traced_wall:.1f}% of traced wall)")
    ours = {k: v for k, v in rows.items()
            if "filtered_act" in k or "flash_fwd" in k}
    ours_ms = sum(ms for ms, _ in ours.values())
    print(f"port kernels: {ours_ms:.1f} ms ({100 * ours_ms / total:.1f}% of "
          f"device time)")
    for k, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{ms:10.2f} ms {100 * ms / total:5.1f}% {n:7d}x  {k[:110]}")
    print(json.dumps({"wall_s": wall, "traced_wall_s": traced_wall,
                      "device_s": total / 1e3, "port_kernels_ms": ours_ms}))


if __name__ == "__main__":
    main()
