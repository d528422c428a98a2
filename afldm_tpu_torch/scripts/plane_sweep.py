"""Time the plane kernel (K5, ``filtered_act_plane``) or, with ``--bwd``,
its backward (K5b, ``filtered_act_plane_bwd``) at every block size,
planes-per-block P and micro-tile choice against the launch plan's pick:
the data ``ops/filtered_act.py::plane_plan`` and ``plane_bwd_plan`` are
fitted to. With ``--level high|default``, K5's bf16 variant at that level
instead: its persistent blocks at every P planes an iteration and one or
two blocks an SM (where shared memory holds two), against
``plane_mma_plan``'s pick, each launch held to the plain version at the
level (chip_smoke's phase 30 criterion); with ``--bwd`` too, K5b's bf16
variant the same way, its operators resident and phased at every P that
fits, against ``plane_mma_bwd_plan``'s pick. Run from the root of a
checkout on a machine with a card:

    python afldm_tpu_torch/scripts/plane_sweep.py [--bwd] [--level high]
        [--out sweep.jsonl]

Shapes: the kernel's ``chip_smoke.KERNELS[...]["shapes"]``. P runs over
powers of two and their halfway points up to the plane count, plus the
plan's own P and the largest P that keeps one wave of blocks; every launch
goes through the C entry and is held against the plain version first
(chip_smoke's tolerance: K5 atol 3e-5, rtol 1e-4; K5b atol 1e-4, rtol
1e-4). Prints, per shape, the plan's time and the quickest launch found,
with and without the plan's grid rule; exits non-zero if a launch
disagrees.
"""

import argparse
import importlib
import itertools
import json
import sys
from pathlib import Path


def _candidates(nplanes: int, plan_p: int, grid_p: int) -> list:
    ps = {1, plan_p, grid_p}
    p = 1
    while p <= nplanes:
        ps.update((p, p + p // 2))
        p *= 2
    return sorted(q for q in ps if 1 <= q <= nplanes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true",
                    help="sweep the backward kernel (K5b)")
    ap.add_argument("--level", choices=("high", "default"), default=None,
                    help="sweep K5's (with --bwd: K5b's) bf16 variant at "
                         "this level")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSON lines, one a launch")
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "chip_smoke.py").exists():
        print("plane_sweep: run from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("plane_sweep: no CUDA device", file=sys.stderr)
        return 1
    smoke = importlib.import_module("chip_smoke")
    kernels = importlib.import_module("afldm_tpu_torch.kernels")
    FA = importlib.import_module("afldm_tpu_torch.ops.filtered_act")
    if args.level:
        return level_sweep(torch, smoke, kernels, FA,
                           kernels.library("filtered_plane_mma"), args)
    lib = kernels.library("filtered_act")
    if args.bwd:
        name, fn = "filtered_act_plane_bwd", lib.filtered_act_plane_bwd_f32
        plan_of, products, smem_of = (FA.plane_bwd_plan, FA.plane_bwd_products,
                                      FA.plane_bwd_smem_bytes)
    else:
        name, fn = "filtered_act_plane", lib.filtered_act_plane_f32
        plan_of, products, smem_of = (FA.plane_plan, FA.plane_products,
                                      FA.plane_smem_bytes)
    atol, rtol = smoke.TOL[name]
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    out_file = open(args.out, "w") if args.out else None
    ok = True
    for shape in smoke.KERNELS[name]["shapes"]:
        n, c, H, W = shape
        nplanes = n * c
        x = torch.randn(shape, device=dev, generator=g)
        out = torch.empty_like(x)
        if args.bwd:
            gr = torch.randn(shape, device=dev, generator=g)
            want = FA.filtered_act_plane_bwd_plain(x, gr, "silu")
            tensors = (x, gr, out, *FA._plane_bwd_ops(H, W, dev))
        else:
            want = FA.filtered_act_plain(x, "silu")
            _, uwT, _, dwT = FA._kernel_ops(H, W, dev)
            dhT, _, _, uhT = FA._kernel_bwd_ops(H, W, dev)
            tensors = (x, out, uhT, uwT, dwT, dhT)
        ptrs = [t.data_ptr() for t in tensors]
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = plan_of(H, W, nplanes)
        grid_p = max(1, -(-nplanes // (FA.NUM_SMS - 1)) - 1)
        rows = [r for r, _, _ in products(H, W)]
        times = {}
        for threads, ppb in itertools.product(
                FA.K5_THREADS, _candidates(nplanes, plan.planes_per_block,
                                           grid_p)):
            if smem_of(H, W, ppb) > FA.SMEM_MAX_BYTES:
                continue
            for bits in itertools.product((0, 1), repeat=len(rows)):
                if any(b == 0 and r % 8 for b, r in zip(bits, rows)):
                    continue  # 8×4 tiles need rows % 8 == 0
                code = sum(b << i for i, b in enumerate(bits))

                def run():
                    return fn(*ptrs, nplanes, H, W, ppb, code, threads,
                              FA.ACT_CODES["silu"], stream)
                kernels.check(run(), "plane_sweep")
                torch.cuda.synchronize()
                if not torch.allclose(out, want, atol=atol, rtol=rtol):
                    print(f"plane_sweep {name} {shape}: WRONG at {threads} "
                          f"threads, P {ppb}, tiles {code}", flush=True)
                    ok = False
                    continue
                ms = smoke.time_ms(run, reps=args.reps)
                tiles = tuple(FA.K5_TILES[b] for b in bits)
                times[(threads, ppb, tiles)] = ms
                if out_file:
                    out_file.write(json.dumps(dict(
                        kernel=name, shape=shape, threads=threads, P=ppb,
                        tiles=tiles, ms=ms)) + "\n")
        mine = times[(plan.threads, plan.planes_per_block, plan.tiles)]
        best = min(times, key=times.get)
        in_grid = [k for k in times
                   if -(-nplanes // k[1]) >= min(FA.NUM_SMS, nplanes)]
        best_grid = min(in_grid, key=times.get)
        print(f"plane_sweep {name} {shape}: plan {plan.threads} threads, P "
              f"{plan.planes_per_block}, tiles {plan.tiles}: {mine:.4f} ms; "
              f"quickest within one wave {best_grid}: "
              f"{times[best_grid]:.4f} ms; quickest {best}: "
              f"{times[best]:.4f} ms", flush=True)
    if out_file:
        out_file.close()
    return 0 if ok else 1


def level_sweep(torch, smoke, kernels, FA, lib, args):
    """K5's (``args.bwd``: K5b's) bf16 variant at ``args.level`` over P
    planes an iteration and 1 or 2 blocks an SM (K5b: with its operators
    resident and phased) at each shape of its KERNELS row, against
    ``plane_mma_plan`` (``plane_mma_bwd_plan``)."""
    level, dev = args.level, torch.device("cuda")
    name = "filtered_act_plane_bwd" if args.bwd else "filtered_act_plane"
    g = torch.Generator(dev).manual_seed(0)
    out_file = open(args.out, "w") if args.out else None
    ok = True
    for shape in smoke.KERNELS[name]["shapes"]:
        n, c, H, W = shape
        nplanes = n * c
        x = torch.randn(shape, device=dev, generator=g)
        out = torch.empty_like(x)
        ins = (x,)
        if args.bwd:
            gr = torch.randn(shape, device=dev, generator=g)
            ins = (x, gr)
        plain = getattr(FA, f"{name}_plain")
        want = plain(*ins, "silu", level)
        own = want - plain(*ins, "silu", "highest")
        own_rms = float(own.double().pow(2).mean().sqrt())
        own_max = float(own.abs().max())
        del own
        ptrs = [*(t.data_ptr() for t in ins), out.data_ptr(),
                *(o.data_ptr() for o in FA._mma_blobs(H, W, dev, args.bwd))]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if args.bwd:
            plan = FA.plane_mma_bwd_plan(H, W, nplanes, level)
            mine = (plan.planes, plan.per_sm, plan.resident)
        else:
            plan = FA.plane_mma_plan(H, W, nplanes, level)
            mine = (plan.planes, plan.per_sm, True)
        times = {}
        for resident, planes in itertools.product(
                (True, False) if args.bwd else (True,),
                _candidates(nplanes, plan.planes,
                            max(1, nplanes // FA.NUM_SMS))):
            smem = (FA.plane_mma_bwd_smem_bytes(H, W, planes, level, 4,
                                                resident) if args.bwd
                    else FA.plane_mma_smem_bytes(H, W, planes, level))
            if smem > FA.SMEM_MAX_BYTES:
                continue
            groups = -(-nplanes // planes)
            held = FA.SMEM_SM_BYTES // (smem + FA.SMEM_BLOCK_RESERVED)
            for per_sm in range(1, min(held, FA.K5_MMA_BLOCKS[level]) + 1):
                grid = min(groups, per_sm * FA.NUM_SMS)
                tail = ((int(resident),) if args.bwd else ()) + (
                    FA.LEVEL_PASSES[level], FA.ACT_CODES["silu"], stream)

                def run():
                    return getattr(lib, f"{name}_bf16")(
                        *ptrs, nplanes, H, W, planes, grid, *tail)
                kernels.check(run(), "plane_sweep")
                torch.cuda.synchronize()
                d = out - want
                ratio = float(d.double().pow(2).mean().sqrt()) / own_rms
                if ratio > smoke.LEVEL_RMS_RATIO or \
                        float(d.abs().max()) > own_max:
                    print(f"plane_sweep {name}:{level} {shape}: WRONG at P "
                          f"{planes}, grid {grid}, resident {resident} (RMS "
                          f"ratio {ratio:.4f})", flush=True)
                    ok = False
                    continue
                ms = smoke.time_ms(run, reps=args.reps)
                times[(planes, per_sm, resident)] = ms
                if out_file:
                    rounds = (FA.plane_mma_bwd_rounds if args.bwd
                              else FA.plane_mma_rounds)(H, W, planes, level)
                    out_file.write(json.dumps(dict(
                        kernel=f"{name}:{level}", shape=shape, P=planes,
                        per_sm=per_sm, grid=grid, resident=resident,
                        smem=smem, rounds=rounds, ms=ms)) + "\n")
        best = min(times, key=times.get)
        print(f"plane_sweep {name}:{level} {shape}: plan P {mine[0]}, "
              f"{mine[1]} an SM, {'resident' if mine[2] else 'phased'}, "
              f"grid {plan.grid}: {times[mine]:.4f} ms; quickest (P, an "
              f"SM, resident) {best}: {times[best]:.4f} ms; all: "
              + ", ".join(f"{k[0]}/{k[1]}/{'rp'[not k[2]]} {v:.4f}"
                          for k, v in sorted(times.items())), flush=True)
        del x, out, want, ins
        torch.cuda.empty_cache()
    if out_file:
        out_file.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
