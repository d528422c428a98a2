"""Phase 2 of ``chip_smoke.py`` alone: build the kernels of a checkout, hold
each against its plain version at ``chip_smoke.KERNELS``' shapes and time
kernel, plain version, library call and bound, without the end-to-end
phases. Run it as a file from the root of the checkout to measure, so that
two commits' kernels can be timed in turns within one call on one card:

    python afldm_tpu_torch/scripts/kernel_check.py [kernel names ...]
    cd <other checkout> && python \
        <this checkout>/afldm_tpu_torch/scripts/kernel_check.py flash_fwd

``--shapes_from <path of a chip_smoke.py>`` times the named kernels at that
file's shapes instead of the checkout's own, so that an older checkout's
kernels are timed at shapes added since; ``--banded_scratch_bytes`` sets
the banded GEMM chains' scratch cap a chunk (``BANDED_SCRATCH_BYTES``: the
f32 K1's and K2's at every level), ``--banded_hi_bytes`` the cap of K1's
level chain's hi pieces (K2's: m's) a chunk (``BANDED_HI_BYTES``, where
the checkout has it).

Other modes replace the checks, for comparing two checkouts in one call:
``--spread n,h,Lq,Lk,D,n_kv [--seeds N]`` runs K3/bf16 at that shape (K/V
expanded from n_kv images) on N seeded draws against the checkout's plain
version (``flash_fwd_plain`` where the checkout has it, else the plain
softmax attention) and prints the spread of the RMS ratio that
``test_flash_bf16_matches_plain`` bounds; ``--spread_bwd`` does the same
for K4a/bf16 and K4b/bf16 (dq, dk and dv apart, and with K4b's split
turned off where the checkout splits); ``--digest`` prints a SHA-256 of
the outputs of the f32 K3, K6, K4a and K4b and of K4a, K4b, K3, K6 and P1
at bf16 at their KERNELS shapes on seeded inputs (the backward given the
plain forward's out and lse), so that equal lines mean bit-identical
outputs, and of the filtered activation's kernels K5, K5b, K1 and K2 at
the reduced levels ('high', 'default'), f32 and bf16 x, at theirs (K1's
and K2's up to LEVEL_MAX); ``--graph`` times K3/bf16, K6/bf16, K4a/bf16
and K4b/bf16 and the level variants of K5, K5b, K1 and K2, f32 and bf16 x,
K5b's f32 kernel beside them (those named, where kernels are named:
``filtered_act_plane`` names K5's, ``filtered_act_plane_bwd`` K5b's,
``filtered_act_banded`` K1's, ``filtered_act_banded_bwd`` K2's) at
their KERNELS shapes by replaying a CUDA graph of the wrapper calls, so
that a shape whose call is bound by the host's launch path (L = 4, a 4
px plane) is timed on the device alone, and beside each level variant's
time the device time a call of each CUDA kernel it launches
(``torch.profiler``), so that a chain's launches are timed apart.

Prints chip_smoke's ``check ...`` line per shape and each kernel's sums
over the shapes run, and exits non-zero if a kernel disagrees with its
plain version. The filtered activation's kernels are also run in their
bf16 variants at the reduced precision levels ('high', 'default'), as
chip_smoke's phase 30 runs them, beside the f32 kernel (where the
checkout's chip_smoke has that phase); and the bf16-activation variants
of K5, K1 (at every level), K3 and K6 as its phase 33 runs them, each
beside its f32 kernel on the same values in float32 and, for K3 and K6,
the library call at bf16 (where the checkout's chip_smoke has that
phase), and the split bf16 K4b's reduction (where it has that row).
"""

import argparse
import importlib
import itertools
import importlib.util
import sys
from pathlib import Path


def _shapes_of(path):
    spec = importlib.util.spec_from_file_location("_shapes_source", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNELS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="kernels to check (all)")
    ap.add_argument("--shapes_from", default=None,
                    help="a chip_smoke.py whose shapes to time")
    ap.add_argument("--banded_scratch_bytes", type=int, default=None,
                    help="the banded chains' scratch cap a chunk of "
                         "planes (default: ops/filtered_act.py's)")
    ap.add_argument("--banded_hi_bytes", type=int, default=None,
                    help="K1's (K2's) level chain's cap of hi (m) pieces "
                         "a chunk "
                         "(default: ops/filtered_act.py's)")
    ap.add_argument("--spread", default=None,
                    help="n,h,Lq,Lk,D,n_kv: K3/bf16's RMS ratio over seeds")
    ap.add_argument("--spread_bwd", default=None,
                    help="n,h,Lq,Lk,D,n_kv: K4a/bf16's and K4b/bf16's RMS "
                         "ratios over seeds")
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--digest", action="store_true",
                    help="SHA-256 of the flash kernels' outputs, f32 and "
                         "bf16, and of K5's, K5b's, K1's and K2's level "
                         "variants")
    ap.add_argument("--graph", action="store_true",
                    help="the bf16 flash kernels' and K5's, K5b's, K1's and "
                         "K2's level variants' device times from CUDA graph "
                         "replays")
    args = ap.parse_args(argv)
    names = args.names
    root = Path.cwd()
    if not (root / "chip_smoke.py").exists():
        print("kernel_check: run from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))  # that checkout's package and chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("kernel_check: no CUDA device", file=sys.stderr)
        return 1
    smoke = importlib.import_module("chip_smoke")
    kernels = importlib.import_module("afldm_tpu_torch.kernels")
    fa = importlib.import_module("afldm_tpu_torch.ops.filtered_act")
    if args.banded_scratch_bytes:
        fa.BANDED_SCRATCH_BYTES = args.banded_scratch_bytes
    if args.banded_hi_bytes:
        fa.BANDED_HI_BYTES = args.banded_hi_bytes
    if args.spread or args.spread_bwd or args.digest or args.graph:
        kernels.build_all()
        attn = importlib.import_module("afldm_tpu_torch.ops.attention")
        if args.spread:
            spread(torch, attn, smoke,
                   tuple(int(x) for x in args.spread.split(",")), args.seeds)
        if args.spread_bwd:
            spread_bwd(torch, attn, smoke, tuple(
                int(x) for x in args.spread_bwd.split(",")), args.seeds)
        if args.digest:
            digest(torch, attn, smoke, names)
        if args.graph:
            graph_times(torch, attn, smoke, names)
        return 0
    importlib.import_module("afldm_tpu_torch.ops").set_af_precision("highest")
    kernels.build_all()
    unknown = set(names) - set(smoke.KERNELS)
    if unknown:
        print(f"kernel_check: unknown kernels {sorted(unknown)}",
              file=sys.stderr)
        return 1
    smoke.KERNELS = {k: v for k, v in smoke.KERNELS.items()
                     if not names or k in names}
    if args.shapes_from:
        other = _shapes_of(args.shapes_from)
        for k, spec in smoke.KERNELS.items():
            spec.update({key: other[k][key] for key in ("shapes",
                                                         "base_shapes")
                         if key in other[k]})
    report = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      library_ms=None) for k in smoke.KERNELS}
    ok = smoke.check_kernels(torch, report)
    if hasattr(smoke, "check_level_kernels"):
        level_names = [k for k in smoke.LEVEL_KERNELS if k in smoke.KERNELS]
        report.update({f"{k}:{level}": dict(max_abs_err=0.0, rms_ratio=0.0,
                                            ms=0.0, plain_ms=0.0,
                                            bound_ms=0.0, library_ms=None)
                       for k in level_names for level in smoke.LEVELS})
        ok &= smoke.check_level_kernels(torch, report, level_names)
    if hasattr(smoke, "check_bf16_kernels"):
        smoke.BF16_ROWS = tuple(r for r in smoke.BF16_ROWS
                                if r[1] in smoke.KERNELS)
        report.update({row: dict(max_abs_err=0.0, rms_ratio=0.0,
                                 ulp_share=0.0, max_ulps=0, ms=0.0,
                                 f32_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                 library_ms=None)
                       for row, _, _ in smoke.BF16_ROWS})
        ok &= smoke.check_bf16_kernels(torch, report)
    if hasattr(smoke, "check_dkv_reduce") and "flash_bwd_dkv" in \
            smoke.KERNELS:
        report[smoke.REDUCE_ROW] = dict(max_abs_err=0.0, ms=0.0,
                                        plain_ms=0.0, bound_ms=0.0,
                                        library_ms=None)
        ok &= smoke.check_dkv_reduce(torch, report)
    for k, row in report.items():  # an older chip_smoke logs no sums
        lib = row["library_ms"]
        shapes = (smoke.reduce_shapes() if k == getattr(smoke, "REDUCE_ROW",
                                                        None)
                  else smoke.KERNELS[k.split(":")[0].split("/")[0]]
                  ["shapes"])
        print(f"kernel_check sum {k} over {len(shapes)} "
              f"shapes: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
    return 0 if ok else 1


def spread(torch, attn, smoke, shape, seeds):
    """K3/bf16 at ``shape`` against the checkout's plain version on
    ``seeds`` draws: RMS(kernel - plain) / RMS(plain - the f32 plain), and
    the largest difference in bf16 ulps of the output's scale."""
    n, h, L, Lk, d, n_kv = shape
    bf, dev = torch.bfloat16, torch.device("cuda")
    plain = getattr(attn, "flash_fwd_plain", attn._attention_plain)
    ratios, ulps = [], []
    for seed in range(seeds):
        g = torch.Generator(dev).manual_seed(seed)
        q = torch.randn(n, h, L, d, device=dev, generator=g).to(bf)
        k, v = (torch.randn(n_kv, h, Lk, d, device=dev, generator=g).to(bf)
                .expand(n, -1, -1, -1) for _ in range(2))
        got = attn.flash_fwd(q, k, v)[0].float()
        want = plain(q, k, v)[0].float()
        want32 = attn._attention_plain(q.float(), k.float(), v.float())[0]
        gap = float((want - want32).double().pow(2).mean().sqrt())
        ratios.append(float((got - want).double().pow(2).mean().sqrt())
                      / gap)
        _, e = torch.frexp(want.abs().max())
        ulps.append(float((got - want).abs().max()) / 2.0 ** (int(e) - 8))
    ratios.sort()
    over = sum(r > smoke.BF16_FLASH_RATIO for r in ratios)
    print(f"kernel_check spread flash_fwd/bf16 {shape} over {seeds} seeds "
          f"(plain {plain.__name__}): RMS ratio min {ratios[0]:.4f} median "
          f"{ratios[len(ratios) // 2]:.4f} p90 "
          f"{ratios[int(0.9 * len(ratios))]:.4f} max {ratios[-1]:.4f}, "
          f"{over} above {smoke.BF16_FLASH_RATIO}; max ulps of the scale "
          f"{max(ulps):.3f}", flush=True)


def spread_bwd(torch, attn, smoke, shape, seeds):
    """K4a/bf16 and K4b/bf16 at ``shape`` against the checkout's plain
    versions on ``seeds`` draws (``test_flash_bwd_bf16_matches_plain``'s
    inputs and ratio: RMS(kernel - plain) / RMS(plain - the f32 plain), for
    dq, dk and dv apart); where the checkout splits K4b's query walk, also
    with the split turned off (``flash_bwd_dkv_splits`` = 1)."""
    n, h, L, Lk, d, n_kv = shape
    bf, dev = torch.bfloat16, torch.device("cuda")
    variants = {"kernel": None}
    if getattr(attn, "flash_bwd_dkv_splits", lambda *a: 1)(n * h, L, Lk,
                                                           d) > 1:
        variants["unsplit"] = lambda *a: 1
    for label, plan in variants.items():
        planned = getattr(attn, "flash_bwd_dkv_splits", None)
        if plan is not None:
            attn.flash_bwd_dkv_splits = plan
        ratios = ([], [], [])
        try:
            for seed in range(seeds):
                g = torch.Generator(dev).manual_seed(seed)
                q = torch.randn(n, h, L, d, device=dev, generator=g).to(bf)
                k, v = (torch.randn(n_kv, h, Lk, d, device=dev, generator=g)
                        .to(bf).expand(n, -1, -1, -1) for _ in range(2))
                do = torch.randn(n, h, L, d, device=dev, generator=g).to(bf)
                out, lse = attn._attention_plain(q, k, v)
                delta = attn._delta(do, out)
                got = (attn.flash_bwd_dq(q, k, v, do, lse, delta),
                       *attn.flash_bwd_dkv(q, k, v, do, lse, delta))
                want = attn._attention_bwd_plain(q, k, v, out, lse, do)
                want32 = attn._attention_bwd_plain(
                    q.float(), k.float(), v.float(), out.float(), lse,
                    do.float())
                for r, a, b, c in zip(ratios, got, want, want32):
                    gap = (b.float() - c.float()).double().pow(2).mean()
                    r.append(float((a.float() - b.float()).double().pow(2)
                                   .mean().sqrt() / gap.sqrt()))
        finally:
            if plan is not None:
                attn.flash_bwd_dkv_splits = planned
        for name, r in zip(("dq", "dk", "dv"), ratios):
            r.sort()
            over = sum(x > smoke.BF16_FLASH_RATIO for x in r)
            print(f"kernel_check spread_bwd {label} {name} {shape} over "
                  f"{seeds} seeds: RMS ratio median {r[len(r) // 2]:.4f} p90 "
                  f"{r[int(0.9 * len(r))]:.4f} max {r[-1]:.4f}, {over} above "
                  f"{smoke.BF16_FLASH_RATIO}", flush=True)


def digest(torch, attn, smoke, names=()):
    """One line a kernel, dtype and shape: the SHA-256 of its outputs on
    inputs drawn from a seed of the kernel and shape; only the kernels of
    ``names`` where it names any."""
    import hashlib
    import zlib
    dev = torch.device("cuda")
    probes = importlib.import_module("afldm_tpu_torch.ops.flash_probes")
    for name, dt in (("flash_fwd", torch.float32),
                     ("flash2_fwd", torch.float32),
                     ("flash_bwd_dq", torch.float32),
                     ("flash_bwd_dkv", torch.float32),
                     ("flash_bwd_dq", torch.bfloat16),
                     ("flash_bwd_dkv", torch.bfloat16),
                     ("flash_fwd", torch.bfloat16),
                     ("flash2_fwd", torch.bfloat16),
                     ("flash_probe_dots", torch.bfloat16)):
        if names and name not in names:
            continue
        for shape in smoke.KERNELS[name]["shapes"]:
            n, h, L, Lk, d, n_kv = smoke._flash_dims(shape)
            g = torch.Generator(dev).manual_seed(
                zlib.crc32(repr((name, shape)).encode()))
            q, do = (torch.randn(n, h, L, d, device=dev, generator=g).to(dt)
                     for _ in range(2))
            k, v, k1, v1 = (torch.randn(n_kv, h, Lk, d, device=dev,
                                        generator=g).to(dt)
                            .expand(n, -1, -1, -1) for _ in range(4))
            if name == "flash_fwd":
                outs = attn.flash_fwd(q, k, v)
            elif name == "flash_probe_dots":
                outs = (probes.flash_probe_dots(q, k, v),)
            elif name == "flash2_fwd":
                alpha = torch.linspace(0, 1, n, device=dev)[:, None, None]
                outs = (attn.flash2_fwd(q, k, v, k1, v1, alpha),)
            else:
                out, lse = attn._attention_plain(q, k, v)
                delta = attn._delta(do, out)
                outs = getattr(attn, name)(q, k, v, do, lse, delta)
                outs = outs if isinstance(outs, tuple) else (outs,)
            torch.cuda.synchronize()
            hsh = hashlib.sha256()
            for o in outs:
                hsh.update(o.contiguous().cpu().view(torch.uint8).numpy()
                           .tobytes())
            print(f"kernel_check digest {name} {str(dt)[6:]} {shape} "
                  f"{hsh.hexdigest()}", flush=True)
            del q, do, k, v, k1, v1, outs
        torch.cuda.empty_cache()
    fa = importlib.import_module("afldm_tpu_torch.ops.filtered_act")
    ops = importlib.import_module("afldm_tpu_torch.ops")
    for name, level, dt in itertools.product(
            ("filtered_act_plane", "filtered_act_plane_bwd",
             "filtered_act_banded", "filtered_act_banded_bwd"),
            ("high", "default"), (torch.float32, torch.bfloat16)):
        if names and name not in names:
            continue
        for shape in smoke.KERNELS[name]["shapes"]:
            if max(shape[-2:]) > fa.LEVEL_MAX:
                continue
            g = torch.Generator(dev).manual_seed(
                zlib.crc32(repr((name, level, shape)).encode()))
            x, gr = (torch.randn(shape, device=dev, generator=g).to(dt)
                     for _ in range(2))
            try:
                ops.set_af_precision(level)
                fn = getattr(fa, name)
                out = (fn(x, gr, "silu") if name.endswith("_bwd")
                       else fn(x, "silu"))
                torch.cuda.synchronize()
            finally:
                ops.set_af_precision("highest")
            hsh = hashlib.sha256(out.contiguous().cpu().view(torch.uint8)
                                 .numpy().tobytes())
            print(f"kernel_check digest {name}:{level} {str(dt)[6:]} "
                  f"{shape} {hsh.hexdigest()}", flush=True)
            del x, gr, out
        torch.cuda.empty_cache()


def _graph_ms(torch, fn, calls, replays):
    """The device time of one call of ``fn``, from ``replays`` replays of
    a CUDA graph that holds ``calls`` calls (after two calls outside it),
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def _split_ms(torch, fn, calls=3):
    """{CUDA kernel name: device ms a call of ``fn``} under
    ``torch.profiler``, over ``calls`` calls after one outside it."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def graph_times(torch, attn, smoke, names=(), calls=10, replays=20):
    """K3/bf16, K6/bf16, K4a/bf16 and K4b/bf16 (with its reduction where
    it splits), and the level variants of K5, K5b, K1 and K2 (K5b's f32
    kernel beside them) on an f32 and a bf16 x (K1's and K2's up to LEVEL_MAX), at their KERNELS shapes: the
    device time of one wrapper call (``_graph_ms``; for the level variants
    also each kernel's, ``_split_ms``); only the kernels of ``names`` where
    it names any."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    total = {}
    for name in ("flash_fwd", "flash2_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if names and name not in names:
            continue
        for shape in smoke.KERNELS[name]["shapes"]:
            n, h, L, Lk, d, n_kv = smoke._flash_dims(shape)
            g = torch.Generator(dev).manual_seed(0)
            q = torch.randn(n, h, L, d, device=dev, generator=g).to(bf)
            kv = [torch.randn(n_kv, h, Lk, d, device=dev, generator=g)
                  .to(bf).expand(n, -1, -1, -1) for _ in range(4)]
            alpha = torch.linspace(0, 1, n, device=dev)[:, None, None]
            do = torch.randn(n, h, L, d, device=dev, generator=g).to(bf)
            if name == "flash_fwd":
                def fn():
                    return attn.flash_fwd(q, kv[0], kv[1])
            elif name == "flash2_fwd":
                def fn():
                    return attn.flash2_fwd(q, *kv, alpha)
            else:
                out, lse = attn._attention_plain(q, kv[0], kv[1])
                delta = attn._delta(do, out)
                bwd = getattr(attn, name)

                def fn():
                    return bwd(q, kv[0], kv[1], do, lse, delta)
            ms = _graph_ms(torch, fn, calls, replays)
            total[f"{name}/bf16"] = total.get(f"{name}/bf16", 0.0) + ms
            print(f"kernel_check graph {name}/bf16 {shape}: {ms:.4f} ms a "
                  "call", flush=True)
            del q, kv, do, fn
            torch.cuda.empty_cache()
    fa = importlib.import_module("afldm_tpu_torch.ops.filtered_act")
    ops = importlib.import_module("afldm_tpu_torch.ops")
    for name, level, dt in itertools.product(
            ("filtered_act_plane", "filtered_act_plane_bwd",
             "filtered_act_banded", "filtered_act_banded_bwd"),
            ("highest", "high", "default"), (torch.float32, bf)):
        # K5b alone also at 'highest': its f32 kernel on the same values
        if (names and name not in names) or (
                level == "highest" and name != "filtered_act_plane_bwd"):
            continue
        label = (name if level == "highest" else f"{name}:{level}") + (
            "/bf16" if dt == bf else "")
        fn = getattr(fa, name)
        for shape in smoke.KERNELS[name]["shapes"]:
            if max(shape[-2:]) > fa.LEVEL_MAX:
                continue
            g = torch.Generator(dev).manual_seed(0)
            x, gr = (torch.randn(shape, device=dev, generator=g).to(dt)
                     for _ in range(2))
            try:
                ops.set_af_precision(level)
                # the banded calls take milliseconds: fewer of them
                few = name.startswith("filtered_act_banded")
                call = ((lambda: fn(x, gr, "silu")) if name.endswith("_bwd")
                        else (lambda: fn(x, "silu")))
                ms = _graph_ms(torch, call, 2 if few else calls,
                               5 if few else replays)
                parts = _split_ms(torch, call)
            finally:
                ops.set_af_precision("highest")
            total[label] = total.get(label, 0.0) + ms
            print(f"kernel_check graph {label} {shape}: {ms:.4f} ms a "
                  "call", flush=True)
            for kernel, part in sorted(parts.items(), key=lambda kv: -kv[1]):
                print(f"kernel_check graph split {label} {shape}: "
                      f"{part:.4f} ms a call {kernel[:120]}", flush=True)
            del x, gr
            torch.cuda.empty_cache()
    for name, ms in total.items():
        print(f"kernel_check graph sum {name}: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
