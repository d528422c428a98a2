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
the banded chains' scratch cap a chunk (``BANDED_SCRATCH_BYTES``: K1's and,
since it runs the same chain, K2's).

Prints chip_smoke's ``check ...`` line per shape and each kernel's sums
over the shapes run, and exits non-zero if a kernel disagrees with its
plain version. The filtered activation's kernels are also run in their
bf16 variants at the reduced precision levels ('high', 'default'), as
chip_smoke's phase 30 runs them, beside the f32 kernel (where the
checkout's chip_smoke has that phase); and the bf16-activation variants
of K5, K1 (at every level), K3 and K6 as its phase 33 runs them, each
beside its f32 kernel on the same values in float32 and, for K3 and K6,
the library call at bf16 (where the checkout's chip_smoke has that
phase).
"""

import argparse
import importlib
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
    importlib.import_module("afldm_tpu_torch.ops").set_af_precision("highest")
    if args.banded_scratch_bytes:
        fa = importlib.import_module("afldm_tpu_torch.ops.filtered_act")
        fa.BANDED_SCRATCH_BYTES = args.banded_scratch_bytes
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
    for k, row in report.items():  # an older chip_smoke logs no sums
        lib = row["library_ms"]
        shapes = smoke.KERNELS[k.split(":")[0].split("/")[0]]["shapes"]
        print(f"kernel_check sum {k} over {len(shapes)} "
              f"shapes: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
