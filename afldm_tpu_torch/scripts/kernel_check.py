"""Phase 2 of ``chip_smoke.py`` alone: build the kernels of a checkout, hold
each against its plain version at ``chip_smoke.KERNELS``' shapes and time
kernel, plain version, library call and bound, without the end-to-end
phases. Run it as a file from the root of the checkout to measure, so that
two commits' kernels can be timed in turns within one call on one card:

    python afldm_tpu_torch/scripts/kernel_check.py [kernel names ...]
    cd <other checkout> && python \
        <this checkout>/afldm_tpu_torch/scripts/kernel_check.py flash_fwd

Prints chip_smoke's ``check ...`` line per shape and exits non-zero if a
kernel disagrees with its plain version.
"""

import importlib
import sys
from pathlib import Path


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv)
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
    kernels.build_all()
    unknown = set(names) - set(smoke.KERNELS)
    if unknown:
        print(f"kernel_check: unknown kernels {sorted(unknown)}",
              file=sys.stderr)
        return 1
    smoke.KERNELS = {k: v for k, v in smoke.KERNELS.items()
                     if not names or k in names}
    report = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      library_ms=None) for k in smoke.KERNELS}
    return 0 if smoke.check_kernels(torch, report) else 1


if __name__ == "__main__":
    sys.exit(main())
