"""Hand-written Hopper kernels: build, load and launch bookkeeping.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``_build/`` (listed in ``.gitignore``)
at first use, then loaded with ``ctypes``. The library name carries a hash
of the source, so an edited source is never served by a stale build.
Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the plain versions run.

``LAUNCHES`` counts the kernel launches of each wrapper; a wrapper adds
one exactly where it launches its kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("filtered_act", "flash_fwd", "flash_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"filtered_act_plane": 0, "filtered_act_banded": 0,
            "flash_fwd": 0, "filtered_act_plane_bwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "filtered_act_banded_bwd": 0}

_LIBS = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "filtered_act": {
        # x, out, uh, uwT, dh, dwT, nplanes, H, W, planes_per_block, act, stream
        "filtered_act_plane_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P],
        # x, g, dx, uh, uwT, dhT, dw, uw, uhT, nplanes, H, W,
        # planes_per_block, act, stream
        "filtered_act_plane_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _P],
        # x, out, uh, uwT, dh, dwT, nplanes, H, W, band_rows, acc_in_smem,
        # act, stream
        "filtered_act_banded_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _P],
        # x, g, dx, uh, uwT, dhT, dw, uw, uhT, nplanes, H, W, band_rows,
        # acc_in_smem, act, stream
        "filtered_act_banded_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_fwd": {
        # q, k, v, out, lse, B1, B2, Lq, Lk, D,
        # q strides (b1, b2, l), k strides, v strides, scale, stream
        "flash_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    },
    "flash_bwd": {
        # q, k, v, dO, lse, delta, dq, B1, B2, Lq, Lk, D,
        # q, k, v, dO strides (b1, b2, l), scale, stream
        "flash_bwd_dq_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             *[_L] * 12, _F, _P],
        # q, k, v, dO, lse, delta, dk, dv, B1, B2, Lq, Lk, D,
        # q, k, v, dO strides (b1, b2, l), scale, stream
        "flash_bwd_dkv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, *[_L] * 12, _F, _P],
    },
}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together. Returns {name: path of the .so}. Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [n for n in SOURCES if not _target(n).exists()]
    nvcc = _nvcc() if missing else None
    procs = {}
    for name in missing:
        so = _target(name)
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(so) + ".tmp",
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, so)
    failed = []
    for name, (proc, log, so) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(str(so) + ".tmp", so)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {name: _target(name) for name in SOURCES}


def build_log(name: str) -> str:
    """The compiler's output (register and shared-memory use) of the last
    build of ``name``, or '' when it was built by an earlier process."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        paths = build_all()
        lib = ctypes.CDLL(str(paths[name]))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, what: str):
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
