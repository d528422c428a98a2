"""Hand-written Hopper kernels: build, load and launch bookkeeping.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``_build/`` (listed in ``.gitignore``)
at first use, then loaded with ``ctypes``. The library name carries a hash
of the source, of every shared header ``csrc/*.cuh`` and of the flags, so
an edited source or header is never served by a stale build.
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
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("filtered_act", "filtered_banded_mma", "flash_fwd", "flash_bwd",
           "flash2_fwd", "flash_probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"filtered_act_plane": 0, "filtered_act_banded": 0,
            "flash_fwd": 0, "filtered_act_plane_bwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "filtered_act_banded_bwd": 0,
            "flash2_fwd": 0, "flash_probe_dots": 0,
            "flash_probe_stream": 0, "filtered_gemm": 0,
            # the split bf16 K4b's reduction of its f32 partials
            "flash_bwd_dkv_reduce": 0}
# the bf16 tensor-core variants of the filtered activation's kernels, one
# count per reduced precision level ("filtered_act_plane:high", ...)
LEVEL_KERNELS = ("filtered_act_plane", "filtered_act_banded",
                 "filtered_act_plane_bwd", "filtered_act_banded_bwd",
                 "filtered_gemm")
LAUNCHES.update({f"{k}:{level}": 0 for k in LEVEL_KERNELS
                 for level in ("high", "default")})
# the variants that take bfloat16 activations, one count per variant they
# shadow ("filtered_act_plane/bf16", "filtered_act_plane:high/bf16", ...)
BF16_KERNELS = tuple(f"{k}{level}" for k in (
    "filtered_act_plane", "filtered_act_banded", "filtered_act_plane_bwd",
    "filtered_act_banded_bwd") for level in ("", ":high", ":default")) + (
    "flash_fwd", "flash2_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "flash_probe_dots", "flash_probe_stream")
LAUNCHES.update({f"{k}/bf16": 0 for k in BF16_KERNELS})

_LIBS = {}
# wall seconds of each source's nvcc in this process's last build_all (the
# builds run in parallel, so they overlap)
BUILD_SECONDS = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "filtered_act": {
        # x, out, uhT, uwT, dwT, dhT, nplanes, H, W, planes_per_block,
        # tile codes, threads, act, stream
        "filtered_act_plane_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _P],
        # x, g, dx, uhT, uwT, dh, dw, uw, uh, nplanes, H, W,
        # planes_per_block, tile codes, threads, act, stream
        "filtered_act_plane_bwd_f32": [*[_P] * 9, _I, _I, _I, _I, _I, _I,
                                       _I, _P],
        # x, out, scratch, uwT, uhT, dwT, dhT, nplanes (of the chunk), H, W,
        # tile codes, act, stream
        "filtered_act_banded_f32": [*[_P] * 7, _I, _I, _I, _I, _I, _P],
        # A, lda, sA, a_kmajor, B, ldb, sB, C, ldc, sC, batch, M, N, K,
        # small, act, mul_act_grad, stream
        "filtered_gemm_f32": [_P, _L, _L, _I, _P, _L, _L, _P, _L, _L, _I, _I,
                              _I, _I, _I, _I, _I, _P],
        # x, g, dx, scratch, uwT, uhT, dw, dh, uw, uh, nplanes (of the
        # chunk), H, W, tile codes, act, stream
        "filtered_act_banded_bwd_f32": [*[_P] * 10, _I, _I, _I, _I, _I, _P],
        # the reduced levels' bf16 variants, ``passes`` 3 or 1 before act:
        # x, out, the split blobs of U_hᵀ, U_wᵀ, D_wᵀ, D_hᵀ, nplanes, H, W,
        # planes an iteration, grid, passes, act, stream
        "filtered_act_plane_bf16": [*[_P] * 6, *[_I] * 7, _P],
        # x, g, dx, the split blobs of U_hᵀ, D_h, U_wᵀ, D_w, U_w, U_h,
        # nplanes, H, W, planes_per_block, passes, act, stream
        "filtered_act_plane_bwd_bf16": [*[_P] * 9, _I, _I, _I, _I, _I, _I,
                                        _P],
        # as filtered_gemm_f32, with passes after small
        "filtered_gemm_bf16": [_P, _L, _L, _I, _P, _L, _L, _P, _L, _L, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P],
        # bfloat16 x and out (``_xbf16``) beside the f32 kernel and the
        # reduced levels' products (``_f32``, ``_bf16``): the same arguments
        "filtered_act_plane_f32_xbf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _I, _I, _P],
        "filtered_act_plane_bf16_xbf16": [*[_P] * 6, *[_I] * 7, _P],
        "filtered_act_banded_f32_xbf16": [*[_P] * 7, _I, _I, _I, _I, _I,
                                          _P],
        # bfloat16 x, g and dx beside the backward kernels: the same
        # arguments
        "filtered_act_plane_bwd_f32_xbf16": [*[_P] * 9, _I, _I, _I, _I, _I,
                                             _I, _I, _P],
        "filtered_act_plane_bwd_bf16_xbf16": [*[_P] * 9, _I, _I, _I, _I, _I,
                                              _I, _P],
        "filtered_act_banded_bwd_f32_xbf16": [*[_P] * 10, _I, _I, _I, _I, _I,
                                              _P],
    },
    "filtered_banded_mma": {
        # K1 at a reduced level: x, out, scratch (hi's bf16 pieces), the
        # split blobs of U_hᵀ, U_wᵀ, D_hᵀ, D_wᵀ, nplanes (of the chunk), H,
        # W, the down launch's strip rows, passes, act, stream
        "filtered_act_banded_bf16": [*[_P] * 7, *[_I] * 6, _P],
        # bfloat16 x and out: the same arguments
        "filtered_act_banded_bf16_xbf16": [*[_P] * 7, *[_I] * 6, _P],
        # K2 at a reduced level: x, g, dx, scratch (m's bf16 pieces), the
        # split blobs of U_hᵀ, D_h, U_wᵀ, D_w, U_w, U_h, nplanes (of the
        # chunk), H, W, the up and the down launch's strip rows, passes,
        # act, stream
        "filtered_act_banded_bwd_bf16": [*[_P] * 10, *[_I] * 7, _P],
        # bfloat16 x, g and dx: the same arguments
        "filtered_act_banded_bwd_bf16_xbf16": [*[_P] * 10, *[_I] * 7, _P],
    },
    "flash_fwd": {
        # q, k, v, out, lse, B1, B2, Lq, Lk, D,
        # q strides (b1, b2, l), k strides, v strides, scale, stream
        "flash_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
        # bfloat16 q, k, v and out, f32 lse: the same arguments
        "flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
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
        # bfloat16 q, k, v, dO and gradients, f32 lse and delta: the same
        # arguments
        "flash_bwd_dq_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, *[_L] * 12, _F, _P],
        "flash_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, *[_L] * 12, _F, _P],
        # the split dkv: q, k, v, dO, lse, delta, the f32 partials, B1, B2,
        # Lq, Lk, D, the strides, scale, splits, stream
        "flash_bwd_dkv_bf16_split": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, *[_L] * 12, _F, _I, _P],
        # the partials, bf16 dk and dv, 2·B1·B2·Lk·D, splits, stream
        "flash_bwd_dkv_reduce": [_P, _P, _L, _I, _P],
    },
    "flash2_fwd": {
        # q, k0, v0, k1, v1, alpha, out, B1, B2, Lq, Lk, D,
        # q, k0, v0, k1, v1 strides (b1, b2, l), scale, stream
        "flash2_fwd_f32": [*[_P] * 7, _I, _I, _I, _I, _I, *[_L] * 15, _F,
                           _P],
        # bfloat16 q, k0, v0, k1, v1 and out, f32 alpha: the same arguments
        "flash2_fwd_bf16": [*[_P] * 7, _I, _I, _I, _I, _I, *[_L] * 15, _F,
                            _P],
    },
    "flash_probe": {
        # q, k, v, out, B1, B2, Lq, Lk, D, q, k, v strides (b1, b2, l),
        # stream
        "flash_probe_dots_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 *[_L] * 9, _P],
        "flash_probe_stream_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   *[_L] * 9, _P],
        # bfloat16 q, k, v and out: the same arguments
        "flash_probe_dots_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  *[_L] * 9, _P],
        "flash_probe_stream_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    *[_L] * 9, _P],
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
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together, each one's wall seconds kept in BUILD_SECONDS.
    Returns {name: path of the .so}. Raises with the compiler's output when
    a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [n for n in SOURCES if not _target(n).exists()]
    nvcc = _nvcc() if missing else None
    procs = {}
    start = time.perf_counter()
    for name in missing:
        so = _target(name)
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(so) + ".tmp",
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, so)
    failed = []
    while procs:
        for name, (proc, log, so) in list(procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            BUILD_SECONDS[name] = time.perf_counter() - start
            del procs[name]
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(str(so) + ".tmp", so)
        if procs:
            time.sleep(0.05)
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
