"""The flash attribution probes P1 and P2 (``ops/flash_probes.py``) against
the JAX package's probe bodies, ``dots_only_kernel`` and
``stream_only_kernel`` of ``scripts/bench_flash_sweep.py``.

The bodies are closures inside the script's ``main()``, so they are
captured without touching the script: ``main()`` runs at a tiny size with
``pl.pallas_call`` replaced by a recorder that keeps those two kernels and
returns zeros for every other call; each captured body then runs through
the real ``pl.pallas_call`` in interpret mode, with the script's
BlockSpecs at 64-row tiles (the port's tile).

Tolerance: each probe within 2e-6 of max |want| (f32 sums in another
order; P1's values grow as sqrt(L·D), nothing normalises them). At bf16
the bodies run on bf16 inputs: P1 within 2⁻⁷·max |want| and P2 within
2⁻⁸·max |want|; each differs from JAX only by the f32 summation order
before one bf16 rounding, which P1 has twice (the scores and the output).
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from afldm_tpu_torch.ops import flash_probes as P

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
L, D, BT = 128, 8, 64


def _load_sweep_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_flash_sweep", REPO / "scripts" / "bench_flash_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe_bodies(tmp_path_factory):
    """{kernel name: body} captured from the script's ``main()``."""
    captured = {}
    real = pl.pallas_call

    def recorder(kernel, out_shape, *args, **kwargs):
        name = getattr(kernel, "__name__", None)  # sdpa's are partials
        if name in ("dots_only_kernel", "stream_only_kernel"):
            captured[name] = kernel
        return lambda *a: jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    out = tmp_path_factory.mktemp("sweep") / "rows.jsonl"
    argv = ["bench_flash_sweep.py", "--tokens", str(L), "--dim", str(D),
            "--heads", "1", "--batch", "1", "--frames", "2", "--iters", "1",
            "--dtype", "f32", "--out", str(out)]
    cache_dir = jax.config.jax_compilation_cache_dir
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pl, "pallas_call", recorder)
        mp.setattr("sys.argv", argv)
        _load_sweep_script().main()
    finally:
        mp.undo()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert pl.pallas_call is real
    assert set(captured) == {"dots_only_kernel", "stream_only_kernel"}
    return captured


def _run_body(kernel, q, k, v):
    """The captured body over (B3, L, D) arrays in interpret mode, with the
    script's grid, BlockSpecs and scratch at 64-row Q and K tiles."""
    B3, L, D = q.shape
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B3, L, D), q.dtype),
        grid=(B3, L // BT, L // BT),
        interpret=True,
        in_specs=[
            pl.BlockSpec((1, BT, D), lambda b, i, kk: (b, i, 0)),
            pl.BlockSpec((1, BT, D), lambda b, i, kk: (b, kk, 0)),
            pl.BlockSpec((1, BT, D), lambda b, i, kk: (b, kk, 0)),
        ],
        out_specs=pl.BlockSpec((1, BT, D), lambda b, i, kk: (b, i, 0)),
        scratch_shapes=[pltpu.VMEM((BT, D), jnp.float32)],
    )(q, k, v)


@pytest.mark.parametrize("name,port", [
    ("dots_only_kernel", P.flash_probe_dots),
    ("stream_only_kernel", P.flash_probe_stream)])
def test_plain_versions_match_jax_probe_bodies(probe_bodies, name, port):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, L, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(_run_body(probe_bodies[name], *map(jnp.asarray,
                                                         (q, k, v))))
    got = port(*map(torch.from_numpy, (q, k, v))).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2e-6 * scale


@pytest.mark.parametrize("d", [8, 20])
@pytest.mark.parametrize("name,port,rel", [
    ("dots_only_kernel", P.flash_probe_dots, 2.0 ** -7),
    ("stream_only_kernel", P.flash_probe_stream, 2.0 ** -8)])
def test_bf16_plain_versions_match_jax_probe_bodies(probe_bodies, name, port,
                                                     rel, d):
    """The bodies on bf16 inputs, (L, D) = (128, 8) and a D that is not a
    multiple of 8, against the port's plain bf16 versions."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, L, d)).astype(np.float32)
               for _ in range(3))
    want = _run_body(probe_bodies[name],
                     *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = port(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= rel * scale


def test_dots_plain_rounds_scores_at_bf16():
    """P1's plain version at bf16 rounds q·kᵀ to bf16 before the second
    product: it equals the f32 product of the rounded scores, rounded."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 8))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)).to(torch.bfloat16)
    want = (s.float() @ v.float()).to(torch.bfloat16)
    assert torch.equal(P.flash_probe_dots_plain(q, k, v), want)
    unrounded = (q.float() @ k.float().transpose(-1, -2) @ v.float())
    assert not torch.equal(want, unrounded.to(torch.bfloat16))


def test_stream_plain_counts_tiles():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 4))
                                .astype(np.float32)) for _ in range(3))
    four, two = (P.flash_probe_stream_plain(q, k, v, bk) for bk in (64, 128))
    torch.testing.assert_close(four - two, 2 * q, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fn,plain", [
    (P.flash_probe_dots, P.flash_probe_dots_plain),
    (P.flash_probe_stream, P.flash_probe_stream_plain)])
def test_wrappers_route_cpu_to_plain(fn, plain):
    from afldm_tpu_torch import kernels
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 64, 24))
                                .astype(np.float32)) for _ in range(3))
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(fn(q, k, v), plain(q, k, v), atol=0, rtol=0)
    assert kernels.LAUNCHES == before  # no launch on the CPU


@pytest.mark.parametrize("fn", [P.flash_probe_dots, P.flash_probe_stream])
@pytest.mark.parametrize("lq,lk,d,dtype,err", [
    (63, 64, 8, torch.float32, ValueError),
    (64, 100, 8, torch.float32, ValueError),
    (64, 64, 257, torch.float32, ValueError),
    (64, 64, 8, torch.float64, TypeError),
    (64, 64, 8, torch.float16, TypeError)])
def test_wrappers_reject_unsupported(fn, lq, lk, d, dtype, err):
    q = torch.zeros(1, 1, lq, d, dtype=dtype)
    k = torch.zeros(1, 1, lk, d, dtype=dtype)
    with pytest.raises(err):
        fn(q, k, k)


@pytest.mark.parametrize("fn", [P.flash_probe_dots, P.flash_probe_stream])
@pytest.mark.parametrize("dq,dkv", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
def test_wrappers_reject_mixed_dtypes(fn, dq, dkv):
    q = torch.zeros(1, 1, 64, 8, dtype=dq)
    k = torch.zeros(1, 1, 64, 8, dtype=dkv)
    with pytest.raises(TypeError, match="one dtype"):
        fn(q, k, k)


@pytest.mark.parametrize("fn,plain", [
    (P.flash_probe_dots, P.flash_probe_dots_plain),
    (P.flash_probe_stream, P.flash_probe_stream_plain)])
def test_wrappers_route_cpu_bf16_to_plain(fn, plain):
    from afldm_tpu_torch import kernels
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 64, 24))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    before = dict(kernels.LAUNCHES)
    got = fn(q, k, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, plain(q, k, v), atol=0, rtol=0)
    assert kernels.LAUNCHES == before  # no launch on the CPU
