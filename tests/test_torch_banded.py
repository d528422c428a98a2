"""The banded filtered-activation forward (K1) on the CPU: its chunk plan,
and the chain's bookkeeping (the chunk loop, the operator layouts and the
scratch offsets the card uses) driven through a plain torch stand-in of the
C entry's four GEMMs, against JAX's ``filtered_act_pallas(z, act,
"spatial")``, which runs ``_forward_spatial`` in interpret mode; the same
for K1's reduced precision levels, whose two C entries
(``filtered_banded_mma.cu``: the up and down strip walks, hi's bf16 pieces
in the scratch) have a stand-in of their own; and the filtered activation
at 0 planes against JAX. The CUDA kernels themselves are held against
their plain versions in ``test_torch_kernels_cuda.py``.

Tolerance: atol 3e-5 / rtol 1e-4, the one the JAX package holds its own
kernels to (f32 sums in another order). At a level: the stand-in against
the port's plain version at that level to 1e-6 (both sum each product
exactly and round once, only the strips differ), and against JAX at
'high' as ``test_torch_precision.py`` holds the plain version (RMS within
0.25 of the level's own error, max within its max). XLA's CPU dot ignores
'default' outside Pallas and inside it in interpret mode alike, so there
the reference is that file's numpy emulation of JAX's chain
(``np_forward``).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops.ideal_lpf import filtered_nonlinearity
from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import filtered_act as TF
from afldm_tpu_torch.ops.ideal_lpf import _ACTS, _pieces, level_matmul
from test_torch_harness import nchw, nhwc, rand
from test_torch_precision import assert_level_close, np_forward

torch.set_num_threads(1)

def _banded_entry_plain(x, out, scratch, ops, chunk, act):
    """``TF._banded_entry``'s four products with ``torch.matmul``, on the
    same scratch offsets and operator layouts as the C entry (U_h and D_h
    read from their k-major forms): the chain's bookkeeping without the
    card."""
    uwT, uhT, dwT, dhT = ops
    P, (H, W) = chunk.planes, x.shape[-2:]
    t = scratch[:2 * H * W * P]           # t, then lo
    hi = scratch[2 * H * W * P:6 * H * W * P]
    t.view(P * H, 2 * W).copy_(x.reshape(P * H, W) @ uwT)
    hi.view(P, 2 * H, 2 * W).copy_(
        _ACTS[act](uhT.T @ t.view(P, H, 2 * W)))
    t.view(P * 2 * H, W).copy_(hi.view(P * 2 * H, 2 * W) @ dwT)
    out.copy_(dhT.T @ t.view(P, 2 * H, W))


def _banded_mma_entry_plain(x, out, scratch, ops, chunk, act, level):
    """``TF._banded_mma_entry``'s two launches in torch: the up launch's
    64-row strips of the 2H side (t = U_h·x, hi = act(t·U_wᵀ)) and the
    down launch's strips of the H side (lo = D_h·hi, out = lo·D_wᵀ), the
    operators' pieces read from their split blobs and hi's pieces written
    to and read back from the bf16 scratch in the C entries' layout (every
    plane's hi piece, then at 'high' every plane's lo piece, 4·H·W
    elements each); each product at the level with its sum exactly
    rounded, as the plain version."""
    uhT, uwT, dhT, dwT = ops
    P, (H, W) = chunk.planes, x.shape[-2:]
    up_rows, down_rows = chunk.tiles
    n = 2 if level == "high" else 1
    hs = scratch[:n * 4 * H * W * P].view(n, P, 2 * H, 2 * W)

    def blob(b, rows, cols):  # a blob's pieces without their padding
        return tuple(b[i, :rows, :cols].float() for i in range(n))

    def mm(a, b):  # a, b: pieces
        return level_matmul(a[0], b[0], level, a, b, exact_sums=True)

    uh, uw = blob(uhT, H, 2 * H), blob(uwT, W, 2 * W)
    dh, dw = blob(dhT, 2 * H, H), blob(dwT, 2 * W, W)
    for p in range(P):
        xp = _pieces(x[p].float(), level)
        for m0 in range(0, 2 * H, up_rows):
            rows = slice(m0, m0 + up_rows)
            t = mm(tuple(u[:, rows].T for u in uh), xp)
            hi = _ACTS[act](mm(_pieces(t, level), uw))
            for i, piece in enumerate(_pieces(hi, level)):
                hs[i, p, rows] = piece.to(torch.bfloat16)
        his = tuple(hs[i, p].float() for i in range(n))
        for m0 in range(0, H, down_rows):
            rows = slice(m0, m0 + down_rows)
            lo = mm(tuple(d[:, rows].T for d in dh), his)
            out[p, rows] = mm(_pieces(lo, level), dw).to(out.dtype)


PLAN_SIDES = [(68, 92), (80, 80), (32, 128), (128, 128), (256, 256),
              (1024, 1024), (4, 4848)]
CAPS = [32 * 2 ** 20, 256 * 2 ** 20, 1]
PLAN_PLANES = [1, 5, 16, 4096, 8192]


def check_plan(H, W, nplanes, cap, products):
    """``banded_plan``'s rules for the chain of ``products``."""
    plan = TF.banded_plan(H, W, nplanes, cap, products)
    one = TF.banded_scratch_bytes(H, W, 1)
    assert [c.start for c in plan] == \
        list(np.cumsum([0] + [c.planes for c in plan])[:-1])
    assert sum(c.planes for c in plan) == nplanes
    assert all(c.planes >= 1 for c in plan)
    for c in plan:
        assert TF.banded_scratch_bytes(H, W, c.planes) <= cap or c.planes == 1
    per = max(1, cap // one)
    assert len(plan) == -(-nplanes // per)
    assert max(c.planes for c in plan) - min(c.planes for c in plan) <= 1
    for c in plan:
        n = len(products(H, W, c.planes))
        assert len(c.tiles) == n
        for (M, N, _, b), tile in zip(products(H, W, c.planes), c.tiles):
            big = TF.gemm_blocks(M, N, b, 128) >= TF.NUM_SMS
            assert tile == (128 if big else 64)
        assert [TF.GEMM_TILES[(c.tile_codes >> i) & 1] for i in range(n)] \
            == list(c.tiles)
        assert c.tile_codes >> n == 0


@pytest.mark.parametrize("hw", PLAN_SIDES)
@pytest.mark.parametrize("nplanes", PLAN_PLANES)
@pytest.mark.parametrize("cap", CAPS)
def test_banded_plan(hw, nplanes, cap):
    """Chunks cover every plane exactly once, in order, at least one plane
    each; a chunk's scratch stays under the cap unless one plane alone
    exceeds it; as few chunks as the cap allows, within one plane of each
    other; each product's tile is 128 unless that grid is short of a wave."""
    check_plan(*hw, nplanes, cap, TF.banded_products)


def test_plans_at_zero_planes():
    """0 planes: no chunks for K1 or K2; K5's plan is its one-plane plan
    (its wrapper launches nothing either)."""
    assert TF.banded_plan(128, 128, 0, TF.BANDED_SCRATCH_BYTES) == ()
    assert TF.banded_plan(128, 128, 0, TF.BANDED_SCRATCH_BYTES,
                          TF.banded_bwd_products) == ()
    for hw in [(4, 4), (32, 32), (64, 64), (12, 20)]:
        assert TF.plane_plan(*hw, 0) == TF.plane_plan(*hw, 1)


def test_banded_products_cover_the_chain():
    """The four GEMMs' shapes chain: t (P·H × 2W) feeds hi per plane, hi
    (P·2H × 2W) feeds lo, lo (P·2H × W) feeds out per plane; their work is
    the kernel's 24·S³ FLOP a square plane."""
    H, W, P = 68, 92, 3
    (m1, n1, k1, b1), (m2, n2, k2, b2), (m3, n3, k3, b3), (m4, n4, k4, b4) = \
        TF.banded_products(H, W, P)
    assert (m1, k1, b1) == (P * H, W, 1) and (k2, n2, b2) == (H, n1, P)
    assert (m3, k3) == (P * m2, n2) and (k4, n4, b4) == (m2, n3, P)
    assert m4 * b4 == P * H and n4 == W
    flops = sum(2 * m * n * k * b for m, n, k, b in
                TF.banded_products(96, 96, P))
    assert flops == 24 * 96 ** 3 * P
    assert TF.banded_scratch_bytes(H, W, P) == \
        4 * (m1 * n1 + b2 * m2 * n2)


@pytest.mark.parametrize("hw", [(80, 80), (68, 92), (32, 128), (128, 128)])
@pytest.mark.parametrize("act", ["silu", "gelu", "leaky_relu"])
def test_banded_chain_matches_pallas_spatial(rng, monkeypatch, hw, act):
    """Five planes in chunks of two (a cap of two planes' scratch), through
    the chain's loop with a plain stand-in of the C entry, against the
    spatial Pallas kernel; nothing launches."""
    H, W = hw
    monkeypatch.setattr(TF, "BANDED_SCRATCH_BYTES",
                        TF.banded_scratch_bytes(H, W, 2))
    plan = TF.banded_plan(H, W, 5, TF.BANDED_SCRATCH_BYTES)
    assert [c.planes for c in plan] == [2, 2, 1]
    x = rand(rng, (1, H, W, 5))
    want = jax.jit(lambda z: filtered_act_pallas(z, act, "spatial"))(
        jnp.asarray(x))
    before = dict(kernels.LAUNCHES)
    got = TF._banded_chain(nchw(x).contiguous(), act, _banded_entry_plain)
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


def test_banded_chain_scratch_offsets():
    """The stand-in writes only the chunk's 6·H·W·P floats of scratch: t and
    lo in the first 2·H·W·P, hi in the next 4·H·W·P; the rest stays."""
    H, W, P = 8, 12, 2
    x = torch.randn(P, H, W)
    scratch = torch.full((TF.banded_scratch_bytes(H, W, P + 1) // 4,),
                         float("nan"))
    out = torch.empty_like(x)
    chunk = TF.BandedChunk(0, P, (64,) * 4)
    ops = TF._banded_ops(H, W, "cpu")
    _banded_entry_plain(x, out, scratch, ops, chunk, "silu")
    n = 6 * H * W * P
    assert torch.isfinite(scratch[:n]).all()
    assert torch.isnan(scratch[n:]).all()
    uwT, uhT, dwT, dhT = ops
    hi = torch.nn.functional.silu(uhT.T @ (x @ uwT))
    torch.testing.assert_close(scratch[2 * H * W * P:n].view(P, 2 * H, 2 * W),
                               hi)
    torch.testing.assert_close(scratch[:2 * H * W * P].view(P, 2 * H, W),
                               hi @ dwT)
    torch.testing.assert_close(out, TF.filtered_act_plain(x[None], "silu")[0],
                               atol=3e-5, rtol=1e-4)


LEVEL_SIDES = [(68, 92), (80, 80), (32, 128), (128, 32), (128, 128),
               (200, 104), (256, 256), (512, 512), (400, 96), (4, 128)]


@pytest.mark.parametrize("hw", LEVEL_SIDES)
@pytest.mark.parametrize("level", ["high", "default"])
@pytest.mark.parametrize("nplanes", [1, 5, 12288])
@pytest.mark.parametrize("cap", [1, 2 ** 20, 256 * 2 ** 20])
def test_banded_mma_plan(hw, level, nplanes, cap):
    """K1's level chain: its chunks cover every plane once, in order, as
    few as keep each chunk's hi pieces (8·H·W bytes a plane and piece:
    hi and lo at 'high', hi at 'default') under the cap, within one plane
    of each other; the up launch takes 64-row strips, the down launch 64
    unless that block's shared memory (its lo strip 2W wide, and the
    ring) passes the card's 227 KB, then 32 (which always fits up to
    LEVEL_MAX); no chunks for 0 planes."""
    H, W = hw
    one = TF.banded_mma_scratch_bytes(H, W, 1, level)
    assert one == 8 * H * W * (2 if level == "high" else 1)
    assert one < TF.banded_scratch_bytes(H, W, 1)
    plan = TF.banded_mma_plan(H, W, nplanes, level, cap)
    assert [c.start for c in plan] == \
        list(np.cumsum([0] + [c.planes for c in plan])[:-1])
    assert sum(c.planes for c in plan) == nplanes
    assert len(plan) == -(-nplanes // max(1, cap // one))
    assert max(c.planes for c in plan) - min(c.planes for c in plan) <= 1
    for c in plan:
        assert c.planes * one <= cap or c.planes == 1
        up, down = c.tiles
        assert up == TF.K1_UP_ROWS == 64
        assert TF.banded_mma_smem_bytes(W, level, up, False) <= \
            TF.SMEM_MAX_BYTES
        assert TF.banded_mma_smem_bytes(W, level, down, True) <= \
            TF.SMEM_MAX_BYTES
        big = TF.banded_mma_smem_bytes(W, level, 64, True)
        assert down == (64 if big <= TF.SMEM_MAX_BYTES else 32)
    assert TF.banded_mma_plan(H, W, 0, level, cap) == ()


def test_banded_mma_strips_at_the_widest_plane():
    """At 512 px the down launch's lo strip (2W = 1024 wide) takes 32 rows
    at 'high' and 64 at 'default'; every smaller side takes 64."""
    assert TF.banded_mma_down_rows(512, "high") == 32
    assert TF.banded_mma_down_rows(512, "default") == 64
    for w in (68, 96, 128, 200, 256):
        assert TF.banded_mma_down_rows(w, "high") == 64


@pytest.mark.parametrize("hw", [(80, 80), (68, 92), (32, 128), (128, 32)])
@pytest.mark.parametrize("level", ["high", "default"])
def test_banded_level_chain_matches_pallas_spatial(rng, monkeypatch, hw,
                                                   level):
    """Five planes in chunks of two (a cap of two planes' hi pieces),
    through the chain's loop with a plain stand-in of K1's two level C
    entries, against the port's plain version at the level, and against
    the spatial Pallas kernel at 'high' in interpret mode (at 'default'
    the numpy emulation of its chain); nothing launches."""
    from afldm_tpu.ops import set_af_precision as jax_set_af_precision
    H, W = hw
    monkeypatch.setattr(TF, "BANDED_HI_BYTES",
                        TF.banded_mma_scratch_bytes(H, W, 2, level))
    plan = TF.banded_mma_plan(H, W, 5, level, TF.BANDED_HI_BYTES)
    assert [c.planes for c in plan] == [2, 2, 1]
    x = rand(rng, (1, H, W, 5))
    before = dict(kernels.LAUNCHES)
    got = nhwc(TF._banded_chain(
        nchw(x).contiguous(), "silu",
        functools.partial(_banded_mma_entry_plain, level=level),
        level=level))
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(
        got, nhwc(TF.filtered_act_banded_plain(nchw(x), "silu", level)),
        atol=1e-6, rtol=1e-6)
    run = jax.jit(lambda z: filtered_act_pallas(z, "silu", "spatial"))
    exact = np.asarray(run(jnp.asarray(x)))
    if level == "high":
        jax_set_af_precision("high")
        try:
            want = np.asarray(jax.jit(
                lambda z: filtered_act_pallas(z, "silu", "spatial"))(
                    jnp.asarray(x)))
        finally:
            jax_set_af_precision("highest")
    else:
        want = np.transpose(np_forward(np.transpose(x, (0, 3, 1, 2)),
                                       "default", "k1"), (0, 2, 3, 1))
    assert_level_close(got, want, exact,
                       max_err=float(np.abs(want - exact).max()))


@pytest.mark.parametrize("level", ["high", "default"])
def test_banded_level_scratch_holds_hi_pieces(level):
    """The level stand-in writes only the chunk's hi pieces into the bf16
    scratch (4·H·W elements a plane and piece; the rest stays), each the
    split of act(t·U_wᵀ); t and lo take no scratch."""
    H, W, P = 8, 12, 2
    n = 2 if level == "high" else 1
    x = torch.randn(P, H, W)
    size = TF.banded_mma_scratch_bytes(H, W, P + 1, level) // 2
    scratch = torch.full((size,), float("nan"), dtype=torch.bfloat16)
    out = torch.empty_like(x)
    chunk = TF.BandedChunk(0, P, (64, 64))
    _banded_mma_entry_plain(x, out, scratch, TF._banded_mma_ops(H, W, "cpu"),
                            chunk, "silu", level)
    used = n * 4 * H * W * P
    assert torch.isfinite(scratch[:used].float()).all()
    assert torch.isnan(scratch[used:].float()).all()
    uh, uw = TF._upsample_op(H, 2), TF._upsample_op(W, 2)
    t = level_matmul(torch.from_numpy(uh), x, level, exact_sums=True)
    hi = torch.nn.functional.silu(level_matmul(t, torch.from_numpy(uw.T),
                                               level, exact_sums=True))
    pieces = scratch[:used].view(n, P, 2 * H, 2 * W)
    for i, piece in enumerate(_pieces(hi, level)):
        assert torch.equal(pieces[i], piece.to(torch.bfloat16))
    torch.testing.assert_close(
        out, TF.filtered_act_banded_plain(x[None], "silu", level)[0],
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(0, 8, 8, 3), (0, 64, 64, 2),
                                   (0, 96, 96, 2), (0, 32, 128, 1),
                                   (2, 96, 96, 0)])
def test_fused_at_zero_planes_matches_jax(shape):
    """(0, C, H, W) and (N, 0, H, W) through the CPU dispatcher, plane and
    banded sizes, against JAX's filtered_nonlinearity: empty results of
    the input's shape, and their gradients too."""
    x = np.zeros(shape, np.float32)
    want = np.asarray(filtered_nonlinearity(jnp.asarray(x), "silu"))
    xt = nchw(x).requires_grad_()
    got = TF.filtered_act_fused(xt, "silu")
    assert nhwc(got).shape == want.shape == shape
    got.sum().backward()
    assert xt.grad.shape == xt.shape


@pytest.mark.parametrize("a_shape,b_shape,a_kmajor", [
    ((1, 8, 12), (3, 12, 16), False),   # a's batch is not b's
    ((3, 12, 8), (3, 16, 16), True),    # a's K (k-major) is not b's
    ((3, 8, 16), (3, 12, 16), False),   # a's K is not b's
    ((2, 6, 12), (2, 12, 16), False),   # M not a multiple of 4
    ((2, 8, 12), (2, 12, 18), False),   # N not a multiple of 4
    ((2, 8, 10), (2, 10, 16), False),   # K not a multiple of 4
    ((2, 8, 0), (2, 0, 16), False),     # K of 0
    ((8, 12), (12, 16), False),         # not batched
])
def test_gemm_refuses_mismatched_operands(a_shape, b_shape, a_kmajor):
    """``filtered_gemm`` checks its operands on every device before the
    kernel would read past them: one batch, one K, multiples of 4."""
    a, b = torch.randn(a_shape), torch.randn(b_shape)
    with pytest.raises(ValueError, match="filtered_gemm"):
        TF.filtered_gemm(a, b, a_kmajor=a_kmajor)


@pytest.mark.parametrize("a_kmajor", [False, True])
def test_gemm_takes_a_shared_operator(a_kmajor):
    """A stride-0 A expanded to b's batch is one operator for every
    matrix, as the chain's batched products pass U_h and D_h."""
    g = torch.Generator().manual_seed(0)
    a1 = torch.randn((1, 12, 8) if a_kmajor else (1, 8, 12), generator=g)
    b = torch.randn(3, 12, 16, generator=g)
    got = TF.filtered_gemm(a1.expand(3, -1, -1), b, "silu", a_kmajor)
    A = a1[0].T if a_kmajor else a1[0]
    torch.testing.assert_close(got, torch.nn.functional.silu(A @ b))
