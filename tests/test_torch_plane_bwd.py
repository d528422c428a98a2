"""The plane filtered-activation backward (K5b) on the CPU: its launch plan
(``plane_bwd_plan``), and the kernel's block driven through a plain torch
stand-in of its six k-major products, in the kernel's order, on its
shared-memory layout (``PlaneBwdLayout``) with the same in-place reuse and
operator buffers, against ``jax.vjp`` of JAX's ``filtered_act_pallas(z,
act, "channel")``, which runs ``_bwd_rule``'s Pallas kernel in interpret
mode. The CUDA kernel itself is held against its plain version in
``test_torch_kernels_cuda.py``.

Tolerance: atol 1e-4 / rtol 1e-4, the one ``test_torch_backward.py``
holds K5b's plain version to (six chained f32 products of values up to
~10, summed in another order than XLA).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch.ops import filtered_act as TF
from test_torch_harness import nchw, nhwc, rand
from test_torch_kernels_build import _chip_smoke

torch.set_num_threads(1)


def _layout(H, W):
    """(op, big, small, g): the floats of filtered_act.cu::PlaneBwdLayout,
    an operator buffer's and a plane's preᵀ, tᵀ / uᵀ / s and g buffers."""
    op = 2 * max(H, W) ** 2
    big = 2 * W * TF._row_pad(2 * H)
    small = max(W * TF._row_pad(2 * H), 2 * H * TF._row_pad(W))
    return op, big, small, H * W


def plane_bwd_block_plain(x, g, act, ppb):
    """dx of K5b with ``torch.matmul`` in place of the card: each block of
    ``ppb`` planes gets a shared-memory buffer of NaN, the size the plan
    gives it, and runs the kernel's staging and six products C = Yᵀ·X on
    the kernel's offsets and row strides, so a product that read a buffer
    before it was written, or wrote over an operand still to be read,
    shows in dx. x, g: NCHW."""
    N, C, H, W = x.shape
    n_all, HW = N * C, H * W
    op, big, small, gsz = _layout(H, W)
    floats = 2 * op + ppb * (big + small + gsz)
    assert 4 * floats == TF.plane_bwd_smem_bytes(H, W, ppb)
    uhT, uwT, dh, dw, uw, uh = TF._plane_bwd_ops(H, W, "cpu")
    xs, gs = x.reshape(n_all, H, W), g.reshape(n_all, H, W)
    dx = torch.empty_like(xs)
    OP0, OP1 = 0, op
    BIG = 2 * op
    SMALL = BIG + ppb * big
    G = SMALL + ppb * small
    ld2h, ldw = TF._row_pad(2 * H), TF._row_pad(W)
    for p0 in range(0, n_all, ppb):
        P = min(ppb, n_all - p0)
        smem = torch.full((floats,), float("nan"))

        def mat(off, rows, cols, ld):
            return smem.as_strided((rows, cols), (ld, 1), off)

        def stage(off, t):
            smem[off:off + t.numel()] = t.reshape(-1)

        def product(X, ldx, sX, Y, ldy, sY, C, ldc, sC, R, Cn, K,
                    grad_at=False):
            for p in range(P):
                acc = mat(Y + p * sY, K, R, ldy).T @ mat(X + p * sX, K, Cn,
                                                         ldx)
                out = (dx[p0 + p] if C is None
                       else mat(C + p * sC, R, Cn, ldc))
                out.copy_(TF.act_grad(out, act) * acc if grad_at else acc)

        for p in range(P):
            stage(BIG + p * big, xs[p0 + p])
            stage(G + p * gsz, gs[p0 + p])
        stage(OP0, uhT)
        stage(OP1, uwT)
        # 1. tᵀ = xᵀ · U_hᵀ
        product(OP0, 2 * H, 0, BIG, W, big, SMALL, ld2h, small, W, 2 * H, H)
        stage(OP0, dh)
        # 2. preᵀ = U_w · tᵀ, over x
        product(SMALL, ld2h, small, OP1, 2 * W, 0, BIG, ld2h, big, 2 * W,
                2 * H, W)
        stage(OP1, dw)
        # 3. uᵀ = gᵀ · D_h, over tᵀ
        product(OP0, 2 * H, 0, G, W, gsz, SMALL, ld2h, small, W, 2 * H, H)
        stage(OP0, uw)
        # 4. mᵀ = act′(preᵀ) ⊙ (D_wᵀ · uᵀ), in place over preᵀ
        product(SMALL, ld2h, small, OP1, 2 * W, 0, BIG, ld2h, big, 2 * W,
                2 * H, W, grad_at=True)
        stage(OP1, uh)
        # 5. s = m · U_w, over uᵀ
        product(OP0, W, 0, BIG, ld2h, big, SMALL, ldw, small, 2 * H, W,
                2 * W)
        # 6. dx = U_hᵀ · s, to device memory
        product(SMALL, ldw, small, OP1, H, 0, None, W, HW, H, W, 2 * H)
    return dx.view(N, C, H, W)


def _chip_shapes():
    return _chip_smoke().KERNELS["filtered_act_plane_bwd"]["shapes"]


@pytest.mark.parametrize("case", [
    *[(h, w, n * c) for n, c, h, w in _chip_shapes()],
    *[(h, w, n) for h, w in [(32, 32), (4, 4), (64, 64), (12, 20), (8, 8)]
      for n in (0, 1, 131, 132, 133)]])
def test_plane_bwd_plan(case):
    """K5b's plan: 1 <= P <= planes, the block within the 227 KB of shared
    memory, one of the kernel's two block sizes, six micro-tiles that
    divide their results (8×4 only where the rows are % 8; 4×4 for mᵀ,
    whose epilogue reads C), the grid at least a wave of 132 blocks where
    the planes allow; 0 planes get the one-plane plan."""
    H, W, nplanes = case
    plan = TF.plane_bwd_plan(H, W, nplanes)
    if nplanes == 0:
        assert plan == TF.plane_bwd_plan(H, W, 1)
        nplanes = 1
    P = plan.planes_per_block
    assert 1 <= P <= nplanes
    assert plan.smem_bytes == TF.plane_bwd_smem_bytes(H, W, P) <= \
        TF.SMEM_MAX_BYTES
    assert plan.threads in TF.K5_THREADS
    assert -(-nplanes // P) >= min(TF.NUM_SMS, nplanes)
    assert len(plan.tiles) == 6 and plan.tiles[3] == (4, 4)
    for (rows, cols, depth), (tr, tc) in zip(TF.plane_bwd_products(H, W),
                                             plan.tiles):
        assert (tr, tc) in TF.K5_TILES
        assert rows % tr == 0 and cols % tc == 0 and depth % 4 == 0
    codes = plan.tile_codes
    assert codes < 64
    assert [TF.K5_TILES[(codes >> i) & 1] for i in range(6)] == \
        list(plan.tiles)


@pytest.mark.parametrize("hw", [(8, 8), (12, 20), (64, 64)])
def test_plane_bwd_products_cover_the_vjp(hw):
    """The six products chain (each depth the rows of the operand it
    reads), their work is 12H²W + 24HW² FLOP a plane (36·S³ square), and
    the block's shared memory is two operator buffers of the largest
    operator and 7·H·W floats a plane plus row padding."""
    H, W = hw
    prods = TF.plane_bwd_products(H, W)
    (r1, c1, _), (r2, c2, k2), (r3, c3, _), (r4, c4, k4), (r5, c5, k5), \
        (r6, c6, k6) = prods
    assert k2 == r1 and (r2, c2) == (2 * W, c1)
    assert (r3, c3) == (r1, c1) and k4 == r3 and (r4, c4) == (r2, c2)
    assert k5 == r4 and r5 == c4 and k6 == r5 and (r6, c6) == (H, W)
    flops = sum(2 * r * c * k for r, c, k in prods)
    assert flops == 12 * H * H * W + 24 * H * W * W
    op, big, small, gsz = _layout(H, W)
    assert TF.plane_bwd_smem_bytes(H, W, 3) == 4 * (2 * op + 3 * (
        big + small + gsz))
    assert big + small + gsz >= 7 * H * W


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (1, 4, 12, 20),
                                   (1, 2, 64, 64)])
@pytest.mark.parametrize("act", ["silu", "relu"])
def test_plane_bwd_block_matches_pallas_vjp(rng, shape, act):
    """The stand-in of K5b's block, at the plan's P and at P = 3 (a last
    block of fewer planes where 3 does not divide them), against the VJP
    of the channel Pallas kernel; relu at x = 0, where the JAX kernels take
    relu′(0) = 1."""
    N, C, H, W = shape
    x = (np.zeros((N, H, W, C), np.float32) if act == "relu"
         else rand(rng, (N, H, W, C)))
    g = rand(rng, (N, H, W, C))

    @jax.jit
    def vjp(x, g):
        _, pull = jax.vjp(lambda z: filtered_act_pallas(z, act, "channel"),
                          x)
        return pull(g)[0]

    want = np.asarray(vjp(jnp.asarray(x), jnp.asarray(g)))
    assert np.abs(want).max() > 0.1
    plan = TF.plane_bwd_plan(H, W, N * C)
    for ppb in sorted({plan.planes_per_block, 3}):
        got = plane_bwd_block_plain(nchw(x), nchw(g), act, ppb)
        np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"P {ppb}")


def test_phase_check_counts_kernel_shapes(monkeypatch):
    """``phase_check.py --shapes`` (how the VAE phase's K5b shapes in
    chip_smoke were confirmed) counts each filtered-activation kernel's
    calls by input shape: K5 and K5b up to 64 px, K1 and K2 above."""
    from afldm_tpu_torch.scripts import phase_check
    for name in phase_check.FILTERED_ACT_ENTRIES:  # restored after the test
        monkeypatch.setattr(TF, name, getattr(TF, name))
    seen = {}
    phase_check.count_shapes(TF, seen)
    for shape in [(1, 2, 8, 8), (1, 2, 8, 8), (1, 1, 80, 80)]:
        x = torch.randn(shape, requires_grad=True)
        TF.filtered_act_fused(x, "silu").sum().backward()
    assert seen == {("_plane_forward", (1, 2, 8, 8)): 2,
                    ("filtered_act_plane_bwd", (1, 2, 8, 8)): 2,
                    ("_banded_forward", (1, 1, 80, 80)): 1,
                    ("filtered_act_banded_bwd", (1, 1, 80, 80)): 1}
