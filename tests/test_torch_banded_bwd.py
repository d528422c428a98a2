"""The banded filtered-activation backward (K2) on the CPU: its chunk plan
(``banded_plan`` over ``banded_bwd_products``), and the chain's
bookkeeping (the chunk loop, the operator layouts and the scratch offsets
the card uses) driven through a plain torch stand-in of the C entry's six
GEMMs, against ``jax.vjp`` of JAX's ``filtered_act_pallas(z, act,
"spatial")``, which runs ``_bwd_spatial`` in interpret mode; and the
tiled GEMM's epilogue that reads C, on its plain path. The CUDA kernels
themselves are held against their plain versions in
``test_torch_kernels_cuda.py``.

Tolerance: atol 1e-4 / rtol 1e-4, the one ``test_torch_backward.py``
holds K2's plain version to (six chained f32 products of values up to
~10, summed in another order than XLA).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import filtered_act as TF
from test_torch_banded import CAPS, PLAN_PLANES, PLAN_SIDES, check_plan
from test_torch_harness import nchw, nhwc, rand

torch.set_num_threads(1)


def _banded_bwd_entry_plain(x, g, dx, scratch, ops, chunk, act):
    """``TF._banded_bwd_entry``'s six products with ``torch.matmul``, on
    the same scratch offsets and operator layouts as the C entry (U_h,
    D_hᵀ and U_hᵀ read from their k-major forms U_hᵀ, D_h and U_h): the
    chain's bookkeeping without the card."""
    uwT, uhT, dw, dh, uw, uh = ops
    P, (H, W) = chunk.planes, x.shape[-2:]
    t = scratch[:2 * H * W * P]           # t, then v, then s
    pre = scratch[2 * H * W * P:6 * H * W * P].view(P, 2 * H, 2 * W)
    t.view(P * H, 2 * W).copy_(x.reshape(P * H, W) @ uwT)
    pre.copy_(uhT.T @ t.view(P, H, 2 * W))
    t.view(P * H, 2 * W).copy_(g.reshape(P * H, W) @ dw)
    pre.copy_(TF.act_grad(pre, act) * (dh.T @ t.view(P, H, 2 * W)))
    t.view(P * 2 * H, W).copy_(pre.reshape(P * 2 * H, 2 * W) @ uw)
    dx.copy_(uh.T @ t.view(P, 2 * H, W))


@pytest.mark.parametrize("hw", PLAN_SIDES)
@pytest.mark.parametrize("nplanes", PLAN_PLANES)
@pytest.mark.parametrize("cap", CAPS)
def test_banded_bwd_plan(hw, nplanes, cap):
    """The backward's chunks follow the forward's rules on the same scratch
    a plane, with six tiles a chunk, each 128 unless its grid is short of a
    wave."""
    check_plan(*hw, nplanes, cap, TF.banded_bwd_products)


@pytest.mark.parametrize("hw", [(68, 92), (96, 96), (32, 128)])
def test_banded_bwd_products_cover_the_chain(hw):
    """The six GEMMs' shapes chain: t (P·H × 2W) feeds pre per plane; v
    (P·H × 2W) feeds m per plane, on pre's shape; m (P·2H × 2W) feeds s,
    s (P·2H × W) feeds dx per plane. Their work is 16HW² + 20H²W FLOP a
    plane (36·S³ square), and the largest buffers are the scratch's two
    regions."""
    H, W = hw
    P = 3
    (m1, n1, k1, b1), (m2, n2, k2, b2), (m3, n3, k3, b3), \
        (m4, n4, k4, b4), (m5, n5, k5, b5), (m6, n6, k6, b6) = \
        TF.banded_bwd_products(H, W, P)
    assert (m1, k1, b1) == (P * H, W, 1) and (k2, n2, b2) == (H, n1, P)
    assert (m3, n3, k3, b3) == (m1, n1, k1, b1)
    assert (m4, n4, k4, b4) == (m2, n2, k2, b2) and k4 * b4 == m3
    assert (m5, k5, b5) == (P * m4, n4, 1)
    assert (k6, n6, b6) == (m5 // P, n5, P) and (m6 * b6, n6) == (P * H, W)
    flops = sum(2 * m * n * k * b for m, n, k, b in
                TF.banded_bwd_products(H, W, P))
    assert flops == P * (16 * H * W * W + 20 * H * H * W)
    if H == W:
        assert flops == 36 * H ** 3 * P
    assert TF.banded_scratch_bytes(H, W, P) == \
        4 * (max(m1 * n1, m5 * n5) + b2 * m2 * n2)


def test_banded_bwd_chain_scratch_offsets():
    """The stand-in writes only the chunk's 6·H·W·P floats of scratch: t, v
    and s in the first 2·H·W·P, pre and then m in the next 4·H·W·P; the
    rest stays."""
    H, W, P = 8, 12, 2
    x, g = torch.randn(P, H, W), torch.randn(P, H, W)
    scratch = torch.full((TF.banded_scratch_bytes(H, W, P + 1) // 4,),
                         float("nan"))
    dx = torch.empty_like(x)
    chunk = TF.BandedChunk(0, P, (64,) * 6)
    ops = TF._banded_bwd_ops(H, W, "cpu")
    _banded_bwd_entry_plain(x, g, dx, scratch, ops, chunk, "gelu")
    n = 6 * H * W * P
    assert torch.isfinite(scratch[:n]).all()
    assert torch.isnan(scratch[n:]).all()
    uwT, uhT, dw, dh, uw, uh = ops
    pre = uhT.T @ (x @ uwT)
    m = TF.act_grad(pre, "gelu") * (dh.T @ (g @ dw))
    torch.testing.assert_close(scratch[2 * H * W * P:n].view(P, 2 * H, 2 * W),
                               m)
    torch.testing.assert_close(scratch[:2 * H * W * P].view(P, 2 * H, W),
                               m @ uw)
    torch.testing.assert_close(
        dx, TF.filtered_act_plane_bwd_plain(x[None], g[None], "gelu")[0],
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(80, 80), (68, 92), (32, 128), (128, 128)])
@pytest.mark.parametrize("act", ["silu", "gelu", "leaky_relu"])
def test_banded_bwd_chain_matches_pallas_spatial(rng, monkeypatch, hw, act):
    """Five planes in chunks of two (a cap of two planes' scratch), through
    the chain's loop with a plain stand-in of the C entry, against the VJP
    of the spatial Pallas kernel; nothing launches."""
    H, W = hw
    monkeypatch.setattr(TF, "BANDED_SCRATCH_BYTES",
                        TF.banded_scratch_bytes(H, W, 2))
    plan = TF.banded_plan(H, W, 5, TF.BANDED_SCRATCH_BYTES,
                          TF.banded_bwd_products)
    assert [c.planes for c in plan] == [2, 2, 1]
    x, g = rand(rng, (1, H, W, 5)), rand(rng, (1, H, W, 5))

    @jax.jit
    def vjp(x, g):
        _, pull = jax.vjp(lambda z: filtered_act_pallas(z, act, "spatial"),
                          x)
        return pull(g)[0]

    want = vjp(jnp.asarray(x), jnp.asarray(g))
    before = dict(kernels.LAUNCHES)
    got = TF._banded_chain(nchw(x).contiguous(), act, _banded_bwd_entry_plain,
                           nchw(g).contiguous())
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh", "linear"])
@pytest.mark.parametrize("a_kmajor", [False, True])
def test_gemm_grad_at_plain(act, a_kmajor):
    """``filtered_gemm(..., grad_at=c)`` is act′(c) ⊙ (A · B), c left as it
    is: on the CPU its plain version, the function the card's epilogue
    that reads C computes."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((2, 12, 8) if a_kmajor else (2, 8, 12), generator=gen)
    b = torch.randn(2, 12, 16, generator=gen)
    c = torch.randn(2, 8, 16, generator=gen)
    c0 = c.clone()
    got = TF.filtered_gemm(a, b, act, a_kmajor, grad_at=c)
    A = a.transpose(-1, -2) if a_kmajor else a
    torch.testing.assert_close(got, TF.act_grad(c0, act) * (A @ b))
    assert torch.equal(c, c0)


@pytest.mark.parametrize("act,shape", [(None, (2, 8, 16)),
                                       ("silu", (2, 8, 12)),
                                       ("silu", (1, 8, 16))])
def test_gemm_grad_at_refuses_a_mismatch(act, shape):
    """grad_at needs an activation to differentiate and the result's
    shape, on every device."""
    a, b = torch.randn(2, 8, 12), torch.randn(2, 12, 16)
    with pytest.raises(ValueError, match="grad_at"):
        TF.filtered_gemm(a, b, act, grad_at=torch.randn(shape))
