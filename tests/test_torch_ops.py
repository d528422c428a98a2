"""The port's kernel modules against the JAX package: the filtered
activation (plain version vs the Pallas kernels ``filtered_act_pallas`` in
"channel" and "spatial" mode, run in interpret mode on the CPU) and
attention (plain version vs ``sdpa_flash`` and ``sdpa_xla``), plus the CPU
dispatchers. The CUDA kernels themselves are held against these plain
versions in ``test_torch_kernels_cuda.py``, on the card.

Tolerances: filtered activation atol 3e-5 / rtol 1e-4, the tolerance the
JAX package holds its own kernels to; attention 1e-5 absolute on
unit-normal inputs (f32 softmax and matmul rounding).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops.attention import _flash_3d, sdpa_flash, sdpa_xla
from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import attention as TA
from afldm_tpu_torch.ops import filtered_act as TF
from test_torch_harness import nchw, nhwc, rand, tt

torch.set_num_threads(1)


# -- filtered activation ------------------------------------------------------

@pytest.mark.parametrize("shape,mode", [
    ((2, 8, 8, 16), "channel"), ((1, 4, 4, 8), "channel"),
    ((1, 16, 12, 8), "channel"), ((1, 32, 32, 4), "spatial"),
    ((1, 16, 24, 3), "spatial"), ((1, 64, 64, 2), "channel"),
    ((1, 12, 20, 2), "channel")])
@pytest.mark.parametrize("act", ["silu", "gelu", "leaky_relu"])
def test_plain_matches_pallas(rng, shape, mode, act):
    x = rand(rng, shape)
    want = jax.jit(lambda z: filtered_act_pallas(z, act, mode))(
        jnp.asarray(x))
    got = TF.filtered_act_plain(nchw(x), act)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (1, 2, 2, 4),
                                   (1, 6, 10, 3), (1, 96, 96, 1),
                                   (1, 80, 80, 1), (1, 32, 128, 1),
                                   (1, 640, 640, 1)])
def test_cpu_dispatcher_matches_jax(rng, shape):
    """The CPU dispatcher takes the JAX package's filtered_nonlinearity
    chain at every size: matmul for % 4 sizes up to 512 px (plane and
    banded ranges alike), spectral above, the FFT ref chain otherwise."""
    from afldm_tpu.ops.ideal_lpf import filtered_nonlinearity
    x = rand(rng, shape)
    want = filtered_nonlinearity(jnp.asarray(x), "silu")
    before = dict(kernels.LAUNCHES)
    got = TF.filtered_act_fused(nchw(x), "silu")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=3e-5,
                               rtol=1e-4)
    assert kernels.LAUNCHES == before  # nothing launches on the CPU


def test_cpu_wrappers_take_plain_version(rng):
    x = nchw(rand(rng, (1, 8, 8, 2)))
    want = TF.filtered_act_plain(x, "silu")
    assert torch.equal(TF.filtered_act_plane(x, "silu"), want)
    assert torch.equal(TF.filtered_act_banded(x, "silu"), want)


def test_dispatcher_below_4d_and_out_of_range(rng):
    """Below 4D the plain activation; 80x80 and 1024x1024, outside the
    kernels' old windows, return JAX's filtered_nonlinearity on the CPU."""
    from afldm_tpu.ops.ideal_lpf import filtered_nonlinearity
    v = torch.from_numpy(rand(rng, (2, 7)))
    assert torch.equal(TF.filtered_act_fused(v, "silu"),
                       torch.nn.functional.silu(v))
    before = dict(kernels.LAUNCHES)
    for side in (80, 1024):
        x = rand(rng, (1, side, side, 1))
        want = filtered_nonlinearity(jnp.asarray(x), "silu")
        got = TF.filtered_act_fused(nchw(x), "silu")
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=3e-5,
                                   rtol=1e-4)
    assert kernels.LAUNCHES == before


def test_kernel_operators_layout():
    uh, uwT, dh, dwT = TF._kernel_ops(8, 12, "cpu")
    assert tuple(uh.shape) == (16, 8) and tuple(uwT.shape) == (12, 24)
    assert tuple(dh.shape) == (8, 16) and tuple(dwT.shape) == (24, 12)
    assert all(o.is_contiguous() for o in (uh, uwT, dh, dwT))
    # the plane forward's k-major operators: U_h^T (H x 2H), D_h^T (2H x H)
    dhT, _, _, uhT = TF._kernel_bwd_ops(8, 12, "cpu")
    assert tuple(uhT.shape) == (8, 16) and tuple(dhT.shape) == (16, 8)
    assert uhT.is_contiguous() and dhT.is_contiguous()
    assert torch.equal(uhT, uh.T) and torch.equal(dhT, dh.T)


PLAN_SIDES = [(4, 4), (8, 8), (12, 12), (20, 20), (32, 32), (64, 64),
              (12, 20), (4, 64), (64, 4), (8, 32), (20, 64)]


@pytest.mark.parametrize("hw", PLAN_SIDES)
@pytest.mark.parametrize("nplanes", [1, 3, 192, 3072, 24576])
def test_plane_plan(hw, nplanes):
    """The plane kernel's launch plan: the block within the 227 KB of
    shared memory, at least one plane a block, a grid of at least
    min(132, planes) blocks, one of the kernel's two block sizes, and
    micro-tiles that divide every product's result."""
    H, W = hw
    plan = TF.plane_plan(H, W, nplanes)
    P = plan.planes_per_block
    assert 1 <= P <= nplanes
    assert plan.smem_bytes == TF.plane_smem_bytes(H, W, P) <= 232448
    assert plan.threads in (256, 512)
    assert -(-nplanes // P) >= min(132, nplanes)
    assert len(plan.tiles) == 4
    for (rows, cols, depth), (tr, tc) in zip(TF.plane_products(H, W),
                                             plan.tiles):
        assert (tr, tc) in TF.K5_TILES
        assert rows % tr == 0 and cols % tc == 0 and depth % 4 == 0
    codes = plan.tile_codes
    assert [TF.K5_TILES[(codes >> i) & 1] for i in range(4)] == \
        list(plan.tiles)


# -- attention ---------------------------------------------------------------

ATT_SHAPES = [  # (B, H, Lq, Lk, D)
    (2, 3, 64, 64, 24), (1, 2, 37, 50, 24), (2, 1, 4, 4, 24),
    (1, 4, 16, 16, 40), (1, 1, 130, 70, 8)]


@pytest.mark.parametrize("shape", ATT_SHAPES)
def test_attention_plain_matches_jax(rng, shape):
    B, H, Lq, Lk, D = shape
    q, k, v = (rand(rng, (B, H, L, D)) for L in (Lq, Lk, Lk))
    out, lse = TA.flash_fwd(tt(q), tt(k), tt(v))
    want_x = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_x), atol=1e-5)
    np.testing.assert_allclose(TA.sdpa(tt(q), tt(k), tt(v)).numpy(),
                               np.asarray(want_x), atol=1e-5)
    if Lq % 8 == 0 and Lk % 8 == 0:  # the Pallas kernel's block rule
        want_f, want_lse = _flash_3d(
            *(jnp.asarray(a.reshape(B * H, -1, D)) for a in (q, k, v)),
            1.0 / np.sqrt(D), 1024, 1024)
        np.testing.assert_allclose(out.numpy().reshape(B * H, Lq, D),
                                   np.asarray(want_f), atol=1e-5)
        np.testing.assert_allclose(lse.numpy().reshape(B * H, Lq, 1),
                                   np.asarray(want_lse), atol=1e-5)


def test_attention_expanded_kv(rng):
    """K/V batch expanded from 1 (the CFA LOAD pass) gives the result of a
    materialised repeat, and matches sdpa_flash on the repeat."""
    q = rand(rng, (4, 2, 64, 24))
    k = rand(rng, (1, 2, 64, 24))
    v = rand(rng, (1, 2, 64, 24))
    ke, ve = tt(k).expand(4, -1, -1, -1), tt(v).expand(4, -1, -1, -1)
    assert ke.stride(0) == 0
    got = TA.sdpa(tt(q), ke, ve)
    want = jax.jit(sdpa_flash)(jnp.asarray(q),
                               jnp.repeat(jnp.asarray(k), 4, axis=0),
                               jnp.repeat(jnp.asarray(v), 4, axis=0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_custom_scale(rng):
    q, k, v = (rand(rng, (1, 2, 16, 8)) for _ in range(3))
    got = TA.sdpa(tt(q), tt(k), tt(v), scale=0.5)
    want = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_large_head_dim_stays_eager(rng):
    """D = 512 (the VAE mid-block's single head) takes matmul + softmax."""
    q, k, v = (rand(rng, (1, 1, 16, 512)) for _ in range(3))
    got = TA.sdpa(tt(q), tt(k), tt(v))
    want = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lse_is_logsumexp(rng):
    q, k, v = (rand(rng, (2, 10, 8)) for _ in range(3))
    _, lse = TA.flash_fwd(tt(q), tt(k), tt(v))
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(8)
    ref = np.log(np.exp(s).sum(-1, keepdims=True))
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5)
