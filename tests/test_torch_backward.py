"""The port's backward passes against the JAX package: the filtered
activation's plain backward (``filtered_act_plane_bwd_plain``) against
``jax.vjp`` of ``filtered_act_pallas`` with ``mode="channel"`` and
``mode="spatial"``, which run the K5b and K2 Pallas kernels in interpret
mode on the CPU, and against torch autograd; the
attention's plain backward (``_attention_bwd_plain``) against ``jax.vjp``
of ``sdpa_flash``, which runs K4a and K4b in interpret mode; and the
autograd Functions that route both on the CPU. The CUDA kernels themselves
are held against these plain versions in ``test_torch_kernels_cuda.py``.

Tolerances: filtered activation 1e-4 absolute + 1e-4 relative (six chained
f32 products of values up to ~10, summed in another order than XLA);
attention 2e-5 absolute on unit-normal inputs (f32 softmax and matmul
rounding); gradcheck at its float64 defaults.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops.attention import sdpa_flash
from afldm_tpu.ops.ideal_lpf import filtered_nonlinearity as jax_filtered
from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import attention as TA
from afldm_tpu_torch.ops import filtered_act as TF
from test_torch_harness import nchw, nhwc, rand, tt

torch.set_num_threads(1)

ACTS = ["silu", "gelu", "relu", "leaky_relu", "mish", "tanh"]


# -- filtered activation (K5b) ---------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (1, 4, 4, 8),
                                   (1, 16, 12, 3)])
@pytest.mark.parametrize("act", ACTS)
def test_plane_bwd_plain_matches_pallas_vjp(rng, shape, act):
    x, g = rand(rng, shape), rand(rng, shape)

    @jax.jit
    def vjp(x, g):
        _, pull = jax.vjp(lambda z: filtered_act_pallas(z, act, "channel"),
                          x)
        return pull(g)[0]

    want = vjp(jnp.asarray(x), jnp.asarray(g))
    got = TF.filtered_act_plane_bwd_plain(nchw(x), nchw(g), act)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_plane_bwd_relu_at_zero_matches_pallas(rng):
    """x = 0: relu'(0) is 1 in the JAX kernels (x >= 0), so the cotangent
    passes through; torch's autograd would give 0 there."""
    x = np.zeros((1, 8, 8, 4), np.float32)
    g = rand(rng, x.shape)
    _, pull = jax.vjp(lambda z: filtered_act_pallas(z, "relu", "channel"),
                      jnp.asarray(x))
    want = np.asarray(pull(jnp.asarray(g))[0])
    got = nhwc(TF.filtered_act_plane_bwd_plain(nchw(x), nchw(g), "relu"))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act", ACTS + ["linear"])
def test_plane_bwd_plain_matches_torch_autograd(rng, act):
    x = nchw(rand(rng, (2, 8, 12, 3)))
    g = nchw(rand(rng, (2, 8, 12, 3)))
    xr = x.clone().requires_grad_()
    TF.filtered_act_plain(xr, act).backward(g)
    got = TF.filtered_act_plane_bwd_plain(x, g, act)
    torch.testing.assert_close(got, xr.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu", "mish"])
def test_plane_function_gradcheck(rng, act):
    x = torch.from_numpy(rand(rng, (1, 2, 8, 4))).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda t: TF.filtered_act_plane(t, act),
                                    (x,))


def test_dispatcher_grad_routes_plane_function(rng):
    """autograd through ``filtered_act_fused`` at plane sizes equals the
    plain backward, and nothing launches on the CPU."""
    x = nchw(rand(rng, (2, 16, 16, 4))).requires_grad_()
    g = nchw(rand(rng, (2, 16, 16, 4)))
    before = dict(kernels.LAUNCHES)
    TF.filtered_act_fused(x, "silu").backward(g)
    assert kernels.LAUNCHES == before
    torch.testing.assert_close(
        x.grad, TF.filtered_act_plane_bwd_plain(x.detach(), g, "silu"))


def test_fft_ref_chain_grad_matches_jax(rng):
    """The UNet's 2x2 level takes the FFT ref chain in both packages;
    autograd through torch.fft against jax.grad."""
    x, g = rand(rng, (2, 2, 2, 6)), rand(rng, (2, 2, 2, 6))
    want = jax.grad(lambda z: jnp.sum(jax_filtered(z, "silu")
                                      * jnp.asarray(g)))(jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    TF.filtered_act_fused(xt, "silu").backward(nchw(g))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want), atol=1e-5)


# -- filtered activation, banded (K2) -----------------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 16, 3), (1, 96, 96, 2)])
@pytest.mark.parametrize("act", ACTS)
def test_banded_bwd_plain_matches_pallas_spatial_vjp(rng, shape, act):
    """K2's plain version is the plane backward's: it equals the VJP of the
    spatial Pallas kernel (``_bwd_spatial``) at any size."""
    x, g = rand(rng, shape), rand(rng, shape)

    @jax.jit
    def vjp(x, g):
        _, pull = jax.vjp(lambda z: filtered_act_pallas(z, act, "spatial"),
                          x)
        return pull(g)[0]

    want = vjp(jnp.asarray(x), jnp.asarray(g))
    got = TF.filtered_act_banded_bwd(nchw(x), nchw(g), act)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu", "leaky_relu"])
def test_banded_function_gradcheck(rng, act):
    """On the CPU the banded Function takes any size (its plain versions)."""
    x = torch.from_numpy(rand(rng, (1, 2, 8, 4))).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: TF.filtered_act_banded(t, act), (x,))


def test_dispatcher_grad_routes_banded_function(rng):
    """autograd through ``filtered_act_fused`` at 96 px goes through the
    banded Function (which saves x) and equals the plain backward; nothing
    launches on the CPU."""
    x = nchw(rand(rng, (1, 96, 96, 2))).requires_grad_()
    g = nchw(rand(rng, (1, 96, 96, 2)))
    before = dict(kernels.LAUNCHES)
    y = TF.filtered_act_fused(x, "silu")
    assert type(y.grad_fn).__name__ == "_FilteredActBandedBackward"
    y.backward(g)
    assert kernels.LAUNCHES == before
    torch.testing.assert_close(
        x.grad, TF.filtered_act_plane_bwd_plain(x.detach(), g, "silu"))


# -- attention (K4a, K4b) --------------------------------------------------

@pytest.mark.parametrize("L,D", [(4, 24), (16, 24), (64, 24), (64, 40),
                                 (64, 80)],
                         ids=["4", "16", "64", "64-d40", "64-d80"])
@pytest.mark.parametrize("kv_batch", [3, 1], ids=["kv3", "kv_expanded"])
def test_attention_bwd_plain_matches_flash_vjp(rng, L, D, kv_batch):
    """The UNet's head dim 24 at three lengths, and the SD UNet's 40 and 80
    (the backward's DP = 40 and 80 tilings on the card)."""
    B, H = 3, 2
    q, do = rand(rng, (B, H, L, D)), rand(rng, (B, H, L, D))
    k, v = rand(rng, (kv_batch, H, L, D)), rand(rng, (kv_batch, H, L, D))

    @jax.jit
    def vjp(q, k, v, do):
        def f(q, k, v):
            kb, vb = (jnp.broadcast_to(t, (B,) + t.shape[1:])
                      for t in (k, v))
            return sdpa_flash(q, kb, vb)
        _, pull = jax.vjp(f, q, k, v)
        return pull(do)

    want = vjp(*(jnp.asarray(a) for a in (q, k, v, do)))
    qt = tt(q)
    kt, vt = (tt(a).expand(B, -1, -1, -1) for a in (k, v))
    out, lse = TA.flash_fwd(qt, kt, vt)
    dq, dk, dv = TA._attention_bwd_plain(qt, kt, vt, out, lse, tt(do))
    # the expanded batch's gradient is the sum over images, as autograd's
    # expand backward forms it
    dk, dv = (t.reshape(B // kv_batch, kv_batch, H, L, D).sum(0)
              if kv_batch == 1 else t for t in (dk, dv))
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_sdpa_function_grads_match_eager_autograd(rng):
    """The Function's CPU backward (dq and dkv wrappers on their plain
    versions) equals torch autograd through matmul + softmax, with q a
    transposed view and K/V expanded from one image."""
    q0 = tt(rand(rng, (4, 16, 2, 8))).requires_grad_()
    k0 = tt(rand(rng, (1, 2, 16, 8))).requires_grad_()
    v0 = tt(rand(rng, (1, 2, 16, 8))).requires_grad_()
    g = tt(rand(rng, (4, 2, 16, 8)))

    def grads(fn):
        out = fn(q0.transpose(1, 2), k0.expand(4, -1, -1, -1),
                 v0.expand(4, -1, -1, -1))
        return torch.autograd.grad(out, (q0, k0, v0), g)

    before = dict(kernels.LAUNCHES)
    got = grads(TA.sdpa)
    assert kernels.LAUNCHES == before
    for a, b in zip(got, grads(TA.sdpa_eager)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)


def test_bwd_wrappers_split_the_plain_backward(rng):
    q, k, v, do = (tt(rand(rng, (2, 10, 8))) for _ in range(4))
    out, lse = TA.flash_fwd(q, k, v)
    delta = TA._delta(do, out)
    dq, dk, dv = TA._attention_bwd_plain(q, k, v, out, lse, do)
    assert torch.equal(TA.flash_bwd_dq(q, k, v, do, lse, delta), dq)
    got_k, got_v = TA.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert torch.equal(got_k, dk) and torch.equal(got_v, dv)
