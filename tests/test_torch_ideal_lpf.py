"""afldm_tpu_torch.ops.ideal_lpf against afldm_tpu.ops.ideal_lpf: masks,
operators, every resampling backend (including sizes not divisible by 4
and odd sizes) and the filtered nonlinearity's fallback chain.

Tolerance: 1e-5 absolute on unit-normal inputs for single f32 ops (FFT and
matmul rounding differ between XLA and PyTorch at ~1e-6); 3e-5 / 1e-4 for
the filtered nonlinearity, the tolerance the JAX package holds its own
kernels to.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops import ideal_lpf as J
from afldm_tpu_torch.ops import ideal_lpf as T
from test_torch_harness import nchw, nhwc, rand

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.mark.parametrize("N", [4, 6, 7, 8, 16, 30])
@pytest.mark.parametrize("cutoff", [0.25, 0.5])
def test_rect_masks_equal(N, cutoff):
    np.testing.assert_array_equal(T.create_lpf_rect(N, cutoff),
                                  J.create_lpf_rect(N, cutoff))
    np.testing.assert_array_equal(T.create_recon_rect(N, cutoff),
                                  J.create_recon_rect(N, cutoff))
    np.testing.assert_array_equal(T.create_fixed_lpf_rect(N, 3),
                                  J.create_fixed_lpf_rect(N, 3))


@pytest.mark.parametrize("N", [4, 8, 12, 32, 64])
def test_operators_equal(N):
    np.testing.assert_array_equal(T._upsample_op(N, 2), J._upsample_op(N, 2))
    np.testing.assert_array_equal(T._downsample_op(2 * N, 2),
                                  J._downsample_op(2 * N, 2))
    np.testing.assert_array_equal(T._upsample_op(N, 8), J._upsample_op(N, 8))


def test_operator_cache_is_per_device():
    a = T._op("up", 8, 2, "cpu")
    assert a is T._op("up", 8, 2, torch.device("cpu"))
    assert a.dtype == torch.float32 and tuple(a.shape) == (16, 8)


SHAPES = [(2, 8, 8, 3), (1, 12, 16, 2), (1, 6, 6, 2), (1, 10, 14, 3),
          (1, 7, 9, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["matmul", "spectral", "ref"])
def test_upsample_rfft(rng, shape, impl):
    x = rand(rng, shape)
    want = J.upsample_rfft(jnp.asarray(x), up=2, impl=impl)
    got = T.upsample_rfft(nchw(x), up=2, impl=impl)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["matmul", "spectral", "ref"])
def test_downsample_rfft(rng, shape, impl):
    x = rand(rng, shape)
    want = J.downsample_rfft(jnp.asarray(x), down=2, impl=impl)
    got = T.downsample_rfft(nchw(x), down=2, impl=impl)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("up", [4, 8])
def test_upsample_large_factor(rng, up):
    x = rand(rng, (1, 8, 8, 4))
    want = J.upsample_rfft(jnp.asarray(x), up=up)
    got = T.upsample_rfft(nchw(x), up=up)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_upsample_factor_ref(rng):
    x = rand(rng, (1, 8, 8, 2))
    want = J.upsample_rfft(jnp.asarray(x), up=2, factor=2)
    got = T.upsample_rfft(nchw(x), up=2, factor=2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 8, 8, 2), (2, 9, 12, 3)])
@pytest.mark.parametrize("fixed", [None, 4])
def test_lpf_rfft(rng, shape, fixed):
    x = rand(rng, shape)
    np.testing.assert_allclose(
        nhwc(T.lpf_rfft(nchw(x), 0.5, fixed)),
        np.asarray(J.lpf_rfft(jnp.asarray(x), 0.5, fixed)), atol=ATOL)
    np.testing.assert_allclose(
        nhwc(T.lpf_recon_rfft(nchw(x), 0.5)),
        np.asarray(J.lpf_recon_rfft(jnp.asarray(x), 0.5)), atol=ATOL)


@pytest.mark.parametrize("sx,sy", [(1, 1), (1, 0), (3, 2)])
def test_subpixel_shift(rng, sx, sy):
    x = rand(rng, (1, 8, 8, 3))
    want = J.subpixel_shift(jnp.asarray(x), up=4, shift_x=sx, shift_y=sy)
    got = T.subpixel_shift(nchw(x), up=4, shift_x=sx, shift_y=sy)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


FN_SHAPES = [(2, 8, 8, 4), (1, 16, 12, 3), (1, 2, 2, 4), (1, 6, 10, 2),
             (1, 5, 7, 2)]


@pytest.mark.parametrize("shape", FN_SHAPES)
@pytest.mark.parametrize("impl", ["matmul", "spectral", "ref"])
def test_filtered_nonlinearity(rng, shape, impl):
    x = rand(rng, shape)
    want = J.filtered_nonlinearity(jnp.asarray(x), "silu", impl=impl)
    got = T.filtered_nonlinearity(nchw(x), "silu", impl=impl)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("act", sorted(J._ACTS))
def test_activations(rng, act):
    x = rand(rng, (1, 8, 8, 2)) * 3
    np.testing.assert_allclose(
        nhwc(T._ACTS[act](nchw(x))), np.asarray(J._ACTS[act](jnp.asarray(x))),
        atol=1e-6, rtol=1e-5)


def test_below_4d_gets_plain_activation(rng):
    x = rand(rng, (3, 5))
    np.testing.assert_allclose(
        T.filtered_nonlinearity(torch.from_numpy(x), "silu").numpy(),
        np.asarray(J.filtered_nonlinearity(jnp.asarray(x), "silu")),
        atol=1e-6)


def test_set_af_precision_turns_tf32_off():
    """Every level switches TF32 off for matmuls and cuDNN (the level
    governs the circulant products only); an unknown name raises."""
    try:
        for level in ("highest", "high", "default"):
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            T.set_af_precision(level)
            assert T.af_precision() == level
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(ValueError, match="bogus"):
            T.set_af_precision("bogus")
        assert T.af_precision() == "default"
    finally:
        T.set_af_precision("highest")
