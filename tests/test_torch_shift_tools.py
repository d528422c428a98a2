"""The port's FIR ops (``ops/upfirdn2d.py``), ``ops/bias_act.py``, the
shifters in all six modes with their extras (``shift/shifters.py``) and
the flow utilities (``shift/flow.py``) against the JAX package, on the
same numpy inputs (NHWC to JAX, NCHW to the port). Where JAX draws from a
key, the test makes the same draw with JAX and hands it to the port.

Tolerances: the ops, shifters and flow functions 1e-5 absolute (f32
rounding; the convolutions sum in another order); filters built in numpy
1e-7; masks, indices and integer offsets exactly.
"""

from functools import partial
from importlib import import_module

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.shift import flow as JF
from afldm_tpu.shift import shifters as JS
from afldm_tpu_torch.shift import flow as TF
from afldm_tpu_torch.shift import shifters as TS
from test_torch_harness import nchw, nhwc, rand, tt

# the packages' ``ops`` export functions of the modules' own names
JB = import_module("afldm_tpu.ops.bias_act")
JU = import_module("afldm_tpu.ops.upfirdn2d")
TB = import_module("afldm_tpu_torch.ops.bias_act")
TU = import_module("afldm_tpu_torch.ops.upfirdn2d")

torch.set_num_threads(1)

ATOL = 1e-5


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=atol)


def same(got, want):
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def filt(rng, kind):
    """A random filter: 2-D (h, w), or 1-D of n taps (separable)."""
    if kind is None:
        return None
    return rng.standard_normal(kind).astype(np.float32)


# -- upfirdn2d ----------------------------------------------------------------

@pytest.mark.parametrize("f,kw", [
    ([1, 3, 3, 1], {}),
    ([1, 3, 3, 1], dict(separable=True, flip_filter=True, gain=4)),
    ([1, 2, 3, 4, 4, 3, 2, 1], dict(gain=2)),
    ([[1, 2, 0], [3, 5, 1]], dict(flip_filter=True)),
    ([2.0], dict(normalize=False, gain=3)),
    (None, {}),
])
def test_setup_filter(f, kw):
    want = np.asarray(JU.setup_filter(f, **kw))
    got = TU.setup_filter(f, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("fkind", [(4, 4), (3, 5), (8,), (4,), None])
@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2), ((2, 1), 1),
                                     (4, 2)])
@pytest.mark.parametrize("padding", [0, (2, 1, 2, 1), (3, -1, 0, 2)])
def test_upfirdn2d(rng, fkind, up, down, padding):
    x = rand(rng, (2, 12, 10, 3))
    f = filt(rng, fkind)
    kw = dict(up=up, down=down, padding=padding, gain=2.0)
    want = JU.upfirdn2d(jnp.asarray(x), None if f is None else jnp.asarray(f),
                        **kw)
    got = TU.upfirdn2d(nchw(x), None if f is None else torch.from_numpy(f),
                       **kw)
    close(got, want)


def test_upfirdn2d_flip_filter_and_dtype(rng):
    x = rand(rng, (1, 8, 9, 2))
    f = filt(rng, (3, 3))
    want = JU.upfirdn2d(jnp.asarray(x), jnp.asarray(f), padding=1,
                        flip_filter=True)
    got = TU.upfirdn2d(nchw(x), torch.from_numpy(f), padding=1,
                       flip_filter=True)
    close(got, want)
    half = TU.upfirdn2d(nchw(x).to(torch.bfloat16), torch.from_numpy(f),
                        padding=1)
    assert half.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="smaller than the filter"):
        TU.upfirdn2d(nchw(x), torch.ones(12, 12))


@pytest.mark.parametrize("fkind", [(4, 4), (5, 5), (8,), (2, 3)])
@pytest.mark.parametrize("op", ["filter2d", "upsample2d", "downsample2d"])
@pytest.mark.parametrize("padding", [0, (1, 0, 2, 1)])
def test_fir_wrappers(rng, fkind, op, padding):
    x = rand(rng, (2, 12, 12, 3))
    f = filt(rng, fkind)
    want = getattr(JU, op)(jnp.asarray(x), jnp.asarray(f), padding=padding,
                           gain=1.5)
    got = getattr(TU, op)(nchw(x), torch.from_numpy(f), padding=padding,
                          gain=1.5)
    close(got, want)


@pytest.mark.parametrize("up,down,fkind", [(1, 1, None), (2, 1, (4, 4)),
                                           (1, 2, (4, 4)), (2, 1, (8,))])
@pytest.mark.parametrize("groups,flip_weight", [(1, True), (1, False),
                                                (3, True)])
def test_conv2d_resample(rng, up, down, fkind, groups, flip_weight):
    x = rand(rng, (2, 10, 10, 6))
    w = rand(rng, (3, 3, 6 // groups, 9))  # HWIO
    f = filt(rng, fkind)
    kw = dict(up=up, down=down, padding=1, groups=groups,
              flip_weight=flip_weight)
    want = JU.conv2d_resample(jnp.asarray(x), jnp.asarray(w),
                              None if f is None else jnp.asarray(f), **kw)
    got = TU.conv2d_resample(nchw(x),
                             torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                             None if f is None else torch.from_numpy(f), **kw)
    close(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


# -- bias_act -----------------------------------------------------------------

@pytest.mark.parametrize("act", sorted(JB.activation_funcs))
@pytest.mark.parametrize("kw", [{}, dict(alpha=0.1, gain=0.5, clamp=0.8)])
def test_bias_act(rng, act, kw):
    x = rand(rng, (2, 5, 6, 4)) * 2
    b = rand(rng, (4,))
    spec, tspec = JB.activation_funcs[act], TB.activation_funcs[act]
    assert (tspec.def_alpha, tspec.def_gain) == (spec.def_alpha,
                                                 spec.def_gain)
    want = JB.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, **kw)
    got = TB.bias_act(nchw(x), torch.from_numpy(b), act=act, **kw)
    close(got, want)
    # along the width, and without a bias
    bw = rand(rng, (6,))
    close(TB.bias_act(nchw(x), torch.from_numpy(bw), dim=3, act=act),
          JB.bias_act(jnp.asarray(x), jnp.asarray(bw), dim=2, act=act))
    close(TB.bias_act(nchw(x), act=act), JB.bias_act(jnp.asarray(x), act=act))


def test_fma_and_filtered_lrelu(rng):
    a, b, c = (rand(rng, (2, 4, 5, 3)) for _ in range(3))
    close(TB.fma(nchw(a), nchw(b), nchw(c)),
          JB.fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    x = rand(rng, (2, 10, 10, 3))
    bias = rand(rng, (3,))
    fu = np.asarray(JU.setup_filter([1, 3, 3, 1]))
    fd = np.asarray(JU.setup_filter([1, 2, 1]))
    for kw in (dict(up=2, down=2, padding=2, clamp=0.7),
               dict(up=1, down=2, padding=(1, 1, 2, 0), slope=0.1)):
        want = JB.filtered_lrelu(jnp.asarray(x), jnp.asarray(fu),
                                 jnp.asarray(fd), jnp.asarray(bias), **kw)
        got = TB.filtered_lrelu(nchw(x), tt(fu), tt(fd), tt(bias),
                                **kw)
        close(got, want)


# -- shifters -----------------------------------------------------------------

SHIFTS = [(0.0, 1.0), (0.375, -0.625), (-2.5, 1.25)]


@pytest.mark.parametrize("mode", JS.FILTER_CHOICES)
@pytest.mark.parametrize("ti,tj", SHIFTS)
def test_shifter_modes(rng, mode, ti, tj):
    assert TS.FILTER_CHOICES == JS.FILTER_CHOICES
    x = rand(rng, (2, 16, 12, 3))
    js = JS.ImageShifter(mode, 8)
    ts = TS.ImageShifter(mode, 8)
    wx, wm = js.shift(jnp.asarray(x), ti, tj)
    gx, gm = ts.shift(nchw(x), ti, tj)
    close(gx, wx)
    assert gm.shape[1] == wm.shape[-1]
    same(gm, wm)


def test_shifter_ideal_ratio_one_and_cache(rng):
    x = rand(rng, (1, 8, 8, 4))
    js, ts = JS.ImageShifter("ideal", 1), TS.ImageShifter("ideal", 1)
    close(ts.shift(nchw(x), 2.0, -3.0)[0], js.shift(jnp.asarray(x), 2, -3)[0])
    ts = TS.ImageShifter("ideal_crop", 4)
    cache = ts.precompute(nchw(x))
    got = ts.shift(nchw(x), 0.25, 0.5, cache=cache)[0]
    close(got, JS.ImageShifter("ideal_crop", 4).shift(jnp.asarray(x), 0.25,
                                                      0.5)[0])
    assert TS.ImageShifter("fourier").precompute(nchw(x)) is None


@pytest.mark.parametrize("shift", [(0.25, 1.5), (-1.75, 0.5)])
def test_fourier_shift_batch(rng, shift):
    x = rand(rng, (2, 10, 14, 3))
    close(TS.fourier_shift_batch(nchw(x), *shift),
          JS.fourier_shift_batch(jnp.asarray(x), *shift))


@pytest.mark.parametrize("int_offset,stride,mins", [
    (True, 1, (0, 0)), (True, 4, (0, 0)), (False, 1, (0, 0)),
    (False, 1, (1.5, -2.0)), (True, 2, (2, 1))])
def test_gen_random_offset(int_offset, stride, mins):
    key = jax.random.PRNGKey(3)
    args = (9.0, 6.0, int_offset, stride)
    kw = dict(bs=5, min_offset_i=mins[0], min_offset_j=mins[1])
    want = JS.gen_random_offset(key, *args, **kw)
    ki, kj = jax.random.split(key)
    if int_offset:
        ri, rj = int((9.0 - mins[0]) // stride), int((6.0 - mins[1]) // stride)
        draws = (tt(jax.random.randint(ki, (5,), -ri, ri + 1)),
                 tt(jax.random.randint(kj, (5,), -rj, rj + 1)))
    else:
        draws = (tt(jax.random.uniform(ki, (5,))),
                 tt(jax.random.uniform(kj, (5,))))
    got = TS.gen_random_offset(*args, **kw, draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # drawn by the port: on the grid and within range
    oi, oj = TS.gen_random_offset(*args, **kw,
                                  generator=torch.Generator().manual_seed(0))
    assert oi.shape == (5,) and (oi - mins[0]).abs().max() <= 9.0 - mins[0]
    if int_offset:
        assert torch.equal(torch.remainder(oi - mins[0], stride),
                           torch.zeros(5))


def _bg(bg_type, key, shape):
    """The JAX package's background draw for ``bg_type`` (NHWC shape)."""
    if bg_type == JS.BgType.RANDN:
        return np.asarray(jax.random.normal(key, shape))
    if bg_type == JS.BgType.FULL_COLOR:
        n, c = shape[0], shape[-1]
        return np.asarray(jax.random.uniform(key, (n, 1, 1, c)) * 2 - 1)
    return None


@pytest.mark.parametrize("bg", list(JS.BgType))
@pytest.mark.parametrize("mode", ["bilinear", "lanczos"])
def test_translate_with_occ_bg(rng, bg, mode):
    x = rand(rng, (2, 12, 12, 3))
    key = jax.random.PRNGKey(5)
    mask = (rng.random((2, 12, 12, 1)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = JS.ImageShifter(mode).translate_with_occ_bg(
            key, jnp.asarray(x), 1.5, -2.25, JS.BgType(bg.value),
            mask=None if m is None else jnp.asarray(m), return_mask=True)
        b = _bg(bg, key, x.shape)
        got = TS.ImageShifter(mode).translate_with_occ_bg(
            nchw(x), 1.5, -2.25, TS.BgType(bg.value),
            mask=None if m is None else nchw(m), return_mask=True,
            background=None if b is None else nchw(b))
        close(got[0], want[0])
        same(got[1], want[1])
    if bg in (JS.BgType.RANDN, JS.BgType.FULL_COLOR):
        drawn = TS.ImageShifter(mode).translate_with_occ_bg(
            nchw(x), 1.5, -2.25, TS.BgType(bg.value),
            generator=torch.Generator().manual_seed(0))
        assert drawn.shape == (2, 3, 12, 12)


@pytest.mark.parametrize("mode,int_offset,align", [
    ("bilinear", False, False), ("ideal", True, True)])
def test_image_latent_random_translate(rng, mode, int_offset, align):
    img = rand(rng, (1, 32, 32, 3))
    lat = rand(rng, (1, 4, 4, 4))
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda k, a, b: JS.ImageShifter(
        mode, 8).image_latent_random_translate(
        k, a, b, 6, 5, batch_size=2, int_offset=int_offset,
        align_latent=align))(key, jnp.asarray(img), jnp.asarray(lat))
    k_off, k_bg1, k_bg2 = jax.random.split(key, 3)
    ti, tj = JS.gen_random_offset(k_off, 6, 5, int_offset, 8 if align else 1)
    bgs = (_bg(JS.BgType.FULL_COLOR, k_bg1, (2, 32, 32, 3)),
           _bg(JS.BgType.FULL_COLOR, k_bg2, (2, 4, 4, 4)))
    got = TS.ImageShifter(mode, 8).image_latent_random_translate(
        nchw(img), nchw(lat), 6, 5, batch_size=2, int_offset=int_offset,
        align_latent=align, offset=(float(ti[0]), float(tj[0])),
        backgrounds=tuple(nchw(b) for b in bgs))
    for g, w in zip(got, want):
        close(g, w)
    drawn = TS.ImageShifter(mode, 8).image_latent_random_translate(
        nchw(img), nchw(lat), 6, 5, generator=torch.Generator().manual_seed(0))
    assert [d.shape[2] for d in drawn] == [32, 4, 32, 4]


@pytest.mark.parametrize("length", [4, 5])
def test_blur_kernel_and_pad_zero(rng, length):
    np.testing.assert_allclose(TS.get_blur_kernel(length).numpy(),
                               np.asarray(JS.get_blur_kernel(length)),
                               atol=1e-7)
    x = rand(rng, (2, 5, 6, 3))
    same(TS.upsample_pad_zero(nchw(x), length),
         JS.upsample_pad_zero(jnp.asarray(x), length))


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "ideal", "blur"])
@pytest.mark.parametrize("scale", [2, 4])
def test_image_upsampler(rng, mode, scale):
    x = rand(rng, (2, 8, 8, 3))
    js, ts = JS.ImageUpsampler(scale, mode), TS.ImageUpsampler(scale, mode)
    close(ts.upsample(nchw(x)), js.upsample(jnp.asarray(x)))
    if mode != "blur" or scale == 2:  # blur's low-pass is a 2x pass
        close(ts.low_pass(nchw(x)), js.low_pass(jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "ideal", "blur"])
@pytest.mark.parametrize("scale", [2, 4])
def test_image_downsampler(rng, mode, scale):
    x = rand(rng, (2, 16, 16, 3))
    close(TS.ImageDownsampler(scale, mode).downsample(nchw(x)),
          JS.ImageDownsampler(scale, mode).downsample(jnp.asarray(x)))


def test_resize_conventions():
    """4x4 -> 2x2: nearest takes the half-pixel centres (pixels 1 and 3),
    bilinear anti-aliases (the mean of each 2x2 block, interior 3.571...)."""
    x = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    got = TS.ImageDownsampler(2, "nearest").downsample(nchw(x))
    np.testing.assert_array_equal(got.flatten().numpy(), [5, 7, 13, 15])
    x = rand(np.random.default_rng(4), (1, 7, 7, 1))
    got = TS.ImageDownsampler(2, "bilinear").downsample(nchw(x))
    close(got, JS.ImageDownsampler(2, "bilinear").downsample(jnp.asarray(x)))
    with pytest.raises(ValueError, match="resize mode"):
        TS.ImageUpsampler(2, "bicubic").upsample(nchw(x))


@pytest.mark.parametrize("scale", [2, 4])
def test_learned_upsampler(rng, scale):
    x = rand(rng, (2, 6, 6, 3))
    ju = JS.LearnedUpsampler(scale)
    params = {"kernel": jnp.asarray(rand(rng, (4, 4)))}
    tu = TS.LearnedUpsampler(scale)
    np.testing.assert_allclose(tu.kernel.detach().numpy(),
                               np.asarray(ju.init_params()["kernel"]))
    assert [n for n, _ in tu.named_parameters()] == ["kernel"]
    tu.load_state_dict({"kernel": tt(params["kernel"])})
    got = tu(nchw(x))
    close(got, ju.upsample(params, jnp.asarray(x)))
    got.square().sum().backward()
    assert tu.kernel.grad is not None and tu.kernel.grad.abs().sum() > 0


# -- flow ---------------------------------------------------------------------

def flows(rng, shape, scale=2.5):
    return (rand(rng, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [0.7, 3.0])
def test_nearest_warps(rng, scale):
    img = rand(rng, (2, 9, 11, 3))
    flow = flows(rng, (2, 9, 11, 2), scale)
    occ = (rng.random((2, 9, 11, 1)) > 0.7).astype(np.float32)
    close(TF.flow_warp_nearest(nchw(img), nchw(flow)),
          JF.flow_warp_nearest(jnp.asarray(img), jnp.asarray(flow)))
    close(TF.flow_reverse_map(nchw(img), nchw(flow)),
          JF.flow_reverse_map(jnp.asarray(img), jnp.asarray(flow)))
    for o in (None, occ):
        close(TF.flow_warp_splat_nearest(nchw(img), nchw(flow),
                                         None if o is None else nchw(o)),
              JF.flow_warp_splat_nearest(jnp.asarray(img), jnp.asarray(flow),
                                         None if o is None
                                         else jnp.asarray(o)))


@pytest.mark.parametrize("scale", [0.6, 2.5])
def test_forward_flow_warp(rng, scale):
    img = rand(rng, (2, 10, 9, 3))
    flow = flows(rng, (2, 10, 9, 2), scale)
    want = jax.jit(JF.forward_flow_warp)(jnp.asarray(img), jnp.asarray(flow))
    got = TF.forward_flow_warp(nchw(img), nchw(flow))
    close(got[0], want[0])
    same(got[1], want[1])


def test_forward_upsample_flow_warp(rng):
    img = rand(rng, (1, 4, 4, 3))
    flow = flows(rng, (1, 16, 16, 2), 3.0)
    want = jax.jit(partial(JF.forward_upsample_flow_warp, scale=4))(
        jnp.asarray(img), jnp.asarray(flow))
    got = TF.forward_upsample_flow_warp(nchw(img), nchw(flow), scale=4)
    close(got[0], want[0])
    same(got[1], want[1])


def test_continuous_noise_warps(rng):
    noise = rand(rng, (2, 16, 16, 4))
    fwd = flows(rng, (2, 16, 16, 2), 2.0)
    occ = (rng.random((2, 16, 16, 1)) > 0.8).astype(np.float32)
    key = jax.random.PRNGKey(9)
    fresh = nchw(jax.random.normal(key, (2, 16, 16, 4)))
    close(TF.continuous_noise_warp(nchw(noise), nchw(fwd), nchw(occ), 0.5,
                                   noise_ratio=4, fresh=fresh),
          jax.jit(partial(JF.continuous_noise_warp, noise_ratio=4))(
              jnp.asarray(noise), jnp.asarray(fwd), jnp.asarray(occ), 0.5,
              key))
    close(TF.continuous_noise_fwd_warp(nchw(noise), nchw(fwd), 0.7,
                                       noise_ratio=4, fresh=fresh),
          jax.jit(partial(JF.continuous_noise_fwd_warp, noise_ratio=4))(
              jnp.asarray(noise), jnp.asarray(fwd), 0.7, key))
    bwd = flows(rng, (2, 8, 8, 2), 1.5)
    bocc = (rng.random((2, 8, 8, 1)) > 0.8).astype(np.float32)
    close(TF.continuous_noise_warp_bwd(nchw(noise), nchw(bwd), nchw(bocc),
                                       noise_ratio=4, flow_ratio=2,
                                       fresh=fresh),
          jax.jit(partial(JF.continuous_noise_warp_bwd, noise_ratio=4,
                          flow_ratio=2))(jnp.asarray(noise), jnp.asarray(bwd),
                                         jnp.asarray(bocc), key))


@pytest.mark.parametrize("hw", [(13, 10), (16, 16), (7, 21)])
@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_input_padder(rng, hw, mode):
    x = rand(rng, (1, *hw, 3))
    jp = JF.InputPadder(x.shape, mode=mode, padding_factor=8)
    tp = TF.InputPadder(nchw(x).shape, mode=mode, padding_factor=8)
    (want,) = jp.pad(jnp.asarray(x))
    (got,) = tp.pad(nchw(x))
    same(got, want)
    same(tp.unpad(got), x)


@pytest.mark.parametrize("is_randn", [True, False])
@pytest.mark.parametrize("filter,offsets", [(None, None), ("lanczos", None),
                                            ("lanczos", (1.25, -2.5))])
def test_flow_warp_with_occ_bg(rng, is_randn, filter, offsets):
    img = rand(rng, (2, 12, 12, 3))
    flow = np.broadcast_to(np.float32([-1.5, 2.75]),
                           (2, 12, 12, 2)).copy()
    if filter is None:
        flow = flows(rng, (2, 12, 12, 2))
    mask = (rng.random((2, 12, 12, 1)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = JF.flow_warp_with_occ_bg(key, jnp.asarray(img), jnp.asarray(flow),
                                    jnp.asarray(mask), is_randn, filter,
                                    offsets)
    bg = _bg(JS.BgType.RANDN if is_randn else JS.BgType.FULL_COLOR, key,
             img.shape)
    got = TF.flow_warp_with_occ_bg(nchw(img), nchw(flow), nchw(mask),
                                   is_randn, filter, offsets,
                                   background=nchw(bg))
    close(got, want)


@pytest.mark.parametrize("box,disp,alpha", [((2, 6, 2, 6), (4, 0), 1),
                                            ((3, 9, 1, 5), (-2, 3), 0.5)])
def test_get_patch_moving_flow(box, disp, alpha):
    tmpl = np.zeros((2, 16, 16, 3), np.float32)
    want = JF.get_patch_moving_flow(jnp.asarray(tmpl), box, disp, alpha)
    got = TF.get_patch_moving_flow(nchw(tmpl), box, disp, alpha)
    for g, w in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("noise_upsample,int_offset", [(True, False),
                                                       (False, False),
                                                       (True, True)])
def test_noise_image_random_translate(rng, noise_upsample, int_offset):
    img = rand(rng, (1, 16, 16, 3))
    noise = rand(rng, (1, 4, 4, 4))
    key = jax.random.PRNGKey(11)
    want = JF.noise_image_random_translate(
        key, jnp.asarray(img), jnp.asarray(noise), 5, 3,
        noise_upsample=noise_upsample, batch_size=2, int_offset=int_offset)
    k_off, k_bg, k_noise, k_col = jax.random.split(key, 4)
    ti, tj = JS.gen_random_offset(k_off, 5, 3, int_offset, 1)
    bg = _bg(JS.BgType.FULL_COLOR, k_bg, (2, 16, 16, 3))
    z = jax.random.normal(k_noise, (2, 16, 16, 4))
    fresh = jax.random.normal(k_col, (2, 16, 16, 4) if noise_upsample
                              else (2, 4, 4, 4))
    got = TF.noise_image_random_translate(
        nchw(img), nchw(noise), 5, 3, noise_upsample=noise_upsample,
        batch_size=2, int_offset=int_offset,
        offset=(float(ti[0]), float(tj[0])), background=nchw(bg), z=nchw(z),
        fresh=nchw(fresh))
    for g, w in zip(got, want):
        close(g, w)
    drawn = TF.noise_image_random_translate(
        nchw(img), nchw(noise), 5, 3, noise_upsample=noise_upsample,
        generator=torch.Generator().manual_seed(0))
    assert drawn[1].shape == (1, 4, 4, 4)


def _stub_flow_fns(rng, shape):
    """The same flow_fn for both packages: a fixed numpy flow of the padded
    ``shape`` (N, H, W, 2) plus a term that depends on the images."""
    base = flows(rng, shape, 1.5)
    back = flows(rng, shape, 1.5)

    def jfn(a, b):
        d = (b - a)[..., :2] * 0.1
        return jnp.asarray(base) + d, None, jnp.asarray(back) - d, None

    def tfn(a, b):
        d = (b - a)[:, :2] * 0.1
        return nchw(base) + d, None, nchw(back) - d, None
    return jfn, tfn


@pytest.mark.parametrize("pixel_consistency", [False, True])
def test_flow_fn_wrappers(rng, pixel_consistency):
    a, b, c = (rand(rng, (1, 13, 10, 3)) for _ in range(3))
    ja, jb, jc = (jnp.asarray(v) for v in (a, b, c))
    ta, tb, tc = (nchw(v) for v in (a, b, c))
    jfn, tfn = _stub_flow_fns(rng, (1, 16, 16, 2))
    for g, w in zip(TF.predict_flow(tfn, ta, tb),
                    jax.jit(partial(JF.predict_flow, jfn))(ja, jb)):
        close(g, w)
    for g, w in zip(TF.alpha_warp(tfn, ta, tb, 0.4),
                    jax.jit(partial(JF.alpha_warp, jfn))(ja, jb, 0.4)):
        close(g, w)
    for g, w in zip(TF.get_warped_and_mask(tfn, ta, tb, tc,
                                           pixel_consistency),
                    jax.jit(partial(JF.get_warped_and_mask, jfn,
                                    pixel_consistency=pixel_consistency))(
                        ja, jb, jc)):
        close(g, w)
    with pytest.raises(TypeError, match="flow callable"):
        TF.predict_flow(ta, ta, tb)


def test_lk_flow_serves_as_flow_fn(rng):
    from afldm_tpu_torch.shift.simple_flow import predict_flow as lk
    a = rand(rng, (1, 20, 20, 3))
    b = np.roll(a, 1, axis=2)
    fwd, fwd_occ, bwd, bwd_occ = TF.predict_flow(lk, nchw(a), nchw(b))
    assert fwd.shape == (1, 2, 20, 20) and fwd_occ.shape == (1, 1, 20, 20)
    assert torch.isfinite(fwd).all() and torch.isfinite(bwd).all()


def test_exports_match():
    import afldm_tpu.ops as jops
    import afldm_tpu.shift as jshift
    import afldm_tpu_torch.ops as tops
    import afldm_tpu_torch.shift as tshift
    assert set(jshift.__all__) <= set(tshift.__all__)
    for name in ("bias_act", "activation_funcs", "fma", "filtered_lrelu",
                 "conv2d_resample", "upfirdn2d", "filter2d", "upsample2d",
                 "downsample2d", "setup_filter"):
        assert name in jops.__all__ and name in tops.__all__
        assert callable(getattr(tops, name)) or name == "activation_funcs"
