"""The reduced af_precision levels ('high': each circulant product the
3-pass bf16 split ``ah·bh + ah·bl + al·bh``; 'default': ``ah·bh``) in the
port, on the CPU.

- The plain versions of the four filtered-activation kernels at 'high'
  against the JAX package's Pallas kernels at 'high' in interpret mode
  (``filtered_act_pallas(x, act, "channel")`` for K5, ``"spatial"`` for K1,
  ``jax.vjp`` of each for K5b and K2): RMS(d) <= 0.25 × RMS(JAX 'high' -
  JAX 'highest'), and max |d| <= 2e-5 at 8 and 4 px; at 96 px, where the
  values reach ~3 and one lo ulp of an intermediate is worth ~1e-5 of
  the output, max |d| reached 2.0-2.1e-5 on three draws (within 0.8 of the
  level's own max error), so there the max is bounded by the level's own
  max error, chip_smoke's bound. The port's plain versions sum
  exactly (float64, rounded once a product) where XLA sums in float32, so
  they differ by float32 sum orders, which at 'high' move the bf16 lo
  pieces of the intermediates that are split again: a share of the
  level's own error, hence the RMS bound. XLA's CPU dot ignores the level
  outside Pallas, so 'default' and the plain ``_apply_sep`` path are held
  against a numpy emulation of the split (``ml_dtypes.bfloat16``) instead,
  with the same bounds, and each level must move the result from
  'highest' by its own magnitude.
- The slice as a whole: the tiny shift protocol of the port at 'high'
  against JAX's at 'highest' (JAX on the CPU runs 'high' exactly outside
  Pallas): per-shift masked PSNR within 0.01 dB, at 'default' within
  0.1 dB, and the port's 'high' output differs from its 'highest' output.
- The level through ``load_pipeline``, the autograd Functions and
  ``scripts/eval_af_precision``.
"""

import itertools
import json

import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops import set_af_precision as jax_set_af_precision
from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch.ops import filtered_act as TF
from afldm_tpu_torch.ops import ideal_lpf as TL
from test_torch_harness import load_port, nchw, nhwc, numpy_init, rand

torch.set_num_threads(1)

MAX_ERR = 2e-5
RMS_RATIO = 0.25


@pytest.fixture
def level():
    """Resets both packages to 'highest' after the test."""
    yield
    TL.set_af_precision("highest")
    jax_set_af_precision("highest")


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def assert_level_close(got, want, want_exact, max_err=MAX_ERR):
    """RMS(got - want) <= RMS_RATIO × RMS(want - want_exact), max |got -
    want| <= max_err."""
    own = _rms(np.asarray(want) - np.asarray(want_exact))
    assert own > 0, "the level changed nothing"
    err = np.asarray(got) - np.asarray(want)
    assert _rms(err) <= RMS_RATIO * own, (_rms(err), own)
    assert float(np.abs(err).max()) <= max_err, float(np.abs(err).max())


def _jax_at(level, x, g, mode):
    """JAX's Pallas kernel (interpret mode) at ``level``: (out, dx). A new
    jitted function per level: the kernels read the level at trace time."""
    jax_set_af_precision(level)
    try:
        f = jax.jit(lambda v, _level=level: filtered_act_pallas(v, "silu",
                                                                mode))
        out, vjp = jax.vjp(f, jnp.asarray(x))
        return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])
    finally:
        jax_set_af_precision("highest")


# (NHWC shape, JAX mode): K5/K5b at 8 and 4 px, K1/K2 at 96 px
JAX_CASES = [((2, 8, 8, 128), "channel"), ((2, 4, 4, 64), "channel"),
             ((1, 96, 96, 2), "spatial")]


@pytest.mark.parametrize("shape,mode", JAX_CASES,
                         ids=["k5-8px", "k5-4px", "k1-96px"])
def test_plain_versions_at_high_match_pallas(level, shape, mode):
    """K5 (channel) or K1 (spatial) forward, and K5b or K2 through
    ``jax.vjp``, plain version at 'high' against the Pallas kernel at
    'high'."""
    rng = np.random.default_rng(0)
    x, g = rand(rng, shape), rand(rng, shape)
    want, want_dx = _jax_at("high", x, g, mode)
    exact, exact_dx = _jax_at("highest", x, g, mode)
    fwd, bwd = ((TF.filtered_act_plane_plain, TF.filtered_act_plane_bwd_plain)
                if mode == "channel" else
                (TF.filtered_act_banded_plain,
                 TF.filtered_act_banded_bwd_plain))
    def max_err(w, e):
        return MAX_ERR if mode == "channel" else float(np.abs(w - e).max())
    got = nhwc(fwd(nchw(x), "silu", "high"))
    assert_level_close(got, want, exact, max_err(want, exact))
    got_dx = nhwc(bwd(nchw(x), nchw(g), "silu", "high"))
    assert_level_close(got_dx, want_dx, exact_dx, max_err(want_dx, exact_dx))


# -- numpy emulation of the split --------------------------------------------

def _np_split(a):
    hi = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return hi, (a - hi).astype(ml_dtypes.bfloat16).astype(np.float32)


def _np_mm(a, b, level, exact=True):
    """a @ b at ``level`` in numpy: the bf16 pieces of both, summed in
    float64 and rounded once (``exact``) or in float32."""
    if level == "highest":
        return (a.astype(np.float64) @ b.astype(np.float64)).astype(
            np.float32)
    dt = np.float64 if exact else np.float32
    (ah, al), (bh, bl) = _np_split(a), _np_split(b)
    ah, al, bh, bl = (t.astype(dt) for t in (ah, al, bh, bl))
    out = ah @ bh
    if level == "high":
        out = out + ah @ bl + al @ bh
    return out.astype(np.float32)


def _np_ops(H, W):
    uh, uw = TL._upsample_op(H, 2), TL._upsample_op(W, 2)
    dh, dw = TL._downsample_op(2 * H, 2), TL._downsample_op(2 * W, 2)
    return uh, uw, dh, dw


def _np_silu(v):
    return v / (1.0 + np.exp(-v.astype(np.float64))).astype(np.float32)


def _np_silu_grad(v):
    s = 1.0 / (1.0 + np.exp(-v.astype(np.float64)))
    return (s * (1 + v * (1 - s))).astype(np.float32)


def np_forward(x, level, kernel):
    """K5's (``_forward``: down W then H) or K1's (``_forward_spatial``:
    down H then W) chain in numpy, NCHW."""
    uh, uw, dh, dw = _np_ops(*x.shape[-2:])
    hi = _np_silu(_np_mm(_np_mm(uh, x, level), uw.T, level))
    if kernel == "k5":
        return _np_mm(dh, _np_mm(hi, dw.T, level), level)
    return _np_mm(_np_mm(dh, hi, level), dw.T, level)


def np_backward(x, g, level, kernel):
    """K5b's (``_bwd_rule``: dx W side first) or K2's (``_bwd_spatial``)
    VJP in numpy, NCHW."""
    uh, uw, dh, dw = _np_ops(*x.shape[-2:])
    pre = _np_mm(_np_mm(uh, x, level), uw.T, level)
    gu = _np_mm(_np_mm(dh.T, g, level), dw, level)
    m = _np_silu_grad(pre) * gu
    if kernel == "k5b":
        return _np_mm(uh.T, _np_mm(m, uw, level), level)
    return _np_mm(_np_mm(uh.T, m, level), uw, level)


# the share of the output's RMS by which each level moves it from 'highest'
LEVEL_MAGNITUDE = {"high": (1e-7, 1e-4), "default": (1e-4, 3e-2)}


@pytest.mark.parametrize("lev", ["high", "default"])
@pytest.mark.parametrize("kernel", ["k5", "k1", "k5b", "k2"])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 2, 12, 20)])
def test_plain_versions_match_numpy_emulation(lev, kernel, shape):
    rng = np.random.default_rng(1)
    x, g = rand(rng, shape), rand(rng, shape)
    if kernel in ("k5", "k1"):
        fn = (TF.filtered_act_plane_plain if kernel == "k5"
              else TF.filtered_act_banded_plain)
        got = fn(torch.from_numpy(x), "silu", lev).numpy()
        want, exact = (np_forward(x, lv, kernel) for lv in (lev, "highest"))
    else:
        fn = (TF.filtered_act_plane_bwd_plain if kernel == "k5b"
              else TF.filtered_act_banded_bwd_plain)
        got = fn(torch.from_numpy(x), torch.from_numpy(g), "silu",
                 lev).numpy()
        want, exact = (np_backward(x, g, lv, kernel)
                       for lv in (lev, "highest"))
    own = np.abs(want - exact)
    assert_level_close(got, want, exact, max_err=float(own.max()))
    lo, hi = LEVEL_MAGNITUDE[lev]
    assert lo < _rms(want - exact) / _rms(exact) < hi


@pytest.mark.parametrize("lev", ["high", "default"])
@pytest.mark.parametrize("op", ["up", "down"])
def test_apply_sep_at_level_matches_numpy_emulation(level, lev, op):
    """``upsample_rfft`` / ``downsample_rfft`` (impl "matmul") at the
    level: ``_apply_sep``'s products in float32, H side first, against the
    numpy emulation summed in float32; the backward (the transposed chain
    at the level, W side first) likewise."""
    rng = np.random.default_rng(2)
    x = rand(rng, (2, 3, 16, 16))
    fn = TL.upsample_rfft if op == "up" else TL.downsample_rfft
    build = TL._upsample_op if op == "up" else TL._downsample_op
    A = build(16, 2)
    g = rand(rng, (2, 3) + (A.shape[0],) * 2)
    TL.set_af_precision(lev)
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt, 2)
    out.backward(torch.from_numpy(g))
    want = _np_mm(_np_mm(A, x, lev, exact=False), A.T, lev, exact=False)
    exact = _np_mm(_np_mm(A, x, "highest"), A.T, "highest")
    tol = 4 * float(np.abs(want - exact).max())
    assert_level_close(out.detach().numpy(), want, exact, max_err=tol)
    want_dx = _np_mm(A.T, _np_mm(g, A, lev, exact=False), lev, exact=False)
    exact_dx = _np_mm(A.T, _np_mm(g, A, "highest"), "highest")
    assert_level_close(xt.grad.numpy(), want_dx, exact_dx,
                       max_err=4 * float(np.abs(want_dx - exact_dx).max()))
    lo, hi = LEVEL_MAGNITUDE[lev]
    assert lo < _rms(want - exact) / _rms(exact) < hi


def test_split_bf16_rounds_to_nearest_even():
    """``split_bf16`` against ml_dtypes' casts, ties included."""
    rng = np.random.default_rng(3)
    a = np.concatenate([rand(rng, (1000,)) * 10.0 ** rng.integers(-3, 3),
                        # exact ties between two bf16 values
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                    -(1 + 2 ** -8)])]).astype(np.float32)
    hi, lo = TL.split_bf16(torch.from_numpy(a))
    want_hi, want_lo = _np_split(a)
    np.testing.assert_array_equal(hi.float().numpy(), want_hi)
    np.testing.assert_array_equal(lo.float().numpy(), want_lo)


# -- the slice as a whole -----------------------------------------------------

@pytest.fixture(scope="module")
def protocol():
    """The tiny FFHQ pipeline of the port with numpy-drawn weights, the
    initial latent, and JAX's protocol on the same weights at 'highest'."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu.pipelines import LDMPipeline as JPipe
    from afldm_tpu.pipelines import shift_equivariance_eval as jeval
    from afldm_tpu.schedulers import DDIMScheduler as JDDIM
    from afldm_tpu_torch import models as tm
    from afldm_tpu_torch.pipelines import LDMPipeline as TPipe
    from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    ju = UNet2DModel(UNet2DConfig.from_diffusers(ucfg, alias_free=True))
    jv = AutoencoderKL(AutoencoderKLConfig.from_diffusers(vcfg))
    up = numpy_init(ju, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32))
    vp = numpy_init(jv, jnp.zeros((1, 64, 64, 3)), seed=1)
    tu = load_port(tm.UNet2DModel(
        tm.UNet2DConfig.from_diffusers(ucfg, alias_free=True)), up)
    tv = load_port(tm.AutoencoderKL(
        tm.AutoencoderKLConfig.from_diffusers(vcfg)), vp)
    lat = rand(np.random.default_rng(15), (1, 8, 8, 4))
    want = jeval(JPipe(jv, vp, ju, up, JDDIM.from_config(scfg)),
                 init_latent=jnp.asarray(lat), num_inference_steps=2,
                 num_shift_steps=2)
    return TPipe(tv, tu, TDDIM.from_config(scfg)), lat, want


@pytest.mark.parametrize("lev,limit", [("high", 0.01), ("default", 0.1)])
def test_tiny_protocol_at_level_matches_jax(protocol, level, lev, limit):
    from afldm_tpu_torch.pipelines import shift_equivariance_eval as teval
    tp, lat, want = protocol
    exact = teval(tp, init_latent=nchw(lat), num_inference_steps=2,
                  num_shift_steps=2)
    np.testing.assert_allclose(exact.psnrs, want.psnrs, atol=0.01)
    TL.set_af_precision(lev)
    got = teval(tp, init_latent=nchw(lat), num_inference_steps=2,
                num_shift_steps=2)
    assert np.isfinite(got.psnrs).all()
    np.testing.assert_allclose(got.psnrs, want.psnrs, atol=limit)
    assert not np.array_equal(got.outputs, exact.outputs)


# -- the level through the entry points ----------------------------------------

def test_load_pipeline_keeps_or_sets_the_level(tmp_path, level):
    from afldm_tpu_torch.pipelines import load_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, _ = load_configs(tiny=True)
    (tmp_path / "unet_config.json").write_text(json.dumps(ucfg))
    (tmp_path / "vae_config.json").write_text(json.dumps(vcfg))
    TL.set_af_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    load_pipeline(str(tmp_path), device="cpu", allow_random=True)
    assert TL.af_precision() == "high"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    load_pipeline(str(tmp_path), device="cpu", allow_random=True,
                  af_precision="default")
    assert TL.af_precision() == "default"


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 2, 96, 96)],
                         ids=["plane", "banded"])
def test_backward_keeps_the_forward_level(level, shape):
    """The autograd Functions run the backward at the level of their
    forward, as one JAX trace does, even after the level changed."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rand(rng, shape)).requires_grad_()
    g = torch.from_numpy(rand(rng, shape))
    TL.set_af_precision("high")
    out = TF.filtered_act_fused(x, "silu")
    TL.set_af_precision("highest")
    out.backward(g)
    bwd = (TF.filtered_act_plane_bwd_plain if shape[-1] <= TF.PLANE_MAX
           else TF.filtered_act_banded_bwd_plain)
    want = bwd(x.detach(), g, "silu", "high")
    torch.testing.assert_close(x.grad, want, atol=0, rtol=0)
    assert not torch.equal(x.grad, bwd(x.detach(), g, "silu", "highest"))


def test_eval_af_precision_cli_writes_the_jax_keys(tmp_path, level):
    from afldm_tpu_torch.scripts import eval_af_precision
    out = tmp_path / "afp.json"
    rows = eval_af_precision.main([
        "--tiny", "--device", "cpu", "--eval_steps", "1", "--shift_steps",
        "2", "--precisions", "high,default", "--out", str(out)])
    assert json.loads(out.read_text()) == rows
    assert set(rows) == {"highest", "high", "default",
                         "high_minus_highest_db",
                         "default_minus_highest_db", "within_0p1_db",
                         "eval_steps", "shift_steps"}
    for lev in ("highest", "high", "default"):
        assert set(rows[lev]) == {"mean_masked_psnr", "psnrs"}
        assert len(rows[lev]["psnrs"]) == 2
    assert rows["within_0p1_db"] is (abs(rows["high_minus_highest_db"])
                                     <= 0.1)
    assert TL.af_precision() == "highest"


def test_shift_cli_takes_the_level(level, capsys):
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import main
    res = main(["--tiny", "--device", "cpu", "--num_inference_steps", "1",
                "--shift_steps", "1", "--af_precision", "default"])
    assert TL.af_precision() == "default"
    assert np.isfinite(res.psnrs).all()


# -- the bf16 variants' layouts, as the CUDA kernels read them ----------------

@pytest.mark.parametrize("bwd", [False, True], ids=["k5", "k5b"])
@pytest.mark.parametrize("nplanes", [1, 7, 192, 24576])
def test_plane_mma_plan_fits_every_plane_size(bwd, nplanes):
    """Every H, W % 4 == 0 up to 64 px gets a plan within the block's
    shared memory, at both levels and both x dtypes: 1 <= P an iteration
    <= the planes, a persistent grid of at most the blocks an SM holds (by
    shared memory and the level's registers) × the SMs, and never more
    blocks than groups. K5 (``plane_mma_plan``, filtered_plane_mma.cu::
    MmaPlaneLayout) at five widths; K5b (``plane_mma_bwd_plan``,
    MmaPlaneBwdLayout) at every width, its shared bytes the layout's count
    for the plan's operators, resident or phased."""
    widths = range(4, TF.PLANE_MAX + 1, 4) if bwd else (4, 12, 20, 32, 64)
    for H, W in itertools.product(range(4, TF.PLANE_MAX + 1, 4), widths):
        for lev, x_bytes in itertools.product(("high", "default"), (4, 2)):
            if bwd:
                plan = TF.plane_mma_bwd_plan(H, W, nplanes, lev, x_bytes)
                smem = TF.plane_mma_bwd_smem_bytes(
                    H, W, plan.planes, lev, x_bytes, plan.resident)
            else:
                plan = TF.plane_mma_plan(H, W, nplanes, lev, x_bytes)
                smem = TF.plane_mma_smem_bytes(H, W, plan.planes, lev,
                                               x_bytes)
            assert 1 <= plan.planes <= nplanes
            assert plan.smem_bytes == smem <= TF.SMEM_MAX_BYTES
            held = TF.SMEM_SM_BYTES // (plan.smem_bytes
                                        + TF.SMEM_BLOCK_RESERVED)
            assert plan.per_sm == min(held, TF.K5_MMA_BLOCKS[lev]) >= 1
            groups = -(-nplanes // plan.planes)
            assert plan.grid == min(groups, plan.per_sm * TF.NUM_SMS)


@pytest.mark.parametrize("H, W", [(64, 64), (32, 32), (4, 4), (12, 20),
                                  (4, 64), (64, 4)])
def test_plane_mma_default_layout_holds_hi_pieces_only(H, W):
    """K5's block at 'default' holds one bf16 piece of every operand (the
    first half of each ``_mma_blobs`` blob, x's, t's) where 'high' holds
    two, beside the same raw x. At 64 px that
    halves the block to two an SM (an f32 x: 115,712 bytes, 'high'
    215,040)."""
    raw = H * W * 4
    high = TF.plane_mma_smem_bytes(H, W, 1, "high")
    default = TF.plane_mma_smem_bytes(H, W, 1, "default")
    pieces = (TF.mma_piece(H, 2 * H) + TF.mma_piece(W, 2 * W)
              + TF.mma_piece(2 * W, W) + TF.mma_piece(2 * H, H)
              + TF.mma_piece(H, W) + TF.mma_piece(2 * H, W))
    assert default - raw == 2 * pieces
    assert high - raw == 2 * (default - raw)
    blobs = TF._mma_blobs(H, W, "cpu", False)
    assert sum(b[0].numel() for b in blobs) == pieces - TF.mma_piece(
        H, W) - TF.mma_piece(2 * H, W)
    if (H, W) == (64, 64):
        assert (high, default) == (215040, 115712)
        assert default <= TF.SMEM_TWO_BLOCKS_BYTES
        assert TF.plane_mma_plan(H, W, 8192, "default").per_sm == 2


@pytest.mark.parametrize("H, W", [(64, 64), (32, 32), (4, 4), (12, 20),
                                  (4, 64), (64, 4)])
def test_plane_mma_bwd_default_layout_holds_hi_pieces_only(H, W):
    """K5b's block at 'default' holds one bf16 piece of every operand (the
    first half of each ``_mma_blobs`` blob, x's, g's, t's and v's) where
    'high' holds two, beside the same raw x and g: the resident block's
    pieces halve, and so does a phased block's operator region. At 64 px
    the phased 'default' block runs two an SM (an f32 x: 108,544 bytes,
    'high' 217,088), where the six operators' 106,496 bytes of hi pieces
    alone leave no room for a second resident block."""
    raw = 2 * H * W * 4
    high, default = (TF.plane_mma_bwd_smem_bytes(H, W, 1, lev)
                     for lev in ("high", "default"))
    ops = (2 * TF.mma_piece(H, 2 * H) + 2 * TF.mma_piece(W, 2 * W)
           + TF.mma_piece(2 * W, W) + TF.mma_piece(2 * H, H))
    pieces = ops + 2 * TF.mma_piece(H, W) + 2 * TF.mma_piece(2 * H, W)
    assert default - raw == 2 * pieces
    assert high - raw == 2 * (default - raw)
    blobs = TF._mma_blobs(H, W, "cpu", True)
    assert sum(b[0].numel() for b in blobs) == ops
    high, default = (TF.plane_mma_bwd_smem_bytes(H, W, 1, lev,
                                                 resident=False)
                     for lev in ("high", "default"))
    planes = 2 * (TF.mma_piece(H, W) + TF.mma_piece(2 * H, W))
    for k, got in ((2, high), (1, default)):  # pieces an operand
        assert got == 2 * (k * planes + max(
            2 * k * TF.mma_piece(H, 2 * H),
            k * (2 * TF.mma_piece(W, 2 * W) + TF.mma_piece(2 * W, W)),
            k * TF.mma_piece(2 * H, H) + raw // 2))
    if (H, W) == (64, 64):
        assert (high, default) == (217088, 108544)
        assert 2 * ops == 106496
        assert default <= TF.SMEM_TWO_BLOCKS_BYTES
        assert TF.plane_mma_bwd_plan(H, W, 8192, "default").per_sm == 2
        assert not TF.plane_mma_bwd_plan(H, W, 8192, "high").resident


def test_mma_blob_is_the_padded_split():
    """An operator's blob: (hi, lo) of ``split_bf16`` in rows padded to 16
    and a row stride of pad16 + 8 (an odd multiple of 16 bytes), zeros
    around; hi + lo recovers the operator to ~2^-17 of its scale."""
    op = TL._upsample_op(12, 2).T.copy()  # 12 x 24
    blob = TF._mma_blob(op)
    assert blob.dtype == torch.bfloat16
    assert tuple(blob.shape) == (2, 16, 40) and (40 * 2 // 16) % 2 == 1
    hi, lo = TL.split_bf16(torch.from_numpy(op))
    assert torch.equal(blob[0, :12, :24], hi)
    assert torch.equal(blob[1, :12, :24], lo)
    assert not blob[:, 12:].any() and not blob[:, :, 24:].any()
    back = (blob[0, :12, :24].float() + blob[1, :12, :24].float()).numpy()
    assert np.abs(back - op).max() <= 2 ** -16 * np.abs(op).max()


@pytest.mark.parametrize("lev", ["high", "default"])
def test_gemm_plain_at_level(lev):
    """``filtered_gemm`` on the CPU at a level is its plain version at that
    level, A row-major or k-major, with the act′ ⊙ epilogue."""
    rng = np.random.default_rng(5)
    a, b, pre = (torch.from_numpy(rand(rng, s))
                 for s in ((2, 12, 20), (2, 20, 8), (2, 12, 8)))
    got = TF.filtered_gemm(a, b, "gelu", level=lev)
    want = _np_mm(a.numpy(), b.numpy(), lev)
    want = want * 0.5 * (1 + np.tanh(0.7978845608028654 * (
        want + 0.044715 * want ** 3)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    kmajor = TF.filtered_gemm(a.transpose(1, 2).contiguous(), b, "silu",
                              a_kmajor=True, grad_at=pre, level=lev)
    np.testing.assert_allclose(
        kmajor.numpy(), _np_silu_grad(pre.numpy())
        * _np_mm(a.numpy(), b.numpy(), lev), atol=1e-6, rtol=1e-5)
