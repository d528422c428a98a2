"""The port's scheduler, shift utilities and pipelines against the JAX
package, ending with the slice as a whole: ``shift_equivariance_eval`` on
the tiny pipeline (2 steps, 2 shifts) with the same weights and the same
initial latent on both sides.

Tolerances: scheduler and shift ops 1e-5 absolute (f32 elementwise
rounding); the whole tiny protocol 1e-4 relative on the images (rounding
compounds over 3 UNet passes and 2 decodes) and 0.01 dB on each PSNR.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.schedulers import DDIMScheduler as JDDIM
from afldm_tpu.shift import metrics as JM
from afldm_tpu.shift import flow as JF
from afldm_tpu.shift import shifters as JS
from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
from afldm_tpu_torch.shift import flow as TF
from afldm_tpu_torch.shift import metrics as TM
from afldm_tpu_torch.shift import shifters as TS
from test_torch_harness import (assert_rel_close, jax_init, load_port, nchw,
                                nhwc, rand, tt)

torch.set_num_threads(1)

ATOL = 1e-5
FFHQ_DDIM = dict(beta_end=0.0195, beta_schedule="scaled_linear",
                 beta_start=0.0015, clip_sample=False,
                 num_train_timesteps=1000, set_alpha_to_one=False,
                 steps_offset=1, timestep_spacing="leading")


# -- DDIM ---------------------------------------------------------------------

@pytest.mark.parametrize("steps", [2, 50, 1000])
@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_ddim_timesteps(steps, spacing):
    cfg = dict(FFHQ_DDIM, timestep_spacing=spacing)
    np.testing.assert_array_equal(TDDIM(**cfg).set_timesteps(steps),
                                  JDDIM(**cfg).set_timesteps(steps))


@pytest.mark.parametrize("t,pt", [(981, 961), (21, 1), (1, -19)])
@pytest.mark.parametrize("clip", [False, True])
def test_ddim_step(rng, t, pt, clip):
    cfg = dict(FFHQ_DDIM, clip_sample=clip)
    eps, x = rand(rng, (2, 4, 4, 3)), rand(rng, (2, 4, 4, 3))
    wp, wx0 = JDDIM(**cfg).step(jnp.asarray(eps), t, jnp.asarray(x),
                                prev_timestep=pt)
    gp, gx0 = TDDIM(**cfg).step(tt(eps), t, tt(x), prev_timestep=pt)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=ATOL)
    np.testing.assert_allclose(gx0.numpy(), np.asarray(wx0), atol=ATOL)


def test_ddim_step_derives_prev_timestep(rng):
    eps, x = rand(rng, (1, 4, 4, 2)), rand(rng, (1, 4, 4, 2))
    j, t = JDDIM(**FFHQ_DDIM), TDDIM(**FFHQ_DDIM)
    j.set_timesteps(50)
    t.set_timesteps(50)
    np.testing.assert_allclose(
        t.step(tt(eps), 501, tt(x))[0].numpy(),
        np.asarray(j.step(jnp.asarray(eps), 501, jnp.asarray(x))[0]),
        atol=ATOL)


@pytest.mark.parametrize("tp,t", [(-1, 1), (481, 501)])
def test_ddim_inversion_step(rng, tp, t):
    eps, x = rand(rng, (1, 4, 4, 2)), rand(rng, (1, 4, 4, 2))
    want = JDDIM(**FFHQ_DDIM).inversion_step(jnp.asarray(eps), tp, t,
                                             jnp.asarray(x))
    got = TDDIM(**FFHQ_DDIM).inversion_step(tt(eps), tp, t, tt(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ddim_add_noise(rng):
    x0, n = rand(rng, (2, 4, 4, 2)), rand(rng, (2, 4, 4, 2))
    ts = np.asarray([10, 900])
    want = JDDIM(**FFHQ_DDIM).add_noise(jnp.asarray(x0), jnp.asarray(n),
                                        jnp.asarray(ts))
    got = TDDIM(**FFHQ_DDIM).add_noise(tt(x0), tt(n), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# -- shift utilities ------------------------------------------------------------

@pytest.mark.parametrize("ti,tj", [(0.0, 1.0), (0.0, 0.375), (-2.5, 1.25),
                                   (3.0, -0.5)])
def test_gen_valid_mask(ti, tj):
    want = JS.gen_valid_mask((1, 8, 10, 1), ti, tj)
    got = TS.gen_valid_mask((1, 1, 8, 10), ti, tj)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("ti,tj", [(0.0, 0.125), (0.0, 0.5), (0.25, -0.75)])
def test_ideal_crop_shifter(rng, ti, tj):
    x = rand(rng, (1, 8, 8, 4))
    js, ts = JS.ImageShifter("ideal_crop", 8), TS.ImageShifter("ideal_crop", 8)
    wx, wm = js.shift(jnp.asarray(x), ti, tj)
    gx, gm = ts.shift(nchw(x), ti, tj, cache=ts.precompute(nchw(x)))
    np.testing.assert_allclose(nhwc(gx), np.asarray(wx), atol=ATOL)
    np.testing.assert_array_equal(nhwc(gm), np.asarray(wm))


@pytest.mark.parametrize("ti,tj", [(0.0, 1.0), (0.0, 3.0), (1.5, -2.25)])
def test_bilinear_shifter(rng, ti, tj):
    x = rand(rng, (2, 12, 10, 3))
    wx, wm = JS.ImageShifter().shift(jnp.asarray(x), ti, tj)
    gx, gm = TS.ImageShifter().shift(nchw(x), ti, tj)
    np.testing.assert_allclose(nhwc(gx), np.asarray(wx), atol=ATOL)
    np.testing.assert_array_equal(nhwc(gm), np.asarray(wm))


def test_flow_warp_matches_jax(rng):
    img = rand(rng, (2, 9, 7, 3))
    flow = (rand(rng, (2, 9, 7, 2)) * 3).astype(np.float32)
    wo, wm = JF.flow_warp(jnp.asarray(img), jnp.asarray(flow), True)
    go, gm = TF.flow_warp(nchw(img), nchw(flow), True)
    np.testing.assert_allclose(nhwc(go), np.asarray(wo), atol=ATOL)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(
        TF.coords_grid(2, 9, 7).permute(0, 2, 3, 1).numpy(),
        np.asarray(JF.coords_grid(2, 9, 7)))


def test_mask_metrics(rng):
    a, b = rand(rng, (2, 8, 8, 3)), rand(rng, (2, 8, 8, 3))
    m = (rng.random((2, 8, 8, 1)) > 0.3).astype(np.float32)
    for jf, tf in ((JM.mask_psnr, TM.mask_psnr), (JM.mask_mse, TM.mask_mse)):
        np.testing.assert_allclose(
            float(tf(nchw(a), nchw(b), nchw(m))),
            float(jf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m))),
            rtol=1e-5)
    np.testing.assert_allclose(float(TM.psnr(nchw(a), nchw(b))),
                               float(JM.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)


# -- the slice as a whole -------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    """The tiny FFHQ pipeline on both sides with the same weights."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu.pipelines import LDMPipeline as JPipe
    from afldm_tpu_torch.pipelines import LDMPipeline as TPipe
    from afldm_tpu_torch import models as tm
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    ju = UNet2DModel(UNet2DConfig.from_diffusers(ucfg, alias_free=True))
    jv = AutoencoderKL(AutoencoderKLConfig.from_diffusers(vcfg))
    up = jax_init(ju, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32))
    vp = jax_init(jv, jnp.zeros((1, 64, 64, 3)))
    jpipe = JPipe(jv, vp, ju, up, JDDIM.from_config(scfg))
    tu = load_port(tm.UNet2DModel(
        tm.UNet2DConfig.from_diffusers(ucfg, alias_free=True)), up)
    tv = load_port(tm.AutoencoderKL(
        tm.AutoencoderKLConfig.from_diffusers(vcfg)), vp)
    return jpipe, TPipe(tv, tu, TDDIM.from_config(scfg))


def test_denoise_store_and_load(pipelines):
    jp, tp = pipelines
    lat = rand(np.random.default_rng(11), (1, 8, 8, 4))
    wout, wkv = jp.denoise(jnp.asarray(lat), 2, collect_kv=True)
    gout, gkv = tp.denoise(nchw(lat), 2, collect_kv=True)
    assert_rel_close(nhwc(gout), wout, 1e-4, "STORE latents")
    assert len(gkv) == 2 and len(gkv[0]) == len(wkv)
    shifted = rand(np.random.default_rng(12), (3, 8, 8, 4))
    wl, _ = jp.denoise(jnp.asarray(shifted), 2, kv_traj=wkv)
    gl, none = tp.denoise(nchw(shifted), 2, kv_traj=gkv)
    assert none is None
    assert_rel_close(nhwc(gl), wl, 1e-4, "LOAD latents")


def test_ddim_inversion_and_vae_round_trip(pipelines):
    jp, tp = pipelines
    img = rand(np.random.default_rng(13), (1, 64, 64, 3))
    wz = jp.encode(jnp.asarray(img))
    gz = tp.encode(nchw(img))
    assert_rel_close(nhwc(gz), wz, 1e-4, "encode")
    assert_rel_close(nhwc(tp.ddim_inversion(gz, 2)[0]),
                     jp.ddim_inversion(wz, 2), 1e-4, "inversion")
    assert_rel_close(nhwc(tp.decode(gz)), jp.decode(wz), 1e-4, "decode")


def test_generation_call(pipelines):
    jp, tp = pipelines
    lat = rand(np.random.default_rng(14), (2, 8, 8, 4))
    want = jp(latents=jnp.asarray(lat), num_inference_steps=2)
    got = tp(latents=nchw(lat), num_inference_steps=2)
    assert got.shape == (2, 64, 64, 3)
    assert_rel_close(got, want, 1e-4, "images")


@pytest.mark.parametrize("decode_chunk", [None, 1])
def test_shift_equivariance_eval_matches_jax(pipelines, decode_chunk):
    from afldm_tpu.pipelines import shift_equivariance_eval as jeval
    from afldm_tpu_torch.pipelines import shift_equivariance_eval as teval
    jp, tp = pipelines
    lat = rand(np.random.default_rng(15), (1, 8, 8, 4))
    want = jeval(jp, init_latent=jnp.asarray(lat), num_inference_steps=2,
                 num_shift_steps=2)
    got = teval(tp, init_latent=nchw(lat), num_inference_steps=2,
                num_shift_steps=2, decode_chunk=decode_chunk)
    assert got.psnrs.shape == (2,) and np.isfinite(got.psnrs).all()
    np.testing.assert_allclose(got.psnrs, want.psnrs, atol=0.01)
    for name in ("outputs", "targets"):
        assert_rel_close(getattr(got, name), getattr(want, name), 1e-4, name)
    np.testing.assert_array_equal(got.masks, want.masks)


def test_shift_eval_rejects_batched_input(pipelines):
    from afldm_tpu_torch.pipelines import shift_equivariance_eval
    _, tp = pipelines
    with pytest.raises(ValueError, match="ONE image"):
        shift_equivariance_eval(tp, init_latent=torch.zeros(2, 4, 8, 8),
                                num_inference_steps=1, num_shift_steps=1)


def test_cli_tiny_cpu(capsys):
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import main
    res = main(["--tiny", "--device", "cpu", "--num_inference_steps", "2",
                "--shift_steps", "2"])
    out = capsys.readouterr().out
    assert "shift 1/8 px: masked PSNR" in out
    assert "mean shift-equivariance PSNR" in out
    assert np.isfinite(res.psnrs).all() and res.outputs.shape == (2, 64, 64, 3)
