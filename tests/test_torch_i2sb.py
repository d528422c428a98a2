"""The latent-I2SB super-resolution slice against the JAX package: the
I2SB scheduler, the SR degradation operators, ``degrade_sr4x``, the tiny
``I2SBLDMPipeline`` and the tiny SR shift protocol with the same weights
and inputs on both sides, and the port's CLI.

Tolerances: scheduler and SR operators 1e-6 absolute, every pixel
compared, the borders (where the symmetric reflection folds taps back)
included; the tiny pipeline and protocol 1e-4 of the image scale and 0.01
dB per shift (rounding compounds over the encode, the UNet passes and the
decodes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops import superresolution as JSR
from afldm_tpu.schedulers import I2SBScheduler as JI2SB
from afldm_tpu.train.i2sb_trainer import degrade_sr4x as j_degrade
from afldm_tpu_torch.ops import superresolution as TSR
from afldm_tpu_torch.schedulers import I2SBScheduler as TI2SB
from afldm_tpu_torch.train.i2sb_trainer import degrade_sr4x as t_degrade
from test_torch_harness import (assert_rel_close, load_port, nchw, nhwc,
                                numpy_init, rand, tt)

torch.set_num_threads(1)

ATOL = 1e-6
SR_CFG = dict(num_train_timesteps=1000, beta_schedule="linear",
              beta_start=0.0001, beta_end=0.02, clip_sample=False,
              timestep_spacing="leading")


# -- scheduler ------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [SR_CFG,
                                 dict(SR_CFG, beta_schedule="scaled_linear",
                                      rescale_betas_zero_snr=True)])
def test_i2sb_tables(cfg):
    j, t = JI2SB(**cfg), TI2SB(**cfg)
    for name in ("betas", "std_fwd", "std_bwd", "std_sb", "mu_x0", "mu_x1"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   atol=ATOL, err_msg=name)
        assert getattr(t, name).dtype == getattr(j, name).dtype


@pytest.mark.parametrize("kw", [dict(num_inference_steps=50),
                                dict(num_inference_steps=3),
                                dict(timesteps=[999, 500, 120, 0])])
@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_i2sb_set_timesteps(kw, spacing):
    cfg = dict(SR_CFG, timestep_spacing=spacing)
    np.testing.assert_array_equal(TI2SB(**cfg).set_timesteps(**kw),
                                  JI2SB(**cfg).set_timesteps(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(num_inference_steps=2,
                                             timesteps=[5, 1]),
                                dict(timesteps=[1, 5]),
                                dict(timesteps=[1000, 5])])
def test_i2sb_set_timesteps_rejects(kw):
    with pytest.raises(ValueError):
        TI2SB(**SR_CFG).set_timesteps(**kw)


@pytest.mark.parametrize("t,pt", [(980, 960), (500, 0), (20, -1), (0, -1)])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("ode", [True, False])
def test_i2sb_step(rng, t, pt, clip, ode):
    cfg = dict(SR_CFG, clip_sample=clip)
    eps, x, noise = (rand(rng, (2, 4, 4, 3)) for _ in range(3))
    import jax
    key = jax.random.PRNGKey(7)
    wp, wx0 = JI2SB(**cfg).step(jnp.asarray(eps), t, pt, jnp.asarray(x),
                                is_ode=ode, key=None if ode else key)
    if not ode:  # the JAX step's noise, handed to the port
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    gp, gx0 = TI2SB(**cfg).step(tt(eps), t, pt, tt(x), is_ode=ode,
                                noise=None if ode else tt(noise))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=ATOL)
    np.testing.assert_allclose(gx0.numpy(), np.asarray(wx0), atol=ATOL)


@pytest.mark.parametrize("ode", [True, False])
def test_i2sb_add_noise_and_label(rng, ode):
    x0, x1, noise = (rand(rng, (3, 4, 4, 2)) for _ in range(3))
    ts = np.asarray([0, 417, 999])
    j, t = JI2SB(**SR_CFG), TI2SB(**SR_CFG)
    want = j.add_noise(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(ts),
                       is_ode=ode, noise=jnp.asarray(noise))
    got = t.add_noise(tt(x0), tt(x1), ts, is_ode=ode, noise=tt(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the label divides by std_fwd (0.01 at t = 0): compared on one xt
    np.testing.assert_allclose(
        t.compute_label(ts, tt(x0), tt(want)).numpy(),
        np.asarray(j.compute_label(jnp.asarray(ts), jnp.asarray(x0), want)),
        rtol=1e-6, atol=ATOL)


# -- SR operators -------------------------------------------------------------------

def test_bicubic_taps():
    np.testing.assert_array_equal(TSR.bicubic_kernel_1d(4),
                                  JSR.bicubic_kernel_1d(4))


@pytest.mark.parametrize("n", [16, 32])
def test_srconv_operators(rng, n):
    j = JSR.build_sr_bicubic(4, n)
    t = TSR.build_sr_bicubic(4, n)
    x = rand(rng, (2, n, n, 3))
    y = rand(rng, (2, n // 4, n // 4, 3))
    np.testing.assert_allclose(t._conv_matrix(), j._conv_matrix(), atol=0)
    for name, arg in (("H", x), ("Ht", y), ("H_pinv", y)):
        want = np.asarray(getattr(j, name)(jnp.asarray(arg)))
        got = nhwc(getattr(t, name)(nchw(arg)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
        # the border rows and columns, where the reflection folds taps
        for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
            assert np.isfinite(edge).all()
    np.testing.assert_allclose(
        np.asarray(j.H(jnp.asarray(x)))[:, [0, -1]],
        nhwc(t.H(nchw(x)))[:, [0, -1]], atol=ATOL)


def test_pool_operators(rng):
    j, t = JSR.build_sr_pool(4, 16), TSR.build_sr_pool(4, 16)
    x, y = rand(rng, (2, 16, 16, 3)), rand(rng, (2, 4, 4, 3))
    for name, arg in (("H", x), ("Ht", y), ("H_pinv", y)):
        np.testing.assert_allclose(nhwc(getattr(t, name)(nchw(arg))),
                                   np.asarray(getattr(j, name)(
                                       jnp.asarray(arg))),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("sr_filter", ["bicubic", "pool"])
def test_degrade_sr4x(rng, sr_filter):
    x = rand(rng, (2, 32, 32, 3))
    want = np.asarray(j_degrade(jnp.asarray(x), sr_filter))
    got = nhwc(t_degrade(nchw(x), sr_filter))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_build_sr4x_rejects_unknown_filter():
    with pytest.raises(ValueError):
        TSR.build_sr4x("nearest", 16)


# -- the slice as a whole ------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    """The tiny SR pipeline of the CLI on both sides with the same
    weights."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu.pipelines import I2SBLDMPipeline as JPipe
    from afldm_tpu_torch import models as tm
    from afldm_tpu_torch.pipelines import I2SBLDMPipeline as TPipe
    from afldm_tpu_torch.scripts.shift_ldm_sr import i2sb_scheduler_config
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, _ = load_configs(tiny=True)
    scfg = i2sb_scheduler_config()
    ju = UNet2DModel(UNet2DConfig.from_diffusers(ucfg, alias_free=True))
    jv = AutoencoderKL(AutoencoderKLConfig.from_diffusers(vcfg))
    up = numpy_init(ju, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32))
    vp = numpy_init(jv, jnp.zeros((1, 64, 64, 3)), seed=1)
    jpipe = JPipe(jv, vp, ju, up, JI2SB.from_config(scfg))
    tu = load_port(tm.UNet2DModel(
        tm.UNet2DConfig.from_diffusers(ucfg, alias_free=True)), up)
    tv = load_port(tm.AutoencoderKL(
        tm.AutoencoderKLConfig.from_diffusers(vcfg)), vp)
    return jpipe, TPipe(tv, tu, TI2SB.from_config(scfg))


def _lq_image(seed):
    img = np.tanh(rand(np.random.default_rng(seed), (1, 64, 64, 3)))
    return np.asarray(j_degrade(jnp.asarray(img)))


def test_i2sb_pipeline_call_matches_jax(pipelines):
    jp, tp = pipelines
    lq = _lq_image(21)
    want = jp(jnp.asarray(lq), num_inference_steps=3)
    got = tp(nchw(lq), num_inference_steps=3)
    assert got.shape == (1, 64, 64, 3)
    assert_rel_close(got, want, 1e-4, "images")


def test_i2sb_sr_shift_protocol_matches_jax(pipelines):
    from afldm_tpu.pipelines import shift_equivariance_eval as jeval
    from afldm_tpu_torch.pipelines import shift_equivariance_eval as teval
    jp, tp = pipelines
    lq = _lq_image(22)
    want = jeval(jp, init_latent=jp.encode(jnp.asarray(lq)),
                 num_inference_steps=3, num_shift_steps=2)
    got = teval(tp, init_latent=tp.encode(nchw(lq)), num_inference_steps=3,
                num_shift_steps=2)
    assert got.psnrs.shape == (2,) and np.isfinite(got.psnrs).all()
    np.testing.assert_allclose(got.psnrs, want.psnrs, atol=0.01)
    for name in ("outputs", "targets"):
        assert_rel_close(getattr(got, name), getattr(want, name), 1e-4, name)


def test_i2sb_pipeline_skips_the_final_step(pipelines):
    _, tp = pipelines
    ts, ts_prev = tp._schedule(3)
    assert ts == [666, 333] and ts_prev == [333, 0]
    _, traj = tp.denoise(torch.zeros(1, 4, 8, 8), 3, collect_kv=True)
    assert len(traj) == 2


def test_i2sb_pipeline_has_no_interp_mode(pipelines):
    _, tp = pipelines
    lat = torch.zeros(1, 4, 8, 8)
    _, traj = tp.denoise(lat, 2, collect_kv=True)
    with pytest.raises(ValueError, match="interp"):
        tp.denoise(lat, 2, kv_traj=traj, kv_traj2=traj, alpha=0.5)


def test_cli_tiny_cpu(capsys, tmp_path):
    from afldm_tpu_torch.scripts.shift_ldm_sr import main
    out = tmp_path / "sr.npy"
    res = main(["--tiny", "--device", "cpu", "--num_inference_steps", "2",
                "--shift_steps", "2", "--output_path", str(out)])
    text = capsys.readouterr().out
    assert "shift 1/8 px: masked PSNR" in text
    assert "mean shift-equivariance PSNR" in text
    assert np.isfinite(res.psnrs).all()
    frames = np.load(out)
    assert frames.shape == (2, 192, 64, 3)
    assert frames.min() >= 0 and frames.max() <= 1
