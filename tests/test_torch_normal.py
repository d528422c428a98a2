"""The port's latent ControlNet, the UNet's residual inputs and the
normal-estimation pipeline against the JAX package: the tiny SD UNet,
ControlNet and AF-VAE of the normal-estimation CLI (64 px) with the same
weights, every one drawn by ``numpy_init`` (the ControlNet's zero-started
convs too, so that its residuals are not all zero), and JAX's own draw of
the multi-step branch's start latent passed in. Tolerances: residuals and
noise predictions within 1e-5 of JAX's; normals within 1e-4 on [0, 1]
(the decoder's [-1, 1] output mapped by x/2 + 0.5) and PSNRs within
0.01 dB. Then the CLI.

The YOSO case alone holds the port against JAX with Flax's two-pass
group-norm variance (``two_pass_group_norm``). Flax's default, E[x²] -
E[x]², cancels on the nearly constant groups that YOSO's zero start
latent gives the UNet's first levels; ``test_yoso_prediction_against_f64``
measures each f32 prediction against the JAX models run in f64 there.
"""

import contextlib

import numpy as np
import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu_torch import models as T
from afldm_tpu_torch.scripts.shift_normal_estimation import (load_configs,
                                                             synthetic_image)
from test_torch_harness import (jax_apply, load_port, nchw, nhwc,
                                numpy_init, rand)

torch.set_num_threads(1)

RES_ATOL = 1e-5      # residuals and noise predictions
NORMAL_ATOL = 1e-4   # normals on [0, 1]
PSNR_ATOL = 0.01     # dB
F32_ATOL = 5e-5      # an f32 prediction against f64 (output scale ~2)


@contextlib.contextmanager
def two_pass_group_norm():
    """Flax's group norm with the two-pass variance while the block runs;
    a JAX function must be traced inside it to take it up."""
    compute_stats = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)
    flax_norm._compute_stats = two_pass
    try:
        yield
    finally:
        flax_norm._compute_stats = compute_stats


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@pytest.fixture(scope="module")
def models():
    """(JAX modules, JAX params, port modules) for UNet, ControlNet and
    VAE, with the port holding the JAX weights."""
    ucfg, vcfg, _ = load_configs(tiny=True)
    ju = J.UNet2DConditionModel(J.UNet2DConditionConfig.from_diffusers(
        _tuples(ucfg), alias_free=True))
    jc = J.ControlNetModel(J.ControlNetConfig.from_unet_config(ju.config))
    jv = J.AutoencoderKL(J.AutoencoderKLConfig.from_diffusers(_tuples(vcfg)))
    lat, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ehs = jnp.zeros((1, 77, 16))
    up = numpy_init(ju, lat, t, ehs, seed=1)
    cp = numpy_init(jc, lat, t, ehs, lat, seed=2)
    vp = numpy_init(jv, jnp.zeros((1, 64, 64, 3)), seed=3)
    tu = T.UNet2DConditionModel(T.UNet2DConditionConfig.from_diffusers(
        ucfg, alias_free=True))
    tc = T.ControlNetModel(T.ControlNetConfig.from_unet_config(tu.config))
    tv = T.AutoencoderKL(T.AutoencoderKLConfig.from_diffusers(vcfg))
    return ((ju, jc, jv), (up, cp, vp),
            (load_port(tu, up), load_port(tc, cp), load_port(tv, vp)))


def _inputs(rng, n=2):
    return (rand(rng, (n, 8, 8, 4)), np.array([999, 421][:n], np.int32),
            rand(rng, (n, 77, 16)), rand(rng, (n, 8, 8, 4)))


@pytest.mark.parametrize("guess_mode,scale", [(False, 1.0), (True, 0.5)])
def test_controlnet_matches_jax(models, rng, guess_mode, scale):
    (_, jc, _), (_, cp, _), (_, tc, _) = models
    x, t, ehs, cond = _inputs(rng)
    wd, wm, wkv = jax.jit(lambda *a: jc.apply(
        *a, conditioning_scale=scale, guess_mode=guess_mode))(cp, x, t, ehs,
                                                              cond)
    gd, gm, gkv = tc(nchw(x), torch.from_numpy(t), torch.from_numpy(ehs),
                     nchw(cond), conditioning_scale=scale,
                     guess_mode=guess_mode)
    assert len(gd) == len(wd) == 4 and len(gkv) == len(wkv) == 2
    for g, w in zip(gd + (gm,), wd + (wm,)):
        assert float(np.abs(np.asarray(w)).max()) > 0.1
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=RES_ATOL)
    for g, w in zip(gkv, wkv):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=RES_ATOL)


def test_unet_residuals_match_jax(models, rng):
    """Residuals added to every skip and to the mid block's output; the
    wrong number of residuals raises."""
    (ju, _, _), (up, _, _), (tu, tc, _) = models
    x, t, ehs, cond = _inputs(rng)
    shapes = [r.shape for r in tc(nchw(x), torch.from_numpy(t),
                                  torch.from_numpy(ehs), nchw(cond))[0]]
    down = [rand(rng, (s[0], s[2], s[3], s[1])) for s in shapes]
    mid = rand(rng, (2, 4, 4, 32))
    want, _ = jax_apply(ju)(up, x, t, ehs, down_block_residuals=tuple(down),
                            mid_block_residual=mid)
    args = (nchw(x), torch.from_numpy(t), torch.from_numpy(ehs))
    got, _ = tu(*args, down_block_residuals=tuple(nchw(d) for d in down),
                mid_block_residual=nchw(mid))
    plain, _ = tu(*args)
    assert float((got - plain).detach().abs().max()) > 0.1
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=RES_ATOL)
    with pytest.raises(ValueError):
        tu(*args, down_block_residuals=tuple(nchw(d) for d in down[:-1]))


def test_controlnet_config_and_zero_start(models):
    """The config carries the UNet's as the JAX one does; a fresh
    ControlNet's residuals are exactly zero (the zero-started convs)."""
    (ju, jc, _), _, (tu, _, _) = models
    cfg = T.ControlNetConfig.from_unet_config(tu.config)
    assert cfg.to_dict() == jc.config.to_dict()
    assert T.ControlNetConfig.from_diffusers(
        {**cfg.to_dict(), "block_out_channels": [16, 32], "x": 1}) == cfg
    assert not T.ControlNetConfig.from_unet_config(
        tu.config, alias_free=False).alias_free
    cn = T.ControlNetModel(cfg)
    d, m, _ = cn(torch.randn(1, 4, 8, 8), 999, torch.randn(1, 77, 16),
                 torch.randn(1, 4, 8, 8))
    assert all(not r.any() for r in d + (m,))


@pytest.fixture(scope="module")
def pipelines(models):
    """(a maker of JAX pipelines, each tracing anew, the port's)."""
    from afldm_tpu.pipelines import NormControlPipeline as JPipe
    from afldm_tpu.schedulers import DDIMScheduler as JDDIM
    from afldm_tpu_torch.pipelines import NormControlPipeline as TPipe
    from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
    (ju, jc, jv), (up, cp, vp), (tu, tc, tv) = models
    scfg = load_configs(tiny=True)[2]
    return (lambda: JPipe(jv, vp, ju, up, jc, cp, JDDIM(**scfg)),
            TPipe(tv, tu, tc, TDDIM(**scfg)))


@pytest.mark.parametrize("mode", ["yoso", "multistep_cfg_guess"])
def test_normal_estimation_matches_jax(pipelines, mode):
    """YOSO from the zero latent (JAX with the two-pass group-norm
    variance), and 2 DDIM steps from JAX's noise with guidance 2.0 and
    guess mode (stock JAX); 2 shifts each."""
    make_jax, tp = pipelines
    img = synthetic_image(64)
    key = jax.random.PRNGKey(3)
    run = dict(num_shift_steps=2)
    variance = contextlib.nullcontext()
    if mode == "yoso":
        variance = two_pass_group_norm()
    else:
        run.update(is_yoso=False, num_inference_steps=2, guidance_scale=2.0,
                   guess_mode=True)
    with variance:
        want = make_jax()(jnp.asarray(nhwc(img)), key=key, **run)
    got = tp(img, noise=nchw(jax.random.normal(key, (1, 8, 8, 4))), **run)
    assert got.normals.shape == (3, 64, 64, 3)
    assert np.isfinite(got.normals).all() and np.isfinite(got.psnrs).all()
    np.testing.assert_allclose(got.normals / 2 + 0.5,
                               np.asarray(want.normals) / 2 + 0.5,
                               atol=NORMAL_ATOL)
    np.testing.assert_allclose(got.psnrs, np.asarray(want.psnrs),
                               atol=PSNR_ATOL)
    assert got.mean_psnr == pytest.approx(want.mean_psnr, abs=PSNR_ATOL)


def test_yoso_prediction_against_f64(models, pipelines):
    """The witness for the YOSO case's two-pass variance: YOSO's step (the
    ControlNet's residuals into the UNet at t = 999 from the zero latent,
    conditioned on the encoded input image) in f32 by the port, by stock
    JAX and by JAX with the two-pass variance, each against the JAX
    models in f64. The port and two-pass JAX lie within F32_ATOL of f64;
    stock JAX lies at least twice as far as either."""
    (ju, jc, _), (up, cp, _), _ = models
    _, tp = pipelines
    with torch.inference_mode():
        cond = nhwc(tp.encode(synthetic_image(64)))
    x, t = np.zeros_like(cond), np.full((1,), 999, np.int32)
    ehs = np.zeros((1, 77, 16), np.float32)

    def yoso(unet, cn, up, cp, dtype):
        def f(up, cp, x, t, ehs, cond):
            down, mid, _ = cn.apply(cp, x, t, ehs, cond)
            return unet.apply(up, x, t, ehs, down_block_residuals=down,
                              mid_block_residual=mid)[0]
        a = [np.asarray(v, dtype) for v in (x, ehs, cond)]
        return np.asarray(jax.jit(f)(up, cp, a[0], t, a[1], a[2]))

    stock = yoso(ju, jc, up, cp, np.float32)
    with two_pass_group_norm():
        two_pass = yoso(ju, jc, up, cp, np.float32)
    with jax.enable_x64(True):
        def f64(p):
            return jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, jnp.float64), p)
        want = yoso(J.UNet2DConditionModel(ju.config, dtype=jnp.float64),
                    J.ControlNetModel(jc.config, dtype=jnp.float64),
                    f64(up), f64(cp), np.float64)
    assert want.dtype == np.float64
    with torch.inference_mode():
        down, mid, _ = tp.controlnet(nchw(x), torch.from_numpy(t),
                                     torch.from_numpy(ehs), nchw(cond))
        port = nhwc(tp.unet(nchw(x), torch.from_numpy(t),
                            torch.from_numpy(ehs), down_block_residuals=down,
                            mid_block_residual=mid)[0])
    err = {k: float(np.abs(v - want).max())
           for k, v in (("port", port), ("two_pass", two_pass),
                        ("stock", stock))}
    print(f"YOSO prediction, max |f32 - f64|: {err}")
    assert err["port"] <= F32_ATOL and err["two_pass"] <= F32_ATOL, err
    assert err["stock"] >= 2 * max(err["port"], err["two_pass"]), err


def test_random_start_needs_a_draw(pipelines):
    _, tp = pipelines
    with pytest.raises(ValueError, match="noise or a generator"):
        tp(synthetic_image(64), num_shift_steps=1, is_yoso=False,
           num_inference_steps=1)


def test_cli_tiny_cpu(tmp_path, capsys):
    from afldm_tpu_torch.scripts.shift_normal_estimation import main
    out = tmp_path / "normals.npy"
    res = main(["--tiny", "--device", "cpu", "--shift_steps", "2",
                "--output_path", str(out)])
    text = capsys.readouterr().out
    assert "shift 2/8 px: masked PSNR" in text
    assert f"mean shift-equivariance PSNR: {res.mean_psnr:.3f} dB" in text
    normals = np.load(out)
    diffs = np.load(tmp_path / "normals_diffs.npy")
    assert normals.shape == (3, 64, 64, 3) and diffs.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(normals, np.clip(res.normals / 2 + 0.5, 0, 1))
    assert np.isfinite(diffs).all() and diffs.min() >= 0
    with pytest.raises(FileNotFoundError):  # a pipeline directory is read
        main(["--tiny", "--device", "cpu", "--pipeline_dir",
              str(tmp_path / "missing")])


def test_cli_raises_without_cuda(monkeypatch):
    from afldm_tpu_torch.scripts.shift_normal_estimation import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tiny", "--shift_steps", "1"])
