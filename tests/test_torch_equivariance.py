"""The port's StyleGAN-3 equivariance tooling (``shift/equivariance.py``),
the shift protocol's ``batch_shifts=False`` and the EQ-metric CLI
(``scripts/eval_equivariance.py``) against the JAX package, on the same
numpy inputs (NHWC to JAX, NCHW to the port) and, for the pipelines, the
same weights (``from_flax``).

Tolerances: the translations, the affine warp and the rotations 1e-5
absolute and their masks exactly; filters built in numpy 1e-7;
``compute_equivariance_metrics`` on a shared deterministic generator
1e-3 dB; ``batch_shifts=False`` against JAX and against the port's batched
run 1e-3 dB a shift; the tiny EQ CLI path against a JAX generator that
mirrors ``scripts/eval_equivariance.py`` 0.01 dB.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.shift import equivariance as JE
from afldm_tpu.shift import shifters as JS
from afldm_tpu_torch.shift import equivariance as TE
from test_torch_harness import load_port, nchw, nhwc, numpy_init, rand

torch.set_num_threads(1)

ATOL = 1e-5


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=atol)


def same(got, want):
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def image(rng, shape):
    """An image on [-1, 1], the range the metrics see (the 121-tap
    pseudo-rotation filter sums to within 1e-5 there in f32)."""
    return rng.uniform(-1, 1, shape).astype(np.float32)


def test_sinc_and_lanczos_window():
    x = np.concatenate([np.linspace(-4.5, 4.5, 37), [0.0, 1e-31, 3.0]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(TE.sinc(torch.from_numpy(x)).numpy(),
                               np.asarray(JE.sinc(jnp.asarray(x))),
                               atol=1e-6)
    for a in (2, 3):
        np.testing.assert_allclose(
            TE.lanczos_window(torch.from_numpy(x), a).numpy(),
            np.asarray(JE.lanczos_window(jnp.asarray(x), a)), atol=1e-6)
    np.testing.assert_array_equal(TE.rotation_matrix(0.7),
                                  JE.rotation_matrix(0.7))


@pytest.mark.parametrize("tx,ty", [(0.0, 0.0), (0.125, -0.25),
                                   (-0.3, 0.06), (1.2, 0.0)])
def test_integer_translation(rng, tx, ty):
    x = image(rng, (2, 16, 12, 3))
    want = JE.apply_integer_translation(jnp.asarray(x), tx, ty)
    got = TE.apply_integer_translation(nchw(x), tx, ty)
    same(got[0], want[0])
    same(got[1], want[1])


@pytest.mark.parametrize("tx,ty", [(0.0, 0.0), (0.0313, -0.07),
                                   (-0.21, 0.118), (0.5, 0.25),
                                   (0.95, 0.0), (-1.1, 0.3)])
@pytest.mark.parametrize("a", [2, 3])
def test_fractional_translation(rng, tx, ty, a):
    x = image(rng, (2, 16, 12, 3))
    want = JE.apply_fractional_translation(jnp.asarray(x), tx, ty, a=a)
    got = TE.apply_fractional_translation(nchw(x), tx, ty, a=a)
    close(got[0], want[0])
    same(got[1], want[1])


@pytest.mark.parametrize("angle", [0.0, 0.4, -1.3, 2.9])
@pytest.mark.parametrize("kw", [dict(up=4), dict(up=1, a=2, amax=4),
                                dict(up=2, a=3, amax=6, cutoff_in=0.8)])
def test_affine_bandlimit_filter(angle, kw):
    mat = JE.rotation_matrix(angle)
    want = np.asarray(JE.construct_affine_bandlimit_filter(mat, **kw))
    got = TE.construct_affine_bandlimit_filter(mat, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("angle", [0.31, -0.97, 2.2])
def test_rotations(rng, angle):
    x = image(rng, (1, 32, 32, 3))
    for jf, tf in ((JE.apply_fractional_rotation,
                    TE.apply_fractional_rotation),
                   (JE.apply_fractional_pseudo_rotation,
                    TE.apply_fractional_pseudo_rotation)):
        want = jf(jnp.asarray(x), angle)
        got = tf(nchw(x), angle)
        close(got[0], want[0])
        same(got[1], want[1])


def test_affine_transformation_grid(rng):
    """``F.affine_grid`` + ``F.grid_sample`` against the JAX package's own
    grid and sampler, on an affine map with shear and translation. (At
    up=4 with this shear the 47x47 filter's f32 sums leave each package
    5-7e-6 from float64, and one element of 3072 1.06e-5 from the other;
    up=2 keeps the two within 1e-5.)"""
    x = image(rng, (1, 20, 16, 2))
    mat = np.array([[1.1, 0.2, 0.05], [-0.15, 0.9, -0.1], [0, 0, 1]],
                   np.float32)
    want = JE.apply_affine_transformation(jnp.asarray(x), mat, up=2, a=2,
                                          amax=4)
    got = TE.apply_affine_transformation(nchw(x), mat, up=2, a=2, amax=4)
    close(got[0], want[0])
    same(got[1], want[1])


def _pattern_generator(res=32):
    """A deterministic smooth NHWC image of (batch index, transform): a
    sum of sinusoids, per batch, evaluated at the transformed pixel
    centres; the same numpy array goes to both packages."""
    ys, xs = np.meshgrid((np.arange(res) + 0.5) / res * 2 - 1,
                         (np.arange(res) + 0.5) / res * 2 - 1, indexing="ij")

    def gen(index, M):
        r = np.random.default_rng(100 + index)
        k = r.normal(size=(3, 4, 2)) * 2.5
        ph = r.uniform(0, 2 * np.pi, (3, 4))
        Mi = np.linalg.inv(np.asarray(M, np.float64))
        u = Mi[0, 0] * xs + Mi[0, 1] * ys + Mi[0, 2] * 2
        v = Mi[1, 0] * xs + Mi[1, 1] * ys + Mi[1, 2] * 2
        img = np.stack([np.sin(k[c, :, 0, None, None] * u
                               + k[c, :, 1, None, None] * v
                               + ph[c, :, None, None]).sum(0) / 4
                        for c in range(3)], -1)
        return img[None].astype(np.float32)
    return gen


@pytest.mark.parametrize("which", [dict(compute_eqt_int=True),
                                   dict(compute_eqt_int=True,
                                        compute_eqt_frac=True,
                                        compute_eqr=True)])
def test_compute_equivariance_metrics(which):
    gen = _pattern_generator()
    keys = {}

    def jgen(key, M):
        kid = tuple(np.asarray(jax.random.key_data(key)).ravel())
        return jnp.asarray(gen(keys.setdefault(kid, len(keys)), M))

    kw = dict(num_samples=2, batch_size=1, img_resolution=32, **which)
    want = np.atleast_1d(JE.compute_equivariance_metrics(
        jgen, jax.random.PRNGKey(0), **kw))
    got = np.atleast_1d(TE.compute_equivariance_metrics(
        lambda i, M: nchw(gen(i, M)), **kw))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_metrics_all_reduce(tmp_path):
    """``axis_name`` sums over a torch.distributed group (one gloo process
    here: the same values) and raises without one."""
    import torch.distributed as dist
    gen = _pattern_generator(16)
    kw = dict(num_samples=1, batch_size=1, img_resolution=16,
              compute_eqt_frac=True)
    with pytest.raises(RuntimeError, match="process group"):
        TE.compute_equivariance_metrics(lambda i, M: nchw(gen(i, M)),
                                        axis_name="batch", **kw)
    local = TE.compute_equivariance_metrics(lambda i, M: nchw(gen(i, M)),
                                            **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        summed = TE.compute_equivariance_metrics(
            lambda i, M: nchw(gen(i, M)), axis_name="batch", **kw)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(summed, local, rtol=1e-12)


# -- the pipelines ------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    """The tiny FFHQ pipeline on both sides with the same numpy-drawn
    weights (no compiled JAX init)."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu.pipelines import LDMPipeline as JPipe
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
    return (JPipe(jv, vp, ju, up, JDDIM.from_config(scfg)),
            TPipe(tv, tu, TDDIM.from_config(scfg)))


def test_batch_shifts_false(pipelines):
    from afldm_tpu.pipelines import shift_equivariance_eval as jeval
    from afldm_tpu_torch.pipelines import shift_equivariance_eval as teval
    jp, tp = pipelines
    lat = rand(np.random.default_rng(21), (1, 8, 8, 4))
    kw = dict(num_inference_steps=2, num_shift_steps=3)
    want = jeval(jp, init_latent=jnp.asarray(lat), batch_shifts=False, **kw)
    got = teval(tp, init_latent=nchw(lat), batch_shifts=False, **kw)
    batched = teval(tp, init_latent=nchw(lat), **kw)
    assert got.psnrs.shape == (3,) and np.isfinite(got.psnrs).all()
    np.testing.assert_allclose(got.psnrs, want.psnrs, atol=1e-3)
    np.testing.assert_allclose(got.psnrs, batched.psnrs, atol=1e-3)
    np.testing.assert_array_equal(got.masks, want.masks)


def test_eq_cli_path_matches_jax(pipelines):
    """The port's ``run`` against a JAX generate that mirrors
    ``scripts/eval_equivariance.py``'s, with the same weights and the same
    numpy-drawn latents (two batches of one, the CLI's default batch)."""
    from afldm_tpu_torch.scripts import eval_equivariance as cli
    jp, tp = pipelines
    steps, sample, ratio = 2, 8, 8
    lats = rand(np.random.default_rng(22), (2, 1, sample, sample, 4))
    shifter = JS.ImageShifter("ideal", upsample_ratio=ratio)
    kv_store, keys = {}, {}

    def jgen(key, M):
        kid = keys.setdefault(
            tuple(np.asarray(jax.random.key_data(key)).ravel()), len(keys))
        z = jnp.asarray(lats[kid])
        tx = -float(M[0, 2]) * sample
        ty = -float(M[1, 2]) * sample
        if (tx, ty) != (0.0, 0.0):
            z = shifter.shift(z, jnp.float32(ty), jnp.float32(tx))[0]
            lat, _ = jp.denoise(z, steps, kv_traj=kv_store[kid])
        else:
            lat, kv_store[kid] = jp.denoise(z, steps, collect_kv=True)
        return jp.decode(lat)

    want = JE.compute_equivariance_metrics(
        jgen, jax.random.PRNGKey(0), 2, 1, sample * ratio,
        compute_eqt_int=True, compute_eqt_frac=True)
    got = cli.run(tp, num_samples=2, batch_size=1, steps=steps,
                  draw=lambda i: nchw(lats[i]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.01)


def test_eq_cli_tiny_cpu(tmp_path, capsys, monkeypatch):
    from afldm_tpu_torch.scripts import eval_equivariance as cli
    out = tmp_path / "results" / "eq_torch.json"
    eq = cli.main(["--tiny", "--device", "cpu", "--num_samples", "2",
                   "--steps", "2", "--out", str(out)])
    assert "EQ-T:" in capsys.readouterr().out and np.isfinite(eq).all()
    rec = json.loads(out.read_text())
    assert rec["eq_t_db"] == round(eq[0], 3) and rec["steps"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--tiny", "--num_samples", "1", "--steps", "1"])
