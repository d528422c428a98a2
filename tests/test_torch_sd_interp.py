"""The port's image-interpolation pipeline against the JAX package, end to
end: the tiny SD UNet and AF-VAE of the interpolation CLI (64 px, 3 frames,
2 DDIM steps) with the same weights, the same flows and JAX's gaussian
draws (``bg`` and one ``fresh`` per frame, ``z`` for the noise upsample)
passed in. Frames within 1e-4 absolute on [0, 1] (rounding compounds over
10 UNet passes, two encodes and a decode). Then the pipeline's own
contracts and the CLI.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu_torch import models as T
from afldm_tpu_torch.scripts.image_interpolation import (image_pair,
                                                          load_configs)
from test_torch_harness import jax_init, load_port, nchw, nhwc
from test_torch_models import _randomize

torch.set_num_threads(1)


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@pytest.fixture(scope="module")
def pipelines():
    from afldm_tpu.pipelines import ImageInterpolationPipeline as JPipe
    from afldm_tpu.schedulers import DDIMScheduler as JDDIM
    from afldm_tpu_torch.pipelines import ImageInterpolationPipeline as TPipe
    from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
    ucfg, vcfg, scfg = load_configs(tiny=True)
    ju = J.UNet2DConditionModel(J.UNet2DConditionConfig.from_diffusers(
        _tuples(ucfg), alias_free=True))
    jv = J.AutoencoderKL(J.AutoencoderKLConfig.from_diffusers(_tuples(vcfg)))
    up = _randomize(jax_init(ju, jnp.zeros((1, 8, 8, 4)),
                             jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 77, 16))), seed=9)
    vp = _randomize(jax_init(jv, jnp.zeros((1, 64, 64, 3))), seed=10)
    tu = load_port(T.UNet2DConditionModel(
        T.UNet2DConditionConfig.from_diffusers(ucfg, alias_free=True)), up)
    tv = load_port(T.AutoencoderKL(T.AutoencoderKLConfig.from_diffusers(
        vcfg)), vp)
    return (JPipe(jv, vp, ju, up, JDDIM(**scfg)),
            TPipe(tv, tu, TDDIM(**scfg)))


@pytest.fixture(scope="module")
def flows():
    """LK flows of the CLI's pair, from the JAX package, both layouts."""
    from afldm_tpu.shift.simple_flow import predict_flow
    img0, img1 = image_pair(64)
    jf = predict_flow(jnp.asarray(nhwc(img0)), jnp.asarray(nhwc(img1)))
    return (img0, img1), jf, tuple(nchw(f) for f in jf)


def _jax_draws(key, num_frames, noise_mode):
    """The draws ``warp_noise`` of the JAX package takes from ``key``."""
    k_up, k_bg, k_col = jax.random.split(key, 3)
    draws = {"bg": nchw(jax.random.normal(k_bg, (1, 8, 8, 4))),
             "fresh": torch.cat([nchw(jax.random.normal(
                 jax.random.fold_in(k_col, i), (1, 64, 64, 4)))
                 for i in range(num_frames)])}
    if noise_mode != "ideal":
        draws["z"] = nchw(jax.random.normal(k_up, (1, 64, 64, 4)))
    return draws


@pytest.mark.parametrize("noise_mode,use_slerp", [("ideal", True),
                                                  ("noise", False)])
def test_interpolation_matches_jax(pipelines, flows, noise_mode, use_slerp):
    jp, tp = pipelines
    (img0, img1), jf, tf = flows
    key = jax.random.PRNGKey(1)
    want = jp(jnp.asarray(nhwc(img0)), jnp.asarray(nhwc(img1)),
              num_frames=3, num_inference_steps=2, key=key, flows=jf,
              use_slerp=use_slerp, noise_mode=noise_mode)
    got = tp(img0, img1, num_frames=3, num_inference_steps=2,
             draws=_jax_draws(key, 3, noise_mode), flows=tf,
             use_slerp=use_slerp, noise_mode=noise_mode)
    assert got.shape == (3, 64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_interpolation_contracts(pipelines, flows):
    """No flows and no flow_fn raise; a flow_fn is used when given;
    frame-chunked decoding and a seeded generator give the same frames
    (within 1e-5: a decode of one frame sums its convolutions in another
    order than a decode of two)."""
    from afldm_tpu_torch.pipelines import interp_draws
    from afldm_tpu_torch.shift.simple_flow import predict_flow
    _, tp = pipelines
    (img0, img1), _, _ = flows
    with pytest.raises(ValueError, match="needs optical flow"):
        tp(img0, img1, num_frames=2, num_inference_steps=1,
           generator=torch.Generator().manual_seed(0))
    draws = interp_draws(torch.Generator().manual_seed(0), (1, 4, 8, 8), 2)
    assert draws["bg"].shape == (1, 4, 8, 8)
    assert draws["fresh"].shape == (2, 4, 64, 64) and "z" not in draws
    run = dict(num_frames=2, num_inference_steps=1, output_type="pt")
    tf = predict_flow(img0, img1)
    a = tp(img0, img1, draws=draws, flows=tf, **run)
    b = tp(img0, img1, generator=torch.Generator().manual_seed(0),
           flows=tf, decode_chunk=1, **run)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    tp.flow_fn = predict_flow
    try:
        c = tp(img0, img1, draws=draws, **run)
    finally:
        tp.flow_fn = None
    torch.testing.assert_close(c, a, atol=1e-6, rtol=0)


def test_cli_tiny_cpu(tmp_path, capsys):
    from afldm_tpu_torch.scripts.image_interpolation import main
    out = tmp_path / "frames.npy"
    frames = main(["--tiny", "--device", "cpu", "--num_frames", "3",
                   "--num_inference_steps", "2", "--output_path", str(out)])
    assert "interpolated 3 frames at 64 px" in capsys.readouterr().out
    saved = np.load(out)
    np.testing.assert_array_equal(saved, frames)
    assert saved.shape == (3, 64, 64, 3) and np.isfinite(saved).all()
    assert saved.min() >= 0 and saved.max() <= 1
    for flag in ("--shard_frames", "--gmflow_ckpt=x.pth"):
        with pytest.raises(NotImplementedError, match="not ported"):
            main(["--tiny", "--device", "cpu", flag])


def test_cli_raises_without_cuda(monkeypatch):
    from afldm_tpu_torch.scripts.image_interpolation import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tiny", "--num_frames", "2", "--num_inference_steps", "1"])

