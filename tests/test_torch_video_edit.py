"""The port's video-editing pipeline against the JAX package, end to end:
the tiny SD UNet and AF-VAE of the video-editing CLI (64 px, 2 frames of
its synthetic translating pattern, 2 DDIM steps at strength 1) with the
same weights, drawn by ``numpy_init``, and JAX's SDEdit noise passed in.
Both pipelines hold one stub text encoder, a fixed draw per prompt, so
that the [uncond, cond] halves of every CFG batch differ (zero embeddings
would make them equal and the guidance a no-op). SDEdit with guidance 7.5
and ``guidance_rescale`` 0.7, and DDIM inversion with frame 0's maps;
frames within 1e-4 on [0, 1]. Then the strength truncation and the CLI.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu_torch import models as T
from afldm_tpu_torch.scripts.video_editing import load_configs, load_frames
from test_torch_harness import load_port, nchw, nhwc, numpy_init

torch.set_num_threads(1)

FRAME_ATOL = 1e-4  # frames on [0, 1]
PROMPT, NEGATIVE = "a red car", "blurry"


class StubTextEncoder:
    """``encode([prompt]) -> (1, 77, 16)``: a fixed draw per prompt, as
    ``wrap`` makes it (jnp or torch), the same numbers for both packages."""

    def __init__(self, wrap):
        rng = np.random.default_rng(11)
        self.table = {p: wrap(rng.standard_normal((1, 77, 16))
                              .astype(np.float32))
                      for p in ("", PROMPT, NEGATIVE)}

    def encode(self, prompts):
        (prompt,) = prompts
        return self.table[prompt]


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@pytest.fixture(scope="module")
def pipelines():
    from afldm_tpu.pipelines import VideoEquivEditingPipeline as JPipe
    from afldm_tpu.schedulers import DDIMScheduler as JDDIM
    from afldm_tpu_torch.pipelines import VideoEquivEditingPipeline as TPipe
    from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
    ucfg, vcfg, scfg = load_configs(tiny=True)
    ju = J.UNet2DConditionModel(J.UNet2DConditionConfig.from_diffusers(
        _tuples(ucfg), alias_free=True))
    jv = J.AutoencoderKL(J.AutoencoderKLConfig.from_diffusers(_tuples(vcfg)))
    up = numpy_init(ju, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                    jnp.zeros((1, 77, 16)), seed=4)
    vp = numpy_init(jv, jnp.zeros((1, 64, 64, 3)), seed=5)
    tu = load_port(T.UNet2DConditionModel(
        T.UNet2DConditionConfig.from_diffusers(ucfg, alias_free=True)), up)
    tv = load_port(T.AutoencoderKL(T.AutoencoderKLConfig.from_diffusers(
        vcfg)), vp)
    return (JPipe(jv, vp, ju, up, JDDIM(**scfg),
                  text_encoder=StubTextEncoder(jnp.asarray)),
            TPipe(tv, tu, TDDIM(**scfg),
                  text_encoder=StubTextEncoder(torch.from_numpy)))


def test_cfg_halves_differ(pipelines):
    """The stub prompts make the unconditional and conditional noise
    predictions of a CFG batch differ far above the frame tolerance, so
    the frame comparisons below see the guidance arithmetic."""
    _, tp = pipelines
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, 8, 8)).astype(np.float32))
    uncond, cond = tp.encode_prompt(PROMPT, NEGATIVE)
    with torch.inference_mode():
        eps, stored = tp.unet(torch.cat([x, x]), 999,
                              torch.cat([uncond, cond]))
    eps_u, eps_c = eps.chunk(2)
    assert float((eps_c - eps_u).abs().max()) > 100 * FRAME_ATOL
    # the stored maps of a STORE batch differ between the halves too, so
    # the LOAD pass's per-half broadcast of them is seen
    assert any(float((m[0] - m[1]).abs().max()) > 100 * FRAME_ATOL
               for m in stored)


@pytest.mark.parametrize("mode", ["sdedit_rescale", "inversion"])
def test_video_editing_matches_jax(pipelines, mode):
    jp, tp = pipelines
    frames = load_frames(None, 64, 2)
    key = jax.random.PRNGKey(1)
    run = dict(strength=1.0, num_inference_steps=2, guidance_scale=7.5)
    if mode == "inversion":
        run["use_inversion"] = True
    else:
        run["guidance_rescale"] = 0.7
    want = jp(jnp.asarray(nhwc(frames)), PROMPT, NEGATIVE, key=key, **run)
    got = tp(frames, PROMPT, NEGATIVE,
             noise=nchw(jax.random.normal(key, (2, 8, 8, 4))), **run)
    assert got.shape == (2, 64, 64, 3) and np.isfinite(got).all()
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, np.asarray(want), atol=FRAME_ATOL)


def test_get_timesteps_truncates_as_jax_and_raises(pipelines):
    jp, tp = pipelines
    for steps, strength in ((10, 0.7), (4, 1.0), (50, 0.02), (3, 2.0)):
        assert tp.get_timesteps(steps, strength) == \
            [int(t) for t in jp.get_timesteps(steps, strength)]
    with pytest.raises(ValueError, match="ZERO denoise steps"):
        tp.get_timesteps(2, 0.4)


def test_sdedit_needs_a_draw(pipelines):
    _, tp = pipelines
    with pytest.raises(ValueError, match="noise or a generator"):
        tp(load_frames(None, 64, 1), num_inference_steps=1, strength=1.0)


def test_cli_tiny_cpu(tmp_path, capsys):
    """The CLI's synthetic frames, then the same frames read back from a
    directory of .npy frames at another size (resized to 64 px)."""
    from afldm_tpu_torch.scripts.video_editing import main
    out = tmp_path / "edit.npy"
    argv = ["--tiny", "--device", "cpu", "--num_inference_steps", "2",
            "--max_frames", "2", "--output_path", str(out)]
    frames = main(argv)
    assert "edited 2 frames at 64 px" in capsys.readouterr().out
    saved = np.load(out)
    np.testing.assert_array_equal(saved, frames)
    assert saved.shape == (2, 64, 64, 3) and np.isfinite(saved).all()
    assert saved.min() >= 0 and saved.max() <= 1
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        np.save(src / f"{i:03d}.npy", np.full((32, 32, 3), i / 2, np.float32))
    read = load_frames(src, 64, 2)
    assert read.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(read[1].numpy(), 0.0, atol=1e-6)
    again = main(argv + ["--input_video", str(src)])
    assert again.shape == (2, 64, 64, 3) and np.isfinite(again).all()
    for flag, where in (("--shard_frames", "Queue 1 item 9"),
                        ("--pipeline_dir=x", "Queue 3")):
        with pytest.raises(NotImplementedError, match=where):
            main(["--tiny", "--device", "cpu", flag])
    with pytest.raises(ValueError, match="directory of .npy"):
        load_frames(out, 64, 2)


def test_cli_raises_without_cuda(monkeypatch):
    from afldm_tpu_torch.scripts.video_editing import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tiny", "--max_frames", "1", "--num_inference_steps", "1"])
