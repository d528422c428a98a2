"""The port's SD pipeline directories: ``load_sd_components``,
``load_pipeline``'s ``use_ema`` / ``allow_random``, the converter
``afldm_tpu_torch/scripts/convert_reference_checkpoint.py`` and the
normal-estimation CLI's ``--pipeline_dir``, on the CPU at the tiny SD
sizes of ``tests/test_loading.py`` (a two-level SD UNet of widths 16 and
32, its ControlNet, a two-level AF-VAE at 16 px, a tiny CLIP).

The converter reads a diffusers-layout directory that the test writes
from JAX weights (``flax_to_torch``, drawn by ``numpy_init``), and the
loaded UNet and ControlNet give the JAX models' outputs on the same inputs
within 1e-5 (f32 rounding; measured ~1e-6). The failures mirror
``tests/test_loading.py``'s: no checkpoint, or a checkpoint without a
subtree, raises unless ``allow_random``.
"""

import json
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu.models.convert import flax_to_torch
from afldm_tpu_torch import models as PM
from afldm_tpu_torch.pipelines import (load_pipeline, load_sd_components)
from afldm_tpu_torch.scripts import convert_reference_checkpoint as conv
from afldm_tpu_torch.train import restore_checkpoint, save_checkpoint
from test_torch_harness import jax_apply, nchw, nhwc, numpy_init, rand

torch.set_num_threads(1)

UNET = {"sample_size": 8, "in_channels": 4, "out_channels": 4,
        "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
        "block_out_channels": [16, 32], "layers_per_block": 1,
        "attention_head_dim": 2, "cross_attention_dim": 16,
        "norm_num_groups": 8}
VAE = {"block_out_channels": [8, 8], "layers_per_block": 1,
       "latent_channels": 4, "norm_num_groups": 4, "sample_size": 16,
       "scaling_factor": 0.6}
ATOL = 1e-5


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    """A diffusers-layout directory: unet/ and controlnet/ as safetensors,
    vae/ as a .bin, scheduler/, a tiny CLIP text_encoder/ (saved by
    transformers) and a tokenizer/; with the JAX modules and weights."""
    from safetensors.numpy import save_file
    from transformers import CLIPTextConfig, CLIPTextModel
    ucfg = J.UNet2DConditionConfig.from_diffusers(UNET, alias_free=True)
    mods = {"unet": J.UNet2DConditionModel(ucfg),
            "controlnet": J.ControlNetModel(
                J.ControlNetConfig.from_unet_config(ucfg)),
            "vae": J.AutoencoderKL(J.AutoencoderKLConfig.from_diffusers(
                VAE, alias_free=True))}
    lat, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ehs = jnp.zeros((1, 77, 16))
    params = {"unet": numpy_init(mods["unet"], lat, t, ehs, seed=1),
              "controlnet": numpy_init(mods["controlnet"], lat, t, ehs, lat,
                                       seed=2),
              "vae": numpy_init(mods["vae"], jnp.zeros((1, 16, 16, 3)),
                                seed=3)}
    src = tmp_path_factory.mktemp("hub")
    for sub, cfg in (("unet", UNET), ("controlnet", UNET), ("vae", VAE)):
        (src / sub).mkdir()
        (src / sub / "config.json").write_text(json.dumps(
            {**cfg, "_class_name": sub}))
        sd = {k: np.ascontiguousarray(v)
              for k, v in flax_to_torch(params[sub]).items()}
        if sub == "vae":
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       src / sub / "diffusion_pytorch_model.bin")
        else:
            save_file(sd, str(src / sub /
                               "diffusion_pytorch_model.safetensors"))
    (src / "scheduler").mkdir()
    (src / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "DDIMScheduler", "num_train_timesteps": 1000,
         "beta_schedule": "scaled_linear", "beta_start": 0.00085,
         "beta_end": 0.012}))
    toks = ["<|startoftext|>", "<|endoftext|>"] + list("abcdefghij")
    (src / "tokenizer").mkdir()
    (src / "tokenizer" / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(toks + [c + "</w>" for c in toks[2:]])}))
    (src / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    torch.manual_seed(0)
    CLIPTextModel(CLIPTextConfig(
        vocab_size=22, hidden_size=16, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=12, bos_token_id=0,
        eos_token_id=1)).save_pretrained(src / "text_encoder")
    return src, mods, params


@pytest.fixture(scope="module")
def converted(hub, tmp_path_factory):
    src, _, _ = hub
    out = tmp_path_factory.mktemp("converted")
    conv.main([str(src), str(out)])
    return out


def test_converted_directory_matches_jax(hub, converted, rng):
    """UNet and ControlNet from ``load_sd_components`` on the converted
    directory against the JAX modules with the same weights."""
    _, mods, params = hub
    parts = load_sd_components(str(converted), device="cpu")
    assert set(parts) == {"unet", "vae", "controlnet", "text_encoder",
                          "scheduler_config"}
    assert parts["unet"].config.alias_free
    assert parts["scheduler_config"]["beta_end"] == 0.012
    x, c = rand(rng, (2, 8, 8, 4)), rand(rng, (2, 8, 8, 4))
    t, ehs = np.array([3, 900], np.int32), rand(rng, (2, 77, 16))
    want, _ = jax_apply(mods["unet"])(params["unet"], x, t, ehs)
    wd, wm, _ = jax_apply(mods["controlnet"])(params["controlnet"], x, t,
                                              ehs, c)
    with torch.no_grad():
        tt, te = torch.from_numpy(t), torch.from_numpy(ehs)
        got, _ = parts["unet"](nchw(x), tt, te)
        gd, gm, _ = parts["controlnet"](nchw(x), tt, te, nchw(c))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    for g, w in zip(gd + (gm,), wd + (wm,)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=ATOL)
    te = parts["text_encoder"]
    assert te.tokenizer is not None and te.max_length == 12
    assert list(te.tokenize(["abc"])[0][:3]) == [0, 2, 3]
    assert te.encode(["abc"]).shape == (1, 12, 16)


def test_converter_exits_nonzero_on_a_stray_key(hub, tmp_path):
    """A key that no module has (or a missing one) stops the converter;
    ``--lenient`` writes the directory anyway."""
    from safetensors.numpy import load_file, save_file
    src, _, _ = hub
    bad = tmp_path / "bad"
    shutil.copytree(src, bad)
    f = str(bad / "unet" / "diffusion_pytorch_model.safetensors")
    sd = load_file(f)
    sd["stray.weight"] = np.zeros(3, np.float32)
    del sd["conv_out.bias"]
    save_file(sd, f)
    lines = []
    with pytest.raises(SystemExit) as e:
        conv.convert_pipeline_dir(str(bad), str(tmp_path / "o"),
                                  log=lines.append)
    assert e.value.code not in (0, None)
    assert any("stray.weight" in s for s in lines)
    assert any("conv_out.bias" in s for s in lines)
    assert not (tmp_path / "o" / "checkpoint-0").exists()
    conv.main([str(bad), str(tmp_path / "o"), "--lenient"])
    state = restore_checkpoint(str(tmp_path / "o" / "checkpoint-0"))
    assert state["unet_ema"] == {} and "stray.weight" not in state["unet"]


def _write_dir(path, state=None, controlnet=False):
    path.mkdir()
    (path / "unet_config.json").write_text(json.dumps(UNET))
    (path / "vae_config.json").write_text(json.dumps(VAE))
    if controlnet:
        (path / "controlnet_config.json").write_text(json.dumps(UNET))
    if state is not None:
        save_checkpoint(str(path), 1, state)
    return str(path)


def _modules(seed):
    torch.manual_seed(seed)
    ucfg = PM.UNet2DConditionConfig.from_diffusers(UNET)
    return (PM.UNet2DConditionModel(ucfg),
            PM.AutoencoderKL(PM.AutoencoderKLConfig.from_diffusers(VAE)),
            PM.ControlNetModel(PM.ControlNetConfig.from_unet_config(ucfg)))


def test_load_sd_components_round_trip(tmp_path):
    """The EMA UNet is preferred; the raw one serves when the EMA entry is
    empty; the ControlNet comes with its config."""
    unet, vae, cn = _modules(0)
    ema, _, _ = _modules(1)
    d = _write_dir(tmp_path / "a", {"unet": unet.state_dict(),
                                    "unet_ema": ema.state_dict(),
                                    "vae": vae.state_dict(),
                                    "controlnet": cn.state_dict()},
                   controlnet=True)
    parts = load_sd_components(d, device="cpu")
    for got, want in ((parts["unet"], ema), (parts["vae"], vae),
                      (parts["controlnet"], cn)):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
    d = _write_dir(tmp_path / "b", {"unet": unet.state_dict(),
                                    "unet_ema": {}, "vae": vae.state_dict()})
    parts = load_sd_components(d, device="cpu")
    assert "controlnet" not in parts and "text_encoder" not in parts
    assert torch.equal(parts["unet"].conv_in.weight, unet.conv_in.weight)


def test_load_sd_components_fails_loud(tmp_path):
    """No checkpoint, or one without the VAE or the ControlNet, raises
    unless ``allow_random``, which keeps seeded random weights."""
    unet, _, _ = _modules(0)
    d = _write_dir(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_sd_components(d, device="cpu")
    assert load_sd_components(d, device="cpu", allow_random=True)[
        "unet"].config.sample_size == 8
    d = _write_dir(tmp_path / "part", {"unet": unet.state_dict()},
                   controlnet=True)
    with pytest.raises(FileNotFoundError, match="vae.*controlnet"):
        load_sd_components(d, device="cpu")
    parts = load_sd_components(d, device="cpu", allow_random=True)
    assert torch.equal(parts["unet"].conv_in.weight, unet.conv_in.weight)
    assert not parts["controlnet"].conv_in2.weight.any()


def test_load_pipeline_use_ema_and_allow_random(tmp_path):
    """``load_pipeline`` (the FFHQ family) mirrors the JAX loader: no
    checkpoint raises unless ``allow_random``; a checkpoint without a VAE
    raises unless ``allow_random``; ``use_ema=False`` takes the raw UNet."""
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    d = tmp_path / "p"
    d.mkdir()
    (d / "unet_config.json").write_text(json.dumps(ucfg))
    (d / "vae_config.json").write_text(json.dumps(vcfg))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_pipeline(str(d), device="cpu")
    assert load_pipeline(str(d), device="cpu", allow_random=True)
    ref = init_random_pipeline(ucfg, vcfg, scfg, seed=3, device="cpu")
    ema = init_random_pipeline(ucfg, vcfg, scfg, seed=4, device="cpu")
    save_checkpoint(str(d), 1, {"unet": ref.unet.state_dict(),
                                "unet_ema": ema.unet.state_dict()})
    with pytest.raises(FileNotFoundError, match="vae"):
        load_pipeline(str(d), device="cpu")
    for use_ema, want in ((True, ema), (False, ref)):
        pipe = load_pipeline(str(d), device="cpu", allow_random=True,
                             use_ema=use_ema)
        assert torch.equal(pipe.unet.conv_in.weight,
                           want.unet.conv_in.weight)


def test_normal_cli_reads_a_pipeline_directory(converted, tmp_path):
    """``shift_normal_estimation --pipeline_dir``: the directory's UNet,
    ControlNet, VAE and text encoder, as an in-memory pipeline of the same
    components gives them; a directory without a ControlNet raises."""
    from afldm_tpu_torch.pipelines import NormControlPipeline
    from afldm_tpu_torch.schedulers import DDIMScheduler
    from afldm_tpu_torch.scripts.shift_normal_estimation import (
        NORMAL_DDIM, main, synthetic_image)
    res = main(["--device", "cpu", "--pipeline_dir", str(converted),
                "--shift_steps", "2", "--output_path",
                str(tmp_path / "n.npy")])
    parts = load_sd_components(str(converted), device="cpu")
    want = NormControlPipeline(parts["vae"], parts["unet"],
                               parts["controlnet"],
                               DDIMScheduler.from_config(NORMAL_DDIM),
                               text_encoder=parts["text_encoder"])(
        synthetic_image(16), num_shift_steps=2)
    np.testing.assert_array_equal(res.normals, want.normals)
    unet, vae, _ = _modules(0)
    d = _write_dir(tmp_path / "nocn", {"unet": unet.state_dict(),
                                       "vae": vae.state_dict()})
    argv = ["--device", "cpu", "--pipeline_dir", d, "--shift_steps", "1",
            "--output_path", str(tmp_path / "m.npy")]
    with pytest.raises(FileNotFoundError, match="controlnet"):
        main(argv)
