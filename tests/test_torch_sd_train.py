"""The port's SD text trainer and normal-estimation ControlNet trainer
against the JAX package's, on the CPU at the tiny sizes of
``tests/test_train_sd.py`` (16 px images, the tiny AF-VAE, a two-level SD
UNet of widths 16 and 32 with 2 heads and 16-wide text embeddings), with
the CFA shift loss on: the JAX steps' own draws (reproduced from
``fold_in(PRNGKey(seed), step)`` and split as the JAX trainers split them),
the JAX-initialised weights carried across with ``from_flax``, and one stub
text encoder (a fixed numpy draw per prompt) on both sides, so that the
prompt dropout of ``default_rng(global_step)`` must drop the same prompts.
Each JAX trainer's step is compiled once for the module.

Tolerances, as ``tests/test_torch_train.py``'s: logged losses within 1e-5
relative; parameters (and the SD text trainer's EMA) after one and two
steps of the default AdamW (lr 1e-4, no warmup) within 1e-5, the
self-attention ``to_k`` biases (zero gradient in exact arithmetic) within
2 lr a step. The ControlNet trainer's frozen UNet parameters must not move
at all, and its clip by global norm must span the trainable subset only.
"""

import json
import os
import zlib
from dataclasses import asdict

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.models import (AutoencoderKL as JaxVAE,
                              UNet2DConditionModel as JaxSDUNet)
from afldm_tpu.train import (BaseTrainingConfig as JaxBase,
                             SyntheticDataset as JaxSynthetic,
                             create_trainer as jax_create_trainer,
                             epoch_batches as jax_epoch_batches)
from afldm_tpu.train.config import (NormControlNetConfig as JaxNorm,
                                    SDTextTrainingConfig as JaxSDText)
from afldm_tpu_torch import models as PM
from afldm_tpu_torch import train as PT
from afldm_tpu_torch.pipelines import load_sd_components
from test_torch_harness import nchw, port_state
from test_torch_train import LR, _assert_state_close
from test_train_sd import TINY_SD, TINY_VAE

torch.set_num_threads(1)

N_BATCH, RES, RATIO, DIM = 4, 16, 2, 16
SCHED = {"num_train_timesteps": 1000, "beta_schedule": "scaled_linear",
         "beta_start": 0.00085, "beta_end": 0.012}
CAPTIONS = np.array(["a red car", "a blue bird", "a green tree",
                     "a white house"])


class StubText:
    """``encode(prompts)``: a fixed draw per prompt, (N, 77, DIM); as JAX
    arrays or as torch tensors."""

    def __init__(self, as_jax: bool):
        self.as_jax = as_jax

    def encode(self, prompts):
        e = np.stack([np.random.default_rng(zlib.crc32(p.encode()))
                      .standard_normal((77, DIM)).astype(np.float32)
                      for p in prompts])
        return jnp.asarray(e) if self.as_jax else torch.from_numpy(e)


def _port_cfgs():
    vae = PM.AutoencoderKLConfig(**asdict(TINY_VAE))
    unet = PM.UNet2DConditionConfig(**asdict(TINY_SD))
    return vae, unet


def _base(tmp, **kw):
    return JaxBase(output_dir=str(tmp), resolution=RES,
                   train_batch_size=N_BATCH, num_epochs=1, seed=0, **kw)


def _keys_and_offsets(step, n_keys):
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    keys = jax.random.split(key, n_keys)
    k_off = keys[-1]
    max_off = int(RES * 0.75 // 2)
    ti, tj = (float(jax.random.randint(k, (), -max_off, max_off + 1))
              / RATIO for k in (k_off, jax.random.fold_in(k_off, 1)))
    return keys, ti, tj


def sd_draws(step):
    """The JAX SD text step's draws (k_enc, k_noise, k_t, k_off)."""
    (k_enc, k_noise, k_t, _), ti, tj = _keys_and_offsets(step, 4)
    lat = (N_BATCH, RES // RATIO, RES // RATIO, 4)
    return {"enc_eps": nchw(jax.random.normal(k_enc, lat)),
            "noise": nchw(jax.random.normal(k_noise, lat)),
            "t": torch.from_numpy(np.array(jax.random.randint(
                k_t, (N_BATCH,), 0, SCHED["num_train_timesteps"]))).long(),
            "ti": ti, "tj": tj}


def norm_draws(step, zero_input_prob):
    """The JAX ControlNet step's draws (k_zero, k_noise, k_off)."""
    (k_zero, k_noise, _), ti, tj = _keys_and_offsets(step, 3)
    lat = (N_BATCH, RES // RATIO, RES // RATIO, 4)
    zero = jax.random.uniform(k_zero, (N_BATCH, 1, 1, 1)) < zero_input_prob
    return {"zero": torch.from_numpy(np.array(zero).reshape(-1)),
            "noise": nchw(jax.random.normal(k_noise, lat)), "ti": ti,
            "tj": tj}


@pytest.fixture(scope="module")
def start():
    """The JAX trainers' initial weights (``prepare_modules``'s keys) and
    two batches, the second with normal maps."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    vp = jax.jit(JaxVAE(TINY_VAE).init)(k1, jnp.zeros((1, RES, RES, 3)))
    up = jax.jit(JaxSDUNet(TINY_SD).init)(
        k2, jnp.zeros((1, RES // RATIO, RES // RATIO, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, DIM)))
    ds = JaxSynthetic(resolution=RES, length=32)
    batches = [b for _, b in zip(range(2), jax_epoch_batches(ds, N_BATCH))]
    for b in batches:
        b["caption"] = CAPTIONS
        b["normal"] = b["input"][:, ::-1].copy()
    return vp, up, batches, port_state(vp), port_state(up)


def _copy(params):
    """A copy for a JAX trainer, whose step donates its state."""
    return jax.tree_util.tree_map(jnp.array, params)


def _sd_cfg():
    return JaxSDText(af_models=True, use_shift_loss=True, use_cross_attn=True,
                     use_ema=True, learning_rate=LR, lr_warmup_steps=0)


def _port_sd(tmp, unet_state, vae_state, **base_kw):
    tr = PT.create_trainer(
        "sd_text", PT.BaseTrainingConfig(**asdict(_base(tmp, **base_kw))),
        PT.SDTextTrainingConfig(**asdict(_sd_cfg())), device="cpu")
    vae, unet = _port_cfgs()
    tr.init_modules(vae_config=vae, unet_config=unet, scheduler_config=SCHED,
                    text_encoder=StubText(False))
    tr.init_optimizers(100)
    tr.prepare_modules(unet_state=unet_state, vae_state=vae_state)
    return tr


@pytest.fixture(scope="module")
def sd_runs(start, tmp_path_factory):
    vp, up, batches, vae0, unet0 = start
    tmp = tmp_path_factory.mktemp("sd")
    tr = jax_create_trainer("sd_text", _base(tmp, prompt_dropout=0.5),
                            _sd_cfg())
    tr.init_modules(vae_config=TINY_VAE, unet_config=TINY_SD,
                    scheduler_config=SCHED, text_encoder=StubText(True))
    tr.init_optimizers(100)
    tr.prepare_modules(vae_params=_copy(vp), unet_params=_copy(up))
    want = {"logs": [], "params": []}
    for i, b in enumerate(batches):
        want["logs"].append(tr.training_step(i, b))
        want["params"].append(port_state(tr.state.params))
    want["ema"] = port_state(tr.state.ema_params)

    pt = _port_sd(tmp, unet0, vae0, prompt_dropout=0.5)
    got = {"logs": [], "params": [], "prompts": []}
    for i, b in enumerate(batches):
        got["prompts"].append(pt.prompts(i, b))
        got["logs"].append(pt.training_step(i, b, sd_draws(i)))
        got["params"].append({n: p.detach().clone()
                              for n, p in pt.unet.named_parameters()})
    got["ema"] = {n: e for (n, _), e in zip(pt.unet.named_parameters(),
                                            pt.ema.params)}
    return {"want": want, "got": got, "unet0": unet0, "trainer": pt,
            "tmp": tmp}


def _norm_cfg(**kw):
    return JaxNorm(**{**dict(af_models=True, use_shift_loss=True,
                             learning_rate=LR, lr_warmup_steps=0,
                             zero_input_prob=0.5), **kw})


def _port_norm(tmp, states, **cfg_kw):
    tr = PT.create_trainer("norm_controlnet",
                           PT.BaseTrainingConfig(**asdict(_base(tmp))),
                           PT.NormControlNetConfig(**asdict(_norm_cfg(
                               **cfg_kw))), device="cpu")
    vae, unet = _port_cfgs()
    tr.init_modules(vae_config=vae, unet_config=unet)
    tr.init_optimizers(100)
    tr.prepare_modules(**states)
    return tr


@pytest.fixture(scope="module")
def norm_runs(start, tmp_path_factory):
    vp, up, batches, vae0, unet0 = start
    tmp = tmp_path_factory.mktemp("norm")
    tr = jax_create_trainer("norm_controlnet", _base(tmp), _norm_cfg())
    tr.init_modules(vae_config=TINY_VAE, unet_config=TINY_SD)
    tr.init_optimizers(100)
    tr.prepare_modules(vae_params=_copy(vp), unet_params=_copy(up))
    states = {"unet_state": unet0, "vae_state": vae0,
              "controlnet_state": port_state(tr.cn_state.params)}
    want = {"logs": [], "params": [], "cn": []}
    for i, b in enumerate(batches):
        want["logs"].append(tr.training_step(i, b))
        want["params"].append(port_state(tr.state.params))
        want["cn"].append(port_state(tr.cn_state.params))

    pt = _port_norm(tmp, states)
    got = {"logs": [], "params": [], "cn": []}
    for i, b in enumerate(batches):
        got["logs"].append(pt.training_step(i, b, norm_draws(i, 0.5)))
        got["params"].append({n: p.detach().clone()
                              for n, p in pt.unet.named_parameters()})
        got["cn"].append({n: p.detach().clone()
                          for n, p in pt.controlnet.named_parameters()})
    return {"want": want, "got": got, "states": states, "trainer": pt,
            "batches": batches, "tmp": tmp}


# -- SD text ------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("key", ["train_loss", "mse_loss", "shift_loss"])
@pytest.mark.parametrize("which", ["sd_text", "norm_controlnet"])
def test_step_losses_match_jax(sd_runs, norm_runs, which, step, key):
    runs = sd_runs if which == "sd_text" else norm_runs
    want = runs["want"]["logs"][step][key]
    got = runs["got"]["logs"][step][key]
    assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("step", [0, 1])
def test_sd_params_after_steps_match_jax(sd_runs, step):
    want = sd_runs["want"]["params"][step]
    moved = max(float((want[n] - w).abs().max())
                for n, w in sd_runs["unet0"].items())
    assert moved > 0.5 * LR
    _assert_state_close(sd_runs["got"]["params"][step], want, step + 1,
                        f"params after step {step}")


def test_sd_ema_after_two_steps_matches_jax(sd_runs):
    _assert_state_close(sd_runs["got"]["ema"], sd_runs["want"]["ema"], 2,
                        "EMA")


def test_prompt_dropout_drops_some_prompts(sd_runs):
    """The dropped prompts are ``default_rng(step)``'s: some of each batch
    but not all (the losses above agree only if JAX dropped the same)."""
    for prompts in sd_runs["got"]["prompts"]:
        assert 0 < prompts.count("") < len(prompts)
    assert sd_runs["got"]["prompts"][0] != sd_runs["got"]["prompts"][1]


def test_sd_gradient_accumulation(start, tmp_path):
    """With ``gradient_accumulation_steps`` 2 the UNet moves on every
    second micro-batch only."""
    _, _, batches, vae0, unet0 = start
    tr = _port_sd(tmp_path, unet0, vae0, gradient_accumulation_steps=2)
    w0 = tr.unet.conv_in.weight.detach().clone()
    tr.training_step(0, batches[0], sd_draws(0))
    assert torch.equal(tr.unet.conv_in.weight, w0)
    tr.training_step(1, batches[1], sd_draws(1))
    assert not torch.equal(tr.unet.conv_in.weight, w0)


def test_sd_save_pipeline_round_trip(sd_runs):
    """``save_pipeline`` then ``load_sd_components``: the EMA UNet and the
    VAE come back; a trainer started from the directory takes them."""
    tr = sd_runs["trainer"]
    out = str(sd_runs["tmp"] / "pipe")
    tr.save_pipeline(out)
    parts = load_sd_components(out, device="cpu")
    assert set(parts) == {"unet", "vae"}
    for n, p in parts["unet"].named_parameters():
        assert torch.equal(p, sd_runs["got"]["ema"][n]), n
    for k, v in parts["vae"].state_dict().items():
        assert torch.equal(v, tr.vae.state_dict()[k]), k
    again = PT.create_trainer(
        "sd_text", tr.base_cfg,
        PT.SDTextTrainingConfig(pretrained_model_name_or_path=out),
        device="cpu")
    again.init_modules(text_encoder=StubText(False))
    again.init_optimizers(10)
    again.prepare_modules()
    assert json.dumps(again.unet_config.to_dict()) == json.dumps(
        json.loads(json.dumps(tr.unet_config.to_dict())))
    for n, p in again.unet.named_parameters():
        assert torch.equal(p, sd_runs["got"]["ema"][n]), n


# -- the normal-estimation ControlNet -----------------------------------------

@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("part", ["unet", "controlnet"])
def test_norm_params_after_steps_match_jax(norm_runs, part, step):
    key = "params" if part == "unet" else "cn"
    want = norm_runs["want"][key][step]
    got = norm_runs["got"][key][step]
    _assert_state_close(got, want, step + 1, f"{part} after step {step}")
    start = norm_runs["states"]["unet_state" if part == "unet"
                                else "controlnet_state"]
    assert max(float((want[n] - w).abs().max())
               for n, w in start.items()) > 0.5 * LR


def test_norm_frozen_unet_parameters_stay_exact(norm_runs):
    """Only up_blocks, conv_norm_out and conv_out train; every other UNet
    parameter is bit for bit the start's after two steps, in both
    packages. Every trainable one moved but the zero biases of the norms
    before the cross-attentions: with zero prompt embeddings every key is
    the same, so the queries get no gradient."""
    start = norm_runs["states"]["unet_state"]
    got, want = norm_runs["got"]["params"][1], norm_runs["want"]["params"][1]
    trainable = [n for n in start if n.startswith(PT.norm_controlnet_trainer
                                                  .TRAINABLE)]
    assert trainable and len(trainable) < len(start)
    for n, p0 in start.items():
        if n in trainable:
            assert not torch.equal(got[n], p0) or n.endswith(".norm2.bias"), n
        else:
            assert torch.equal(got[n], p0) and torch.equal(want[n], p0), n


def test_norm_clip_spans_the_trainable_subset(norm_runs, tmp_path):
    """With a small ``max_grad_norm`` and the linear Adam of ``adam_epsilon``
    1 (the first update is lr * g / (|g| + 1)), the UNet's update is its
    gradient clipped by the norm over the trainable subset alone: the norm
    over the whole UNet (frozen parameters' gradients included) would clip
    harder, by a factor the updates resolve."""
    states, batch = norm_runs["states"], norm_runs["batches"][0]
    kw = dict(adam_epsilon=1.0, max_grad_norm=1e-2, adam_weight_decay=0.0)
    ref = _port_norm(tmp_path, states, **kw)
    ref.unet.requires_grad_(True)
    draws = norm_draws(0, 0.5)
    imgs = torch.from_numpy(batch["input"]).permute(0, 3, 1, 2).contiguous()
    nrm = torch.from_numpy(batch["normal"]).permute(0, 3, 1, 2).contiguous()
    loss, _ = ref.loss_fn(imgs, nrm, ref.prompt_embeds(N_BATCH), draws)
    loss.backward()
    grads = {n: p.grad for n, p in ref.unet.named_parameters()}
    trainable = [n for n in grads
                 if n.startswith(PT.norm_controlnet_trainer.TRAINABLE)]
    norm_sub = torch.linalg.vector_norm(torch.stack(
        [grads[n].norm() for n in trainable]))
    norm_all = torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads.values()]))
    assert norm_sub > 1e-2 and norm_all > 1.5 * norm_sub

    tr = _port_norm(tmp_path, states, learning_rate=1.0, **kw)
    tr.training_step(0, batch, draws)
    scale = float(1e-2 / norm_sub)
    got = dict(tr.unet.named_parameters())
    for n in trainable:
        g = grads[n] * scale
        want = states["unet_state"][n] - g / (g.abs() + 1.0)
        err = float((got[n].detach() - want).abs().max())
        assert err <= 1e-4 * float(g.abs().max()) + 1e-9, (n, err)


def test_norm_save_pipeline_round_trip(norm_runs):
    """``save_pipeline`` then ``load_sd_components``: UNet, ControlNet and
    VAE come back as trained."""
    tr = norm_runs["trainer"]
    out = str(norm_runs["tmp"] / "pipe")
    tr.save_pipeline(out)
    assert {"unet_config.json", "controlnet_config.json",
            "vae_config.json"} <= set(os.listdir(out))
    parts = load_sd_components(out, device="cpu")
    for k, mod in (("unet", tr.unet), ("controlnet", tr.controlnet),
                   ("vae", tr.vae)):
        want = mod.state_dict()
        for n, v in parts[k].state_dict().items():
            assert torch.equal(v, want[n]), (k, n)


@pytest.mark.parametrize("name", ["sd_text", "norm_controlnet"])
def test_train_cli_runs_sd(sd_runs, tmp_path, name):
    """The training CLI on a tiny config whose
    ``pretrained_model_name_or_path`` is the SD text trainer's saved
    pipeline, with a tiny CLIP ``text_encoder/`` in it for ``sd_text``:
    two steps, a checkpoint and a pipeline that ``load_sd_components``
    reads."""
    from afldm_tpu_torch.models import text_encoder as TE
    from afldm_tpu_torch.scripts import train as cli
    src = tmp_path / "src"
    sd_runs["trainer"].save_pipeline(str(src))
    if name == "sd_text":
        te = src / "text_encoder"
        te.mkdir()
        clip = TE.CLIPTextConfig(hidden_size=DIM, intermediate_size=32,
                                 num_hidden_layers=1, num_attention_heads=2)
        (te / "config.json").write_text(json.dumps(clip.to_dict()))
        torch.save(TE.CLIPTextModel(clip).init_random_(
            torch.Generator().manual_seed(0)).state_dict(),
            te / "pytorch_model.bin")
    cfg = {"base": {"output_dir": str(tmp_path / "o"), "resolution": RES,
                    "train_batch_size": 2, "num_epochs": 1,
                    "checkpointing_steps": 2, "save_model_epochs": 1,
                    "seed": 0, "prompt_dropout": 0.5},
           name: {"pretrained_model_name_or_path": str(src),
                  "learning_rate": 1e-3}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert cli.main([str(path), "--device", "cpu", "--max_steps", "2"]) == 2
    assert (tmp_path / "o" / "checkpoint-2").is_dir()
    parts = load_sd_components(str(tmp_path / "o" / "pipeline"),
                               device="cpu")
    assert ("controlnet" in parts) == (name == "norm_controlnet")
