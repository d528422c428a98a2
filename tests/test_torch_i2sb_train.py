"""The port's I2SB super-resolution trainer against the JAX package's, on
the CPU at the tiny sizes of ``tests/test_train.py`` (16 px images, the
tiny AF-VAE and FFHQ-family UNet, the I2SB scheduler of ``configs/sr``),
with the bridge noise on (``is_ode`` off) and the CFA shift loss on: the
JAX step's own draws (reproduced from ``fold_in(PRNGKey(seed), step)`` and
split as ``afldm_tpu/train/i2sb_trainer.py`` splits them) and the JAX
weights carried across with ``from_flax``; the JAX trainer is compiled
once for the module.

Tolerances, as ``tests/test_torch_train.py``'s: logged losses within 1e-5
relative; parameters and EMA after one and two steps of the default AdamW
(lr 1e-4, no warmup) within 1e-5, the self-attention ``to_k`` bias (zero
gradient in exact arithmetic) within 2 lr a step.
"""

import json
import os
from dataclasses import asdict

import numpy as np
import jax
import pytest
import torch

from afldm_tpu.train import (BaseTrainingConfig as JaxBase,
                             I2SBLDMTrainingConfig as JaxI2SB,
                             SyntheticDataset as JaxSynthetic,
                             create_trainer as jax_create_trainer,
                             epoch_batches as jax_epoch_batches)
from afldm_tpu_torch import train as PT
from afldm_tpu_torch.pipelines import I2SBLDMPipeline, load_pipeline
from afldm_tpu_torch.train.i2sb_trainer import degrade_sr4x
from test_torch_harness import REPO, nchw, port_state
from test_torch_train import LR, N_BATCH, RATIO, RES, _assert_state_close, \
    _port_configs
from test_train import TINY_UNET_CFG, TINY_VAE_CFG

torch.set_num_threads(1)

SCHED = {k: v for k, v in json.loads(
    (REPO / "configs/sr/i2sb_scheduler.json").read_text()).items()
    if not k.startswith("_")}


def _cfgs(tmp):
    base = JaxBase(output_dir=str(tmp), resolution=RES,
                   train_batch_size=N_BATCH, num_epochs=1, seed=0)
    cfg = JaxI2SB(af_models=True, is_ode=False, use_cfa=True, use_ema=True,
                  learning_rate=LR, lr_warmup_steps=0)
    return base, cfg


def _port_trainer(base, cfg, unet_state=None, vae_state=None):
    tr = PT.create_trainer("i2sb", PT.BaseTrainingConfig(**asdict(base)),
                           PT.I2SBLDMTrainingConfig(**asdict(cfg)),
                           device="cpu")
    vae, unet = _port_configs()
    tr.init_modules(vae_config=vae, unet_config=unet,
                    scheduler_config=SCHED)
    tr.init_optimizers(100)
    tr.prepare_modules(unet_state=unet_state, vae_state=vae_state)
    return tr


def jax_draws(step, seed=0):
    """The JAX step's draws for ``step`` (k_noise, k_t, k_off)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k_noise, k_t, k_off = jax.random.split(key, 3)
    lat = (N_BATCH, RES // RATIO, RES // RATIO, 4)
    max_off = int(RES * 0.75 // 2)
    ti, tj = (float(jax.random.randint(k, (), -max_off, max_off + 1))
              / RATIO for k in (k_off, jax.random.fold_in(k_off, 1)))
    return {"noise": nchw(jax.random.normal(k_noise, lat)),
            "t": torch.from_numpy(np.array(jax.random.randint(
                k_t, (N_BATCH,), 0, SCHED["num_train_timesteps"]))).long(),
            "ti": ti, "tj": tj}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two steps of the JAX trainer, then of the port's from its weights
    and with its draws."""
    tmp = tmp_path_factory.mktemp("i2sb")
    ds = JaxSynthetic(resolution=RES, length=32)
    batches = [b for _, b in zip(range(2), jax_epoch_batches(ds, N_BATCH))]
    base, cfg = _cfgs(tmp)
    tr = jax_create_trainer("i2sb", base, cfg)
    tr.init_modules(vae_config=TINY_VAE_CFG, unet_config=TINY_UNET_CFG,
                    scheduler_config=SCHED)
    tr.init_optimizers(100)
    tr.prepare_modules()
    unet0, vae = port_state(tr.state.params), port_state(tr.vae_params)
    want = {"logs": [], "params": []}
    for i, b in enumerate(batches):
        want["logs"].append(tr.training_step(i, b))
        want["params"].append(port_state(tr.state.params))
    want["ema"] = port_state(tr.state.ema_params)

    pt = _port_trainer(base, cfg, unet0, vae)
    got = {"logs": [], "params": []}
    for i, b in enumerate(batches):
        got["logs"].append(pt.training_step(i, b, jax_draws(i)))
        got["params"].append({n: p.detach().clone()
                              for n, p in pt.unet.named_parameters()})
    got["ema"] = {n: e for (n, _), e in zip(pt.unet.named_parameters(),
                                            pt.ema.params)}
    return {"want": want, "got": got, "unet0": unet0, "trainer": pt,
            "batches": batches, "cfgs": (base, cfg), "tmp": tmp}


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("key", ["train_loss", "mse_loss", "shift_loss"])
def test_step_losses_match_jax(runs, step, key):
    want = runs["want"]["logs"][step][key]
    got = runs["got"]["logs"][step][key]
    assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("step", [0, 1])
def test_params_after_steps_match_jax(runs, step):
    want = runs["want"]["params"][step]
    moved = max(float((want[n] - w).abs().max())
                for n, w in runs["unet0"].items())
    assert moved > 0.5 * LR
    _assert_state_close(runs["got"]["params"][step], want, step + 1,
                        f"params after step {step}")


def test_ema_after_two_steps_matches_jax(runs):
    _assert_state_close(runs["got"]["ema"], runs["want"]["ema"], 2, "EMA")


def test_draws_follow_seed_and_step(tmp_path):
    base, cfg = _cfgs(tmp_path)
    tr = _port_trainer(base, cfg)
    a, b, c = (tr.draw(s, N_BATCH) for s in (3, 3, 4))
    assert torch.equal(a["noise"], b["noise"]) and a["ti"] == b["ti"]
    assert not torch.equal(a["noise"], c["noise"])
    assert int(a["t"].max()) < SCHED["num_train_timesteps"]
    tr.cfg.is_ode = True
    assert tr.draw(3, N_BATCH)["noise"] is None


def test_save_pipeline_loads_as_an_i2sb_pipeline(runs):
    """``save_pipeline`` writes what ``load_pipeline(cls=I2SBLDMPipeline)``
    reads (the EMA UNet by default, the raw one with ``use_ema=False``);
    ``validate`` scores the pipeline's super-resolution by PSNR."""
    tr = runs["trainer"]
    out = str(runs["tmp"] / "pipe")
    tr.save_pipeline(out)
    assert {"unet_config.json", "vae_config.json",
            "scheduler_config.json"} <= set(os.listdir(out))
    for use_ema, want in ((True, runs["got"]["ema"]),
                          (False, runs["got"]["params"][1])):
        pipe = load_pipeline(out, cls=I2SBLDMPipeline, device="cpu",
                             use_ema=use_ema)
        assert pipe.scheduler.config == tr.noise_scheduler.config
        for n, p in pipe.unet.named_parameters():
            assert torch.equal(p, want[n]), n
    images = torch.from_numpy(runs["batches"][0]["input"][:2]).permute(
        0, 3, 1, 2).contiguous()
    val = tr.validate(2, images=images, num_steps=2)
    assert np.isfinite(val["val_psnr"])
    assert tr.validate(2) == {}
    assert degrade_sr4x(images).shape == images.shape


def test_i2sb_config_loads_as_in_jax():
    from afldm_tpu.train import load_training_config as jax_load
    rel = REPO / "configs/sr/train_i2sb_imagenet.json"
    got, want = PT.load_training_config(str(rel)), jax_load(str(rel))
    assert asdict(got["i2sb"]) == asdict(want["i2sb"])


def test_train_cli_runs_i2sb(tmp_path):
    """The training CLI on a tiny I2SB config (the LDM CLI test's tiny
    UNet and VAE): two steps, a checkpoint and a pipeline that
    ``load_pipeline`` reads as an I2SB pipeline."""
    from afldm_tpu_torch.scripts import train as cli
    from test_torch_train import _tiny_cli_config
    ldm = json.loads(_tiny_cli_config(tmp_path).read_text())
    cfg = {"base": dict(ldm["base"], resume_from_checkpoint=None),
           "i2sb": {"vae_path": ldm["ldm"]["vae_path"],
                    "unet_config": ldm["ldm"]["unet_config"],
                    "scheduler_path": str(REPO / "configs/sr/"
                                                 "i2sb_scheduler.json"),
                    "af_models": True, "use_cfa": True, "use_ema": True}}
    path = tmp_path / "i2sb.json"
    path.write_text(json.dumps(cfg))
    assert cli.main([str(path), "--device", "cpu", "--max_steps", "2"]) == 2
    out = tmp_path / "o"
    assert (out / "checkpoint-2").is_dir()
    pipe = load_pipeline(str(out / "pipeline"), cls=I2SBLDMPipeline,
                         device="cpu")
    assert pipe.scheduler.config["beta_schedule"] == SCHED["beta_schedule"]
