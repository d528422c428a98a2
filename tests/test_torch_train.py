"""The port's LDM training path against the JAX package, on the CPU at the
tiny sizes of ``tests/test_train.py``: the DDPM scheduler, the ``ideal``
shifter, the EMA, the optimizer with its lr schedules and gradient
accumulation, and the training step as a whole, given the JAX step's own
random draws (reproduced from ``fold_in(PRNGKey(seed), step)`` and split as
``afldm_tpu/train/ldm_trainer.py`` splits them) and the JAX weights carried
across with ``from_flax``; then the remat policies, checkpoints, the CLI
and the configs.

Tolerances:
- logged losses: 1e-5 relative (f32 rounding in another summation order;
  measured ~4e-7);
- parameters and EMA after one and two steps of the default AdamW (lr
  1e-4, warmup off so that both steps move them, ~2e-4): 1e-5 absolute.
  The exception is the self-attention ``to_k`` bias: softmax is invariant
  to a shift of every key, so its gradient is zero in exact arithmetic and
  rounding noise elsewhere, which Adam normalises to an update of up to
  ~lr of either sign; it is held to 2 lr per step;
- one step with ``adam_epsilon=1`` and ``max_grad_norm=1e6`` (lr 1, no
  weight decay), where the update g / (|g| + 1) is monotonic in the
  gradient and so checks its magnitude, not only its sign: each tensor's
  update within 1e-4 of its largest, plus 1e-6 of the largest of all
  tensors (the rounding noise of the zero-gradient ``to_k`` biases);
- scheduler, shifter and EMA: 1e-6 relative (f32); optimizer: 1e-5
  absolute on parameters that move by ~0.1 an update (f32 rounding of the
  clip and Adam arithmetic in another order: 1e-4 of one update).
"""

import json
import os
from dataclasses import asdict

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from afldm_tpu.schedulers import DDPMScheduler as JaxDDPM
from afldm_tpu.shift.shifters import ImageShifter as JaxShifter
from afldm_tpu.train import (BaseTrainingConfig as JaxBase,
                             LDMTrainingConfig as JaxLDM,
                             SyntheticDataset as JaxSynthetic,
                             create_trainer as jax_create_trainer,
                             epoch_batches as jax_epoch_batches,
                             make_optimizer as jax_make_optimizer)
from afldm_tpu.train.ema import ema_init, ema_update
from afldm_tpu_torch import models as PM
from afldm_tpu_torch import train as PT
from afldm_tpu_torch.schedulers import DDPMScheduler
from afldm_tpu_torch.shift import ImageShifter
from test_torch_harness import REPO, nchw, nhwc, port_state, rand
from test_train import SCHED_CFG, TINY_UNET_CFG, TINY_VAE_CFG

torch.set_num_threads(1)

LR = 1e-4
N_BATCH, RES, RATIO = 4, 16, 2


def _port_configs():
    vae = PM.AutoencoderKLConfig(**asdict(TINY_VAE_CFG))
    unet = PM.UNet2DConfig(**{k: v for k, v in asdict(TINY_UNET_CFG).items()
                              if k in PM.UNet2DConfig.__dataclass_fields__})
    return vae, unet


def _jax_cfgs(tmp, **ldm):
    base = JaxBase(output_dir=str(tmp), resolution=RES,
                   train_batch_size=N_BATCH, num_epochs=1, seed=0)
    cfg = JaxLDM(vae_path="", scheduler_path="", af_models=True,
                 use_shift_loss=True, use_cross_attn=True, use_ema=True,
                 learning_rate=LR, lr_warmup_steps=0, **ldm)
    return base, cfg


def _port_trainer(base, cfg, unet_state=None, vae_state=None, **base_kw):
    """A tiny port LDMTrainer on the CPU from JAX config dataclasses (same
    field names), with the given weights."""
    pb = PT.BaseTrainingConfig(**{**asdict(base), **base_kw})
    pc = PT.LDMTrainingConfig(**asdict(cfg))
    tr = PT.create_trainer("ldm", pb, pc, device="cpu")
    vae, unet = _port_configs()
    tr.init_modules(vae_config=vae, unet_config=unet,
                    scheduler_config=SCHED_CFG)
    tr.init_optimizers(100)
    tr.prepare_modules(unet_state=unet_state, vae_state=vae_state)
    return tr


def jax_draws(step, seed=0):
    """The JAX step's draws for ``step``, as NCHW tensors and floats."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k_enc, k_noise, k_t, k_off = jax.random.split(key, 4)
    lat = (N_BATCH, RES // RATIO, RES // RATIO, 4)
    max_off = int(RES * 0.75 // 2)
    ti, tj = (float(jax.random.randint(k, (), -max_off, max_off + 1))
              / RATIO for k in (k_off, jax.random.fold_in(k_off, 1)))
    return {"enc_eps": nchw(jax.random.normal(k_enc, lat)),
            "noise": nchw(jax.random.normal(k_noise, lat)),
            "t": torch.from_numpy(np.array(jax.random.randint(
                k_t, (N_BATCH,), 0, SCHED_CFG["num_train_timesteps"]))).long(),
            "ti": ti, "tj": tj}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Both JAX trainers, compiled once for the module: the default
    optimizer over two steps, and the linear-Adam one over one step."""
    tmp = tmp_path_factory.mktemp("jax")
    ds = JaxSynthetic(resolution=RES, length=32)
    batches = [b for _, b in zip(range(2), jax_epoch_batches(ds, N_BATCH))]
    out = {"batches": batches}

    base, cfg = _jax_cfgs(tmp)
    tr = jax_create_trainer("ldm", base, cfg)
    tr.init_modules(vae_config=TINY_VAE_CFG, unet_config=TINY_UNET_CFG,
                    scheduler_config=SCHED_CFG)
    tr.init_optimizers(100)
    tr.prepare_modules()
    out["cfgs"] = (base, cfg)
    out["unet0"] = port_state(tr.state.params)
    out["vae"] = port_state(tr.vae_params)
    out["logs"], out["params"] = [], []
    for i, b in enumerate(batches):
        out["logs"].append(tr.training_step(i, b))
        out["params"].append(port_state(tr.state.params))
    out["ema2"] = port_state(tr.state.ema_params)

    lin = dict(adam_epsilon=1.0, max_grad_norm=1e6, adam_weight_decay=0.0)
    base, cfg = _jax_cfgs(tmp, **lin)
    cfg.learning_rate = 1.0
    tr = jax_create_trainer("ldm", base, cfg)
    tr.init_modules(vae_config=TINY_VAE_CFG, unet_config=TINY_UNET_CFG,
                    scheduler_config=SCHED_CFG)
    tr.init_optimizers(100)
    tr.prepare_modules()
    tr.training_step(0, batches[0])
    out["lin_cfgs"] = (base, cfg)
    out["lin_params"] = port_state(tr.state.params)
    return out


@pytest.fixture(scope="module")
def port_run(jax_run):
    tr = _port_trainer(*jax_run["cfgs"], jax_run["unet0"], jax_run["vae"])
    logs, params = [], []
    for i, b in enumerate(jax_run["batches"]):
        logs.append(tr.training_step(i, b, jax_draws(i)))
        params.append({n: p.detach().clone()
                       for n, p in tr.unet.named_parameters()})
    ema = {n: e for (n, _), e in zip(tr.unet.named_parameters(),
                                     tr.ema.params)}
    return {"logs": logs, "params": params, "ema2": ema}


# -- the training step against JAX ------------------------------------------

@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("key", ["train_loss", "mse_loss", "shift_loss"])
def test_step_losses_match_jax(jax_run, port_run, step, key):
    want = jax_run["logs"][step][key]
    got = port_run["logs"][step][key]
    assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)


def _assert_state_close(got: dict, want: dict, steps: int, what: str):
    assert set(got) == set(want)
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        atol = 2 * LR * steps if n.endswith("to_k.bias") else 1e-5
        assert err <= atol, f"{what} {n}: {err} > {atol}"


@pytest.mark.parametrize("step", [0, 1])
def test_params_after_steps_match_jax(jax_run, port_run, step):
    moved = max(float((jax_run["params"][step][n] - w).abs().max())
                for n, w in jax_run["unet0"].items())
    assert moved > 0.5 * LR  # warmup is off: every step moves them
    _assert_state_close(port_run["params"][step], jax_run["params"][step],
                        step + 1, f"params after step {step}")


def test_ema_after_two_steps_matches_jax(jax_run, port_run):
    _assert_state_close(port_run["ema2"], jax_run["ema2"], 2, "EMA")


def test_linear_adam_step_matches_jax_gradients(jax_run):
    """adam_epsilon = 1: the first update is lr * g / (|g| + 1), so the
    parameters after one step carry the gradients' magnitudes."""
    tr = _port_trainer(*jax_run["lin_cfgs"], jax_run["unet0"],
                       jax_run["vae"])
    assert tr.opt.lr == 1.0
    tr.training_step(0, jax_run["batches"][0], jax_draws(0))
    p0, want = jax_run["unet0"], jax_run["lin_params"]
    upd_j = {n: want[n] - p0[n] for n in p0}
    largest = max(float(u.abs().max()) for u in upd_j.values())
    assert largest > 1e-2
    for n, p in tr.unet.named_parameters():
        err = float(((p.detach() - p0[n]) - upd_j[n]).abs().max())
        tol = 1e-4 * float(upd_j[n].abs().max()) + 1e-6 * largest
        assert err <= tol, f"{n}: {err} > {tol}"


# -- remat, draws, checkpoints ------------------------------------------------

def _run(tr, batches):
    return [tr.training_step(i, b) for i, b in enumerate(batches)]


@pytest.fixture(scope="module")
def port_batches():
    ds = PT.SyntheticDataset(resolution=RES, length=16)
    return [b for _, b in zip(range(2), PT.epoch_batches(ds, N_BATCH))]


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_match_no_checkpointing(tmp_path, port_batches,
                                               policy):
    base, cfg = _jax_cfgs(tmp_path)
    want = _run(_port_trainer(base, cfg), port_batches)
    tr = _port_trainer(base, cfg, gradient_checkpointing=True,
                       remat_policy=policy)
    assert tr.unet_apply is not tr.unet
    got = _run(tr, port_batches)
    for g, w in zip(got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (k, g[k], w[k])


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        PT.remat_policy("everything")


def test_draws_follow_seed_and_step(tmp_path):
    tr = _port_trainer(*_jax_cfgs(tmp_path))
    a, b, c = tr.draw(3, N_BATCH), tr.draw(3, N_BATCH), tr.draw(4, N_BATCH)
    assert torch.equal(a["noise"], b["noise"]) and a["ti"] == b["ti"]
    assert not torch.equal(a["noise"], c["noise"])
    assert a["noise"].shape == (N_BATCH, 4, RES // RATIO, RES // RATIO)
    assert a["t"].shape == (N_BATCH,) and int(a["t"].max()) < 100
    for d in (a, c):
        for off in (d["ti"], d["tj"]):
            assert abs(off) <= RES * 0.75 // 2 / RATIO
            assert (off * RATIO) == int(off * RATIO)


def test_checkpoint_resume_continues_the_run(tmp_path, port_batches):
    """Two steps; save; a fresh trainer (UNet zeroed) restored from the
    checkpoint takes the third step exactly as the unbroken run does. The
    frozen VAE is not part of the training state: it comes from the seed
    or ``vae_path``, as in the JAX package."""
    base, cfg = _jax_cfgs(tmp_path)
    tr = _port_trainer(base, cfg)
    _run(tr, port_batches)
    path = PT.save_checkpoint(str(tmp_path), 2, tr.state_for_checkpoint())
    want = tr.training_step(2, port_batches[0])
    other = _port_trainer(base, cfg)
    with torch.no_grad():
        for p in other.unet.parameters():
            p.zero_()
    other.load_state(PT.restore_checkpoint(path))
    assert other.step == 2 and other.ema.step == 2
    assert other.training_step(2, port_batches[0]) == want
    for p, q in zip(tr.unet.parameters(), other.unet.parameters()):
        assert torch.equal(p, q)


def test_checkpoint_rotation_and_latest(tmp_path):
    state = {"a": torch.arange(10.0), "nested": {"b": torch.ones(2, 3)}}
    for step in (10, 20, 30, 40):
        PT.save_checkpoint(str(tmp_path), step,
                           {"a": state["a"] * step,
                            "nested": {"b": state["nested"]["b"] * step}},
                           total_limit=2)
    dirs = sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("checkpoint-"))
    assert dirs == ["checkpoint-30", "checkpoint-40"]
    latest = PT.latest_checkpoint(str(tmp_path))
    assert latest.endswith("checkpoint-40")
    assert PT.resume_step_from_path(latest) == 40
    got = PT.restore_checkpoint(latest)
    assert torch.equal(got["nested"]["b"], torch.ones(2, 3) * 40)
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        PT.restore_checkpoint(str(tmp_path))


def test_save_pipeline_layout(tmp_path):
    tr = _port_trainer(*_jax_cfgs(tmp_path))
    tr.save_pipeline(str(tmp_path / "pipe"))
    names = set(os.listdir(tmp_path / "pipe"))
    assert {"unet_config.json", "scheduler_config.json", "vae_config.json",
            "checkpoint-0"} <= names
    state = PT.restore_checkpoint(PT.latest_checkpoint(str(tmp_path /
                                                           "pipe")))
    assert set(state) == {"unet", "unet_ema", "vae"}
    assert set(state["unet_ema"]) == set(state["unet"])
    # an LDM run's directory serves as a vae_path / unet_path
    again = _port_trainer(*_jax_cfgs(tmp_path))
    again.cfg.vae_path = again.cfg.unet_path = str(tmp_path / "pipe")
    again.init_params(seed=7)
    for k, v in again.vae.state_dict().items():
        assert torch.equal(v, state["vae"][k])


def test_validate_samples(tmp_path):
    tr = _port_trainer(*_jax_cfgs(tmp_path))
    imgs = tr.validate(0, num_images=2, num_steps=2)["samples"]
    assert imgs.shape == (2, RES, RES, 3) and np.isfinite(imgs).all()


def test_training_after_sampling_in_one_process(tmp_path, port_batches):
    """Sampling (inference mode) first builds the cached circulant
    operators; a training step after it must still be able to save them
    for backward."""
    from afldm_tpu_torch.ops import filtered_act, ideal_lpf
    ideal_lpf._DEV_OPS.clear()
    filtered_act._KERNEL_OPS.clear()
    tr = _port_trainer(*_jax_cfgs(tmp_path))
    tr.validate(0, num_images=1, num_steps=1)
    assert all(not t.is_inference() for t in ideal_lpf._DEV_OPS.values())
    logs = tr.training_step(0, port_batches[0])
    assert np.isfinite(logs["train_loss"])


# -- schedulers, shifter, EMA, optimizer --------------------------------------

def test_ddpm_add_noise_and_velocity_match_jax(rng):
    j, p = JaxDDPM.from_config(SCHED_CFG), DDPMScheduler.from_config(
        SCHED_CFG)
    x, n = rand(rng, (4, 8, 8, 4)), rand(rng, (4, 8, 8, 4))
    t = np.array([0, 17, 99, -1])
    for name in ("add_noise", "get_velocity"):
        want = getattr(j, name)(jnp.asarray(x), jnp.asarray(n),
                                jnp.asarray(t))
        got = getattr(p, name)(nchw(x), nchw(n), torch.from_numpy(t))
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction", "sample"])
def test_ddpm_step_matches_jax(rng, pred):
    cfg = dict(SCHED_CFG, prediction_type=pred, clip_sample=True)
    j, p = JaxDDPM.from_config(cfg), DDPMScheduler.from_config(cfg)
    j.set_timesteps(10)
    p.set_timesteps(10)
    out, x = rand(rng, (2, 8, 8, 4)), rand(rng, (2, 8, 8, 4))
    for t in (90, 0):
        want = j.step(jnp.asarray(out), t, jnp.asarray(x))
        got = p.step(nchw(out), t, nchw(x))
        for a, b in zip(got, want):
            np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_ddpm_step_noise_only_above_zero(rng):
    p = DDPMScheduler.from_config(SCHED_CFG)
    out, x = (nchw(rand(rng, (1, 4, 4, 4))) for _ in range(2))
    quiet, _ = p.step(out, 0, x)
    noisy, _ = p.step(out, 0, x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(quiet, noisy)
    noisy, _ = p.step(out, 50, x, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(noisy, p.step(out, 50, x)[0])


@pytest.mark.parametrize("ti,tj", [(1.5, -2.0), (-3.5, 0.5), (0.0, 3.0)])
def test_ideal_shifter_matches_jax(rng, ti, tj):
    x = rand(rng, (2, 8, 8, 4))
    js = JaxShifter("ideal", 2)
    want, wmask = js.shift(jnp.asarray(x), ti, tj,
                           cache=js.precompute(jnp.asarray(x)))
    ps = ImageShifter("ideal", 2)
    got, mask = ps.shift(nchw(x), ti, tj, cache=ps.precompute(nchw(x)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    assert torch.equal(mask, torch.ones_like(got))
    assert np.asarray(wmask).min() == 1.0


def test_ema_three_updates_match_jax(rng):
    p0 = [rand(rng, (3, 4)), rand(rng, (5,))]
    steps = [[rand(rng, a.shape) for a in p0] for _ in range(3)]
    st = ema_init([jnp.asarray(a) for a in p0])
    ema = PT.EMA([torch.from_numpy(a) for a in p0])
    for new in steps:
        st = ema_update(st, [jnp.asarray(a) for a in new])
        ema.update([torch.from_numpy(a) for a in new])
    assert ema.step == int(st.step) == 3
    for a, b in zip(ema.params, st.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert 0.0 < PT.ema_decay(1) < 0.5
    assert PT.ema_decay(10 ** 9) == pytest.approx(0.9999)


@pytest.mark.parametrize("sched,warmup", [("constant", 3), ("constant", 0),
                                          ("cosine", 2)])
def test_optimizer_matches_optax(rng, sched, warmup):
    """Clip, AdamW and the lr schedule over 8 micro-batches with gradient
    accumulation 2, against the JAX package's optax chain."""
    cfg = JaxLDM(learning_rate=0.1, lr_scheduler=sched,
                 lr_warmup_steps=warmup, max_grad_norm=0.5,
                 adam_weight_decay=0.1)
    p0 = {"w": rand(rng, (4, 3)), "b": rand(rng, (3,))}
    grads = [{k: rand(rng, v.shape) for k, v in p0.items()}
             for _ in range(8)]
    tx = jax_make_optimizer(cfg, total_steps=5, grad_accum=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in ("w", "b")]
    opt = PT.TrainOptimizer(params, PT.LDMTrainingConfig(**asdict(cfg)),
                            total_steps=5, grad_accum=2)
    applied = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(params, ("w", "b")):
            gk = torch.from_numpy(g[k])
            p.grad = gk if p.grad is None else p.grad + gk
        applied.append(opt.step())
        for p, k in zip(params, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=1e-5)
    assert applied == [False, True] * 4


@pytest.mark.parametrize("sched,warmup,total,want", [
    ("constant", 500, None, [0.0, 0.002, 0.004]),
    ("constant", 0, None, [1.0, 1.0, 1.0]),
    ("cosine", 2, 6, [0.0, 0.5, 1.0])])
def test_lr_multiplier_counts_from_zero(sched, warmup, total, want):
    cfg = PT.LDMTrainingConfig(lr_scheduler=sched, lr_warmup_steps=warmup)
    f = PT.trainer.lr_multiplier(cfg, total)
    assert [f(k) for k in range(3)] == pytest.approx(want)
    if sched == "cosine":
        assert f(total) == pytest.approx(0.0, abs=1e-12)


# -- configs, data, factory ---------------------------------------------------

@pytest.mark.parametrize("rel", ["configs/vae/train_afvae_imagenet.json",
                                 "configs/ldm/train_unet_ffhq.json",
                                 "configs/sr/train_i2sb_imagenet.json"])
def test_repo_training_configs_load(rel):
    from afldm_tpu.train import load_training_config as jax_load
    got = PT.load_training_config(str(REPO / rel))
    want = jax_load(str(REPO / rel))
    assert set(got) == set(want)
    for k in want:
        assert asdict(got[k]) == asdict(want[k])


def test_config_needs_one_trainer_key(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"base": {}, "ldm": {}, "vae": {}}))
    with pytest.raises(ValueError, match="exactly one"):
        PT.load_training_config(str(p))


@pytest.mark.parametrize("name", ["i2sb", "sd_text", "norm_controlnet"])
def test_unported_trainers_raise(name):
    """These three trainers raised until they were ported; each now builds
    on the CPU (its tiny modules, optimizer state and first draws), and an
    unknown name still raises."""
    from test_train_sd import TINY_SD, TINY_VAE as SD_VAE
    base = PT.BaseTrainingConfig(resolution=RES, train_batch_size=2, seed=0)
    tr = PT.create_trainer(name, base, {
        "i2sb": PT.I2SBLDMTrainingConfig(),
        "sd_text": PT.SDTextTrainingConfig(),
        "norm_controlnet": PT.NormControlNetConfig()}[name], device="cpu")
    if name == "i2sb":
        vae, unet = _port_configs()
        tr.init_modules(vae_config=vae, unet_config=unet, scheduler_config=(
            json.loads((REPO / "configs/sr/i2sb_scheduler.json").read_text())))
    else:
        kw = dict(vae_config=PM.AutoencoderKLConfig(**asdict(SD_VAE)),
                  unet_config=PM.UNet2DConditionConfig(**asdict(TINY_SD)))
        tr.init_modules(**kw, **({"text_encoder": object()}
                                 if name == "sd_text" else {}))
    tr.init_optimizers(10)
    tr.prepare_modules(seed=0)
    assert tr.device.type == "cpu" and tr.step == 0
    assert all(p.device.type == "cpu" for p in tr.unet.parameters())
    assert tr.draw(0, 2)["ti"] == tr.draw(0, 2)["ti"]
    with pytest.raises(ValueError, match="unknown trainer"):
        PT.create_trainer(name + "_x", PT.BaseTrainingConfig(), None,
                          device="cpu")


@pytest.mark.parametrize("field,value", [
    ("mixed_precision", "bf16"), ("model_parallel", 2), ("fsdp", True),
    ("af_precision", "high")])
def test_trainer_rejects_unported_options(field, value):
    """Options the port does not have raise; ``af_precision`` 'high' and
    ``mixed_precision`` 'bf16', once refused too, now build the trainer:
    the level set, or the models computing in bfloat16 on float32
    parameters."""
    base = PT.BaseTrainingConfig(**{field: value})
    if field == "mixed_precision":
        tr = PT.create_trainer("ldm", base, PT.LDMTrainingConfig(),
                               device="cpu")
        vae, unet = _port_configs()
        tr.init_modules(vae_config=vae, unet_config=unet,
                        scheduler_config=SCHED_CFG)
        assert tr.weight_dtype == tr.unet.dtype == tr.vae.dtype \
            == torch.bfloat16
        assert all(p.dtype == torch.float32
                   for m in (tr.unet, tr.vae) for p in m.parameters())
        return
    if field == "af_precision":
        from afldm_tpu_torch.ops import ideal_lpf
        try:
            tr = PT.create_trainer("ldm", base, PT.LDMTrainingConfig(),
                                   device="cpu")
            assert tr.device.type == "cpu"
            assert ideal_lpf.af_precision() == value
        finally:
            ideal_lpf.set_af_precision("highest")
        return
    with pytest.raises((NotImplementedError, ValueError)):
        PT.create_trainer("ldm", base, PT.LDMTrainingConfig(), device="cpu")


def test_vq_autoencoder_raises():
    tr = PT.create_trainer("ldm", PT.BaseTrainingConfig(),
                           PT.LDMTrainingConfig(is_vqvae=True), device="cpu")
    with pytest.raises(NotImplementedError, match="vq"):
        tr.init_modules()


def test_trainer_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.create_trainer("ldm", PT.BaseTrainingConfig(),
                          PT.LDMTrainingConfig())


@pytest.mark.parametrize("make", [
    lambda m: m.SyntheticDataset(resolution=16, length=8, seed=3),
    lambda m: m.DeadLeavesDataset(resolution=32, length=4, seed=1)],
    ids=["synthetic", "dead_leaves"])
def test_datasets_and_batches_match_jax(make):
    import afldm_tpu.train as jt
    got = list(PT.epoch_batches(make(PT), 2, seed=5))
    want = list(jax_epoch_batches(make(jt), 2, seed=5))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["input"], w["input"])


def test_make_dataset_falls_back_to_synthetic(tmp_path):
    base = PT.BaseTrainingConfig(train_data_dir=str(tmp_path / "none"),
                                 resolution=32)
    ds = PT.make_dataset(base)
    assert isinstance(ds, PT.SyntheticDataset) and ds.resolution == 32


def test_image_folder_dataset(tmp_path):
    from PIL import Image
    arr = (np.arange(40 * 30 * 3) % 255).astype(np.uint8).reshape(40, 30, 3)
    Image.fromarray(arr).save(tmp_path / "a.png")
    ds = PT.ImageFolderDataset(str(tmp_path), resolution=16)
    img = ds[0]["input"]
    assert img.shape == (16, 16, 3) and -1 <= img.min() <= img.max() <= 1


# -- the CLI ------------------------------------------------------------------

def _tiny_cli_config(tmp_path, **base):
    ucfg = {"sample_size": 8, "in_channels": 4, "out_channels": 4,
            "down_block_types": ["AttnDownBlock2D", "DownBlock2D"],
            "up_block_types": ["UpBlock2D", "AttnUpBlock2D"],
            "block_out_channels": [8, 16], "layers_per_block": 1,
            "attention_head_dim": 4, "norm_num_groups": 4}
    vcfg = {"block_out_channels": [8, 8], "layers_per_block": 1,
            "latent_channels": 4, "norm_num_groups": 4, "sample_size": 16,
            "scaling_factor": 0.6, "up_rescale": [True],
            "down_filtered_act": [False, True],
            "up_filtered_act": [True, False]}
    (tmp_path / "unet.json").write_text(json.dumps(ucfg))
    (tmp_path / "vae").mkdir(exist_ok=True)
    (tmp_path / "vae" / "config.json").write_text(json.dumps(vcfg))
    (tmp_path / "sched.json").write_text(json.dumps(SCHED_CFG))
    cfg = {"base": {"logging_dir": "logs", "output_dir": str(tmp_path / "o"),
                    "train_batch_size": 2, "resolution": 16,
                    "num_epochs": 1, "checkpointing_steps": 2,
                    "save_model_epochs": 1, "seed": 0,
                    "gradient_checkpointing": True,
                    "resume_from_checkpoint": "latest", **base},
           "ldm": {"vae_path": str(tmp_path / "vae"),
                   "scheduler_path": str(tmp_path / "sched.json"),
                   "unet_config": str(tmp_path / "unet.json"),
                   "af_models": True, "use_shift_loss": True,
                   "use_ema": True, "learning_rate": 1e-3}}
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    return p


def test_train_cli_runs_and_resumes(tmp_path):
    from afldm_tpu_torch.scripts import train as cli
    cfg = _tiny_cli_config(tmp_path)
    assert cli.main([str(cfg), "--device", "cpu", "--max_steps", "2"]) == 2
    out = tmp_path / "o"
    assert (out / "checkpoint-2").is_dir()
    assert (out / "pipeline" / "unet_config.json").exists()
    # resume from latest: picks up at step 2 and stops at 3
    assert cli.main([str(cfg), "--device", "cpu", "--max_steps", "3"]) == 3
    assert sorted(d for d in os.listdir(out)
                  if d.startswith("checkpoint-")) == ["checkpoint-2",
                                                       "checkpoint-3"]


def test_train_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    from afldm_tpu_torch.scripts import train as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(_tiny_cli_config(tmp_path)), "--max_steps", "1"])
