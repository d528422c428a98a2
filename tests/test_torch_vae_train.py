"""The port's AF-VAE training path against the JAX package, on the CPU at
the tiny sizes of ``tests/test_train.py``: the model pieces VAE training
adds (``AutoencoderKL.forward`` and its remat option, ``gaussian_kl``,
``perceptual_loss``, ``pooled_feature_vector``, the ``Discriminator`` and
the hinge losses, ``FeatureStats`` and ``frechet_distance``), then the
trainer step as a whole, given the JAX step's own random draws (reproduced
from ``fold_in(PRNGKey(seed), step)`` and split as
``afldm_tpu/train/vae_trainer.py`` splits them) and the JAX weights carried
across with ``from_flax``; then the remat policies, checkpoints, the CLI
and the hand-over of a saved VAE to the LDM trainer.

Tolerances:
- models: 1e-4 of the output's scale (f32 through a few convs, FFT
  resampling and the filtered activations, summed in another order);
  scalar losses 1e-5 relative;
- logged step losses: 1e-5 relative (f32 rounding in another order);
  the adaptive GAN weight 1e-4 relative (a ratio of two gradient norms);
- parameters and EMA after one and two AdamW updates (lr 1e-4, warmup
  off): 1e-5 absolute. Adam's first update is lr * sign(g) wherever |g|
  is well above its epsilon, so an element whose gradient is within
  rounding of zero can move by lr the other way: at most 1 % of a
  tensor's elements may do so, each by at most 2 lr per update (one
  encoder conv weight of 576 has a gradient 4e-5 of its tensor's
  largest). Where the gradient is zero in exact arithmetic, the whole
  tensor is held to 2 lr per update: the mid-block attention's ``to_k``
  bias (softmax ignores a shift of every key);
- the GAN run uses ``adam_epsilon=1`` and ``max_grad_norm=1e6`` (lr 1e-2,
  no weight decay), where an update is smooth in the gradients and so
  checks their magnitudes: each tensor's move within 1e-4 of its largest,
  plus 1e-6 of the largest move of all tensors, plus two f32 ulps of the
  tensor's magnitude (the norm scales sit near 1);
- remat against no checkpointing: 1e-6 relative (the same arithmetic,
  recomputed).
"""

import json
import os
from dataclasses import asdict

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.models import (AutoencoderKL as JaxVAE, Discriminator as
                              JaxDisc, gaussian_kl as jax_kl,
                              gaussian_sample as jax_sample)
from afldm_tpu.models.discriminator import (hinge_d_loss as jax_hinge_d,
                                            hinge_g_loss as jax_hinge_g)
from afldm_tpu.train import (BaseTrainingConfig as JaxBase,
                             SyntheticDataset as JaxSynthetic,
                             VAETrainingConfig as JaxVAECfg,
                             create_trainer as jax_create_trainer,
                             epoch_batches as jax_epoch_batches)
from afldm_tpu.train import perceptual as jax_perceptual
from afldm_tpu.utils import metric_utils as jax_metrics
from afldm_tpu_torch import models as PM
from afldm_tpu_torch import train as PT
from afldm_tpu_torch.train import perceptual as PP
from afldm_tpu_torch.utils import FeatureStats, frechet_distance
from test_perceptual import _fake_vgg_checkpoint
from test_torch_harness import (REPO, assert_rel_close, jax_apply,
                                jax_init, load_port, nchw, nhwc, port_state,
                                rand)
from test_train import TINY_UNET_CFG, SCHED_CFG, TINY_VAE_CFG

torch.set_num_threads(1)

LR = 1e-4
N_BATCH, RES, RATIO = 4, 16, 2
DISC = {"depth": 2, "hidden_channels": 16}
F32_EPS = float(np.finfo(np.float32).eps)


def _port_vae_config():
    return PM.AutoencoderKLConfig(**asdict(TINY_VAE_CFG))


# -- model pieces -------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_pair():
    jm = JaxVAE(TINY_VAE_CFG)
    p = jax_init(jm, jnp.zeros((1, RES, RES, 3)))
    return jm, p, load_port(PM.AutoencoderKL(_port_vae_config()), p)


def test_vae_forward_matches_jax(vae_pair):
    jm, p, tm = vae_pair
    x = rand(np.random.default_rng(1), (2, RES, RES, 3))
    want = jax_apply(jm)(p, jnp.asarray(x))
    got = tm(nchw(x))
    for g, w, what in zip(got, want, ("recon", "mean", "logvar")):
        assert_rel_close(nhwc(g), w, 1e-4, what)


def test_vae_forward_samples_from_generator(vae_pair):
    _, _, tm = vae_pair
    x = nchw(rand(np.random.default_rng(2), (1, RES, RES, 3)))
    recon, mean, logvar = tm(x, sample_posterior=True,
                             generator=torch.Generator().manual_seed(5))
    z = PM.gaussian_sample(mean, logvar, torch.Generator().manual_seed(5))
    torch.testing.assert_close(recon, tm.decode(z))


def test_vae_remat_keeps_names_and_gradients(vae_pair):
    """remat=True checkpoints each down/up resnet: the same state dict
    loads and the same gradients come out."""
    _, p, tm = vae_pair
    rm = load_port(PM.AutoencoderKL(_port_vae_config(), remat=True), p)
    assert set(rm.state_dict()) == set(tm.state_dict())
    x = nchw(rand(np.random.default_rng(3), (2, RES, RES, 3)))
    grads = []
    for m in (tm, rm):
        m.zero_grad()
        recon, mean, _ = m(x)
        (recon.square().mean() + mean.square().mean()).backward()
        grads.append({n: q.grad.clone() for n, q in m.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, atol=1e-7, rtol=1e-6)


def test_gaussian_kl_matches_jax(rng):
    mean, logvar = rand(rng, (3, 4, 4, 2)), rand(rng, (3, 4, 4, 2))
    want = float(jax_kl(jnp.asarray(mean), jnp.asarray(logvar)))
    got = float(PM.gaussian_kl(nchw(mean), nchw(logvar)))
    assert abs(got - want) <= 1e-5 * abs(want)


def _vgg_stages(tmp_path, module):
    ckpt = tmp_path / "vgg16.pth"
    _fake_vgg_checkpoint(str(ckpt))
    return module.load_lpips_vgg_features(str(ckpt), set_default=False)


@pytest.mark.parametrize("bank", ["random", "vgg"])
def test_perceptual_loss_and_grad_match_jax(rng, tmp_path, bank):
    a, b = rand(rng, (2, 32, 32, 3)), rand(rng, (2, 32, 32, 3))
    jf = None if bank == "random" else _vgg_stages(tmp_path, jax_perceptual)
    pf = None if bank == "random" else _vgg_stages(tmp_path, PP)
    want, want_g = jax.value_and_grad(
        lambda x: jax_perceptual.perceptual_loss(x, jnp.asarray(b), jf))(
        jnp.asarray(a))
    xa = nchw(a).requires_grad_()
    got = PP.perceptual_loss(xa, nchw(b), pf)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * float(want)
    assert_rel_close(nhwc(xa.grad), want_g, 1e-4, "perceptual grad")


def test_random_bank_is_the_jax_bank():
    for (w,), (v,) in zip(PP._filters(), jax_perceptual._filters()):
        np.testing.assert_array_equal(w, v)


@pytest.mark.parametrize("bank", ["random", "vgg"])
def test_pooled_feature_vector_matches_jax(rng, tmp_path, bank):
    x = rand(rng, (3, 32, 32, 3))
    jf = None if bank == "random" else _vgg_stages(tmp_path, jax_perceptual)
    pf = None if bank == "random" else _vgg_stages(tmp_path, PP)
    want = jax_perceptual.pooled_feature_vector(jnp.asarray(x), jf)
    got = PP.pooled_feature_vector(nchw(x), pf)
    assert_rel_close(got.numpy(), want, 1e-5, "pooled features")


def test_load_lpips_rejects_non_vgg(tmp_path):
    torch.save({"foo.weight": torch.zeros((2, 2))}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="not a VGG16"):
        PP.load_lpips_vgg_features(str(tmp_path / "x.pth"))


@pytest.mark.parametrize("kw", [{}, {"antialias": True},
                                {"antialias": True, "mod_act": False}],
                         ids=["plain", "antialias", "antialias_plain_act"])
def test_discriminator_matches_jax(rng, kw):
    """The Flax parameters load under strict=True (conv_0.. -> conv.0..)."""
    jd = JaxDisc(hidden_channels=32, depth=4, **kw)
    x = rand(rng, (2, 64, 64, 3))
    p = jax_init(jd, jnp.zeros((1, 64, 64, 3)))
    td = load_port(PM.Discriminator(hidden_channels=32, depth=4, **kw), p)
    want = jax_apply(jd)(p, jnp.asarray(x))
    got = td(nchw(x))
    assert_rel_close(nhwc(got), want, 1e-4, "logits")


def test_discriminator_bn_arm_raises():
    with pytest.raises(NotImplementedError, match="use_bn"):
        PM.Discriminator(use_bn=True)


def test_hinge_losses_match_jax(rng):
    real, fake = rand(rng, (2, 3, 3, 1)), rand(rng, (2, 3, 3, 1))
    want_d = float(jax_hinge_d(jnp.asarray(real), jnp.asarray(fake)))
    want_g = float(jax_hinge_g(jnp.asarray(fake)))
    assert float(PM.hinge_d_loss(nchw(real), nchw(fake))) == \
        pytest.approx(want_d, rel=1e-6)
    assert float(PM.hinge_g_loss(nchw(fake))) == pytest.approx(want_g,
                                                                rel=1e-6)


def test_feature_stats_and_frechet_match_jax(rng):
    a, b = rand(rng, (40, 6)), rand(rng, (30, 6)) + 0.5
    pa, pb = (FeatureStats(capture_mean_cov=True) for _ in range(2))
    ja, jb = (jax_metrics.FeatureStats(capture_mean_cov=True)
              for _ in range(2))
    for x, p, j in ((a, pa, ja), (b, pb, jb)):
        p.append(torch.from_numpy(x[:10]))
        p.merge(FeatureStats(capture_mean_cov=True))
        part = FeatureStats(capture_mean_cov=True)
        part.append(x[10:])
        p.merge(part)
        j.append(x)
    for p, j in ((pa, ja), (pb, jb)):
        for u, v in zip(p.get_mean_cov(), j.get_mean_cov()):
            np.testing.assert_allclose(u, v, rtol=1e-12, atol=1e-12)
    want = jax_metrics.frechet_distance(ja, jb)
    assert frechet_distance(pa, pb) == pytest.approx(want, rel=1e-9)
    assert frechet_distance(pa, pa) == pytest.approx(0.0, abs=1e-6)


# -- the training step against JAX --------------------------------------------

def _jax_cfgs(tmp, **vae):
    base = JaxBase(output_dir=str(tmp), resolution=RES,
                   train_batch_size=N_BATCH, num_epochs=1, seed=0)
    cfg = JaxVAECfg(**{"model_cfg": "", "use_shift_loss": True,
                       "use_ema": True, "learning_rate": LR,
                       "lr_warmup_steps": 0, **vae})
    return base, cfg


def _port_trainer(base, cfg, vae_state=None, disc_state=None, **base_kw):
    """A tiny port VAETrainer on the CPU from JAX config dataclasses (same
    field names), with the given weights."""
    pb = PT.BaseTrainingConfig(**{**asdict(base), **base_kw})
    pc = PT.VAETrainingConfig(**asdict(cfg))
    tr = PT.create_trainer("vae", pb, pc, device="cpu")
    tr.init_modules(vae_config=_port_vae_config(),
                    disc_config=DISC if pc.use_disc else None)
    tr.init_optimizers(100)
    tr.prepare_modules(vae_state=vae_state, disc_state=disc_state)
    return tr


def jax_draws(step, seed=0):
    """The JAX step's draws for ``step``, as NCHW tensors and ints."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k_s1, k_s2, k_off1, k_off2 = jax.random.split(key, 4)
    lat = (N_BATCH, RES // RATIO, RES // RATIO, 4)
    max_off = int(RES * 0.75 // 2)
    ti, tj = (int(jax.random.randint(k, (), -max_off, max_off + 1))
              for k in (k_off1, k_off2))
    return {"eps": nchw(jax.random.normal(k_s1, lat)),
            "eps_shift": nchw(jax.random.normal(k_s2, lat)),
            "eps_disc": nchw(jax.random.normal(key, lat)),
            "ti": ti, "tj": tj}


def _jax_d_weight_fn(tr):
    """The JAX step's adaptive GAN weight, from its own formula, jitted
    once for the trainer."""
    model, disc = tr.model, tr.discriminator

    @jax.jit
    def d_weight(params, dparams, x, key):
        k_s1 = jax.random.split(key, 4)[0]

        def recon(p):
            mean, logvar = model.apply(p, x, method="encode")
            return model.apply(p, jax_sample(k_s1, mean, logvar),
                               method="decode")

        def rec_loss(p):
            r = recon(p)
            return (jnp.mean((x - r) ** 2)
                    + jax_perceptual.perceptual_loss(x, r))

        def g_loss(p):
            return -jnp.mean(disc.apply(dparams, recon(p)))

        out = lambda g: g["params"]["decoder"]["conv_out"]["kernel"]  # noqa
        nll = out(jax.grad(rec_loss)(params))
        gan = out(jax.grad(g_loss)(params))
        return jnp.clip(jnp.linalg.norm(nll) / (jnp.linalg.norm(gan) + 1e-4),
                        0.0, 1e4)
    return d_weight


def _run_jax(tr, batches, with_disc=False):
    out = {"logs": [], "params": [], "disc": [], "d_weight": []}
    d_weight = _jax_d_weight_fn(tr) if with_disc else None
    for i, b in enumerate(batches):
        if with_disc and i % 2 == 0:  # accumulation 1: generator steps
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            out["d_weight"].append(float(d_weight(
                tr.state.params, tr.disc_state.params,
                jnp.asarray(b["input"]), key)))
        out["logs"].append(tr.training_step(i, b))
        out["params"].append(port_state(tr.state.params))
        if with_disc:
            out["disc"].append(port_state(tr.disc_state.params))
    out["ema"] = port_state(tr.state.ema_params)
    return out


# the GAN run's optimizer: with adam_epsilon = 1 an update is
# lr * m / (sqrt(v) + 1), smooth in the gradients, so the parameters carry
# the gradients' magnitudes and not only their signs
LINEAR_ADAM = dict(learning_rate=1e-2, adam_epsilon=1.0, max_grad_norm=1e6,
                   adam_weight_decay=0.0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Both JAX trainers, compiled once for the module: the default
    (gradient accumulation 2, no GAN) over four micro-batches, that is two
    updates; and with the discriminator (accumulation 1, ``LINEAR_ADAM``)
    over generator, discriminator, generator, discriminator."""
    tmp = tmp_path_factory.mktemp("jax")
    ds = JaxSynthetic(resolution=RES, length=32)
    batches = [b for _, b in zip(range(4), jax_epoch_batches(ds, N_BATCH))]
    out = {"batches": batches}

    base, cfg = _jax_cfgs(tmp)
    tr = jax_create_trainer("vae", base, cfg)
    tr.init_modules(vae_config=TINY_VAE_CFG)
    tr.init_optimizers(100)
    tr.prepare_modules()
    out["cfgs"], out["vae0"] = (base, cfg), port_state(tr.state.params)
    out["plain"] = _run_jax(tr, batches)

    base, cfg = _jax_cfgs(tmp, use_disc=True, gradient_accumulation_steps=1,
                          **LINEAR_ADAM)
    tr = jax_create_trainer("vae", base, cfg)
    tr.init_modules(vae_config=TINY_VAE_CFG, disc_config=DISC)
    tr.init_optimizers(100)
    tr.prepare_modules()
    out["disc_cfgs"] = (base, cfg)
    out["disc_vae0"] = port_state(tr.state.params)
    out["disc0"] = port_state(tr.disc_state.params)
    out["gan"] = _run_jax(tr, batches, with_disc=True)
    return out


def _run_port(tr, batches):
    out = {"logs": [], "params": [], "disc": []}
    for i, b in enumerate(batches):
        out["logs"].append(tr.training_step(i, b, jax_draws(i)))
        out["params"].append({n: p.detach().clone()
                              for n, p in tr.vae.named_parameters()})
        if tr.disc is not None:
            out["disc"].append({n: p.detach().clone()
                                for n, p in tr.disc.named_parameters()})
    out["ema"] = tr._ema_state()
    return out


@pytest.fixture(scope="module")
def port_run(jax_run):
    base, cfg = jax_run["cfgs"]
    out = {"plain": _run_port(_port_trainer(base, cfg, jax_run["vae0"]),
                              jax_run["batches"])}
    base, cfg = jax_run["disc_cfgs"]
    out["gan"] = _run_port(_port_trainer(base, cfg, jax_run["disc_vae0"],
                                         jax_run["disc0"]),
                           jax_run["batches"])
    return out


GEN_KEYS = ["train_loss", "mse_loss", "perceptual_loss", "kl_loss",
            "shift_loss"]


@pytest.mark.parametrize("step", [0, 1, 2, 3])
@pytest.mark.parametrize("key", GEN_KEYS)
def test_step_losses_match_jax(jax_run, port_run, step, key):
    want = jax_run["plain"]["logs"][step][key]
    got = port_run["plain"]["logs"][step][key]
    assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)


def _assert_state_close(got: dict, want: dict, updates: int, what: str):
    assert set(got) == set(want)
    for n, w in want.items():
        err = (got[n] - w).abs()
        worst = float(err.max())
        if n.endswith("to_k.bias"):
            assert worst <= 2 * LR * updates, f"{what} {n}: {worst}"
            continue
        off = int((err > 1e-5).sum())
        assert off <= 0.01 * w.numel() and worst <= max(1e-5,
                                                         2 * LR * updates), \
            f"{what} {n}: {off} elements off by > 1e-5, max err {worst}"


def _assert_updates_close(got: dict, want: dict, start: dict, what: str):
    """Each tensor's move from ``start`` within 1e-4 of JAX's largest move
    in that tensor, plus 1e-6 of the largest move of all tensors, plus two
    f32 ulps of the tensor's magnitude (norm scales sit near 1)."""
    assert set(got) == set(want)
    upd = {n: want[n] - start[n] for n in want}
    largest = max(float(u.abs().max()) for u in upd.values())
    assert largest > 1e-3
    for n, u in upd.items():
        err = float(((got[n] - start[n]) - u).abs().max())
        tol = (1e-4 * float(u.abs().max()) + 1e-6 * largest
               + 2 * F32_EPS * float(want[n].abs().max()))
        assert err <= tol, f"{what} {n}: {err} > {tol}"


@pytest.mark.parametrize("step,updates", [(0, 0), (1, 1), (3, 2)])
def test_params_after_updates_match_jax(jax_run, port_run, step, updates):
    """Accumulation 2: micro-batch 0 leaves the weights, 1 and 3 update."""
    want = jax_run["plain"]["params"][step]
    moved = max(float((want[n] - w).abs().max())
                for n, w in jax_run["vae0"].items())
    assert (moved > 0.5 * LR) == (updates > 0)
    _assert_state_close(port_run["plain"]["params"][step], want, updates,
                        f"params after micro-batch {step}")


def test_ema_matches_jax(jax_run, port_run):
    _assert_state_close(port_run["plain"]["ema"], jax_run["plain"]["ema"], 2,
                        "EMA")


@pytest.mark.parametrize("step", [0, 2])
@pytest.mark.parametrize("key", GEN_KEYS + ["disc_loss"])
def test_gan_generator_losses_match_jax(jax_run, port_run, step, key):
    want = jax_run["gan"]["logs"][step][key]
    got = port_run["gan"]["logs"][step][key]
    # disc_loss is a mean of logits of either sign: 1e-6 absolute beside
    # the relative limit
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-6, (key, got, want)


@pytest.mark.parametrize("i,step", [(0, 0), (1, 2)])
def test_gan_d_weight_matches_jax(jax_run, port_run, i, step):
    want = jax_run["gan"]["d_weight"][i]
    got = port_run["gan"]["logs"][step]["d_weight"]
    assert want > 0 and abs(got - want) <= 1e-4 * want, (got, want)


@pytest.mark.parametrize("step", [1, 3])
def test_disc_step_matches_jax(jax_run, port_run, step):
    want = jax_run["gan"]["logs"][step]["train_loss_disc"]
    got = port_run["gan"]["logs"][step]["train_loss_disc"]
    assert set(port_run["gan"]["logs"][step]) == {"train_loss_disc"}
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    _assert_updates_close(port_run["gan"]["disc"][step],
                          jax_run["gan"]["disc"][step], jax_run["disc0"],
                          "discriminator")


@pytest.mark.parametrize("step", [0, 2])
def test_gan_params_match_jax(jax_run, port_run, step):
    """The generator's updates (the losses, the GAN term with its adaptive
    weight and the gradients' magnitudes); it does not move on the
    discriminator's steps."""
    got, want = port_run["gan"]["params"], jax_run["gan"]["params"]
    _assert_updates_close(got[step], want[step], jax_run["disc_vae0"],
                          f"VAE after step {step}")
    assert all(torch.equal(got[step + 1][n], p)
               for n, p in got[step].items())


# -- remat, draws, checkpoints, export ----------------------------------------

@pytest.fixture(scope="module")
def port_batches():
    ds = PT.SyntheticDataset(resolution=RES, length=16)
    return [b for _, b in zip(range(2), PT.epoch_batches(ds, N_BATCH))]


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_match_no_checkpointing(tmp_path, port_batches,
                                               policy):
    base, cfg = _jax_cfgs(tmp_path, use_disc=True,
                          gradient_accumulation_steps=1)
    plain = _port_trainer(base, cfg)
    want = [plain.training_step(i, b) for i, b in enumerate(port_batches)]
    tr = _port_trainer(base, cfg, gradient_checkpointing=True,
                       remat_policy=policy)
    assert tr.encode != tr.vae.encode and tr.vae.encoder.down_blocks[0].remat
    got = [tr.training_step(i, b) for i, b in enumerate(port_batches)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (k, g[k], w[k])


def test_draws_follow_seed_and_step(tmp_path):
    tr = _port_trainer(*_jax_cfgs(tmp_path))
    a, b, c = tr.draw(3, N_BATCH), tr.draw(3, N_BATCH), tr.draw(4, N_BATCH)
    assert torch.equal(a["eps"], b["eps"]) and a["ti"] == b["ti"]
    assert not torch.equal(a["eps"], c["eps"])
    assert not torch.equal(a["eps"], a["eps_shift"])
    assert a["eps_disc"].shape == (N_BATCH, 4, RES // RATIO, RES // RATIO)
    for d in (a, c):
        for off in (d["ti"], d["tj"]):
            assert isinstance(off, int) and abs(off) <= RES * 0.75 // 2


def test_generator_and_discriminator_alternate(tmp_path):
    base, cfg = _jax_cfgs(tmp_path, use_disc=True)
    tr = _port_trainer(base, cfg)
    assert cfg.gradient_accumulation_steps == 2
    assert [tr.is_generator_step(s) for s in range(6)] == \
        [True, True, False, False, True, True]
    plain = _port_trainer(*_jax_cfgs(tmp_path))
    assert all(plain.is_generator_step(s) for s in range(4))


@pytest.mark.parametrize("use_disc", [False, True], ids=["plain", "gan"])
def test_checkpoint_resume_continues_the_run(tmp_path, port_batches,
                                             use_disc):
    """Two steps; save; a fresh trainer (weights zeroed) restored from the
    checkpoint takes the next step exactly as the unbroken run does."""
    base, cfg = _jax_cfgs(tmp_path, use_disc=use_disc,
                          gradient_accumulation_steps=1)
    tr = _port_trainer(base, cfg)
    for i, b in enumerate(port_batches):
        tr.training_step(i, b)
    path = PT.save_checkpoint(str(tmp_path), 2, tr.state_for_checkpoint())
    want = [tr.training_step(s, port_batches[0]) for s in (2, 3)]
    other = _port_trainer(base, cfg)
    with torch.no_grad():
        for m in (other.vae, other.disc):
            for p in (m.parameters() if m is not None else []):
                p.zero_()
    other.load_state(PT.restore_checkpoint(path))
    assert other.step == (1 if use_disc else 2)
    assert other.ema.step == other.step
    assert [other.training_step(s, port_batches[0]) for s in (2, 3)] == want
    for p, q in zip(tr.vae.parameters(), other.vae.parameters()):
        assert torch.equal(p, q)


def test_checkpoint_rotation(tmp_path, port_batches):
    tr = _port_trainer(*_jax_cfgs(tmp_path))
    for step in (1, 2, 3):
        PT.save_checkpoint(str(tmp_path), step, tr.state_for_checkpoint(),
                           total_limit=2)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("checkpoint-")) == ["checkpoint-2",
                                                       "checkpoint-3"]
    state = PT.restore_checkpoint(PT.latest_checkpoint(str(tmp_path)))
    assert set(state) == {"vae", "optimizer", "ema", "step"}


@pytest.mark.parametrize("use_ema", [True, False])
def test_save_pipeline_loads_as_ldm_vae_path(tmp_path, port_batches,
                                             use_ema):
    """A VAE run's ``save_pipeline`` directory is an LDM trainer's
    ``vae_path``: its config and (EMA, else plain) weights load under
    strict=True."""
    base, cfg = _jax_cfgs(tmp_path, use_ema=use_ema,
                          gradient_accumulation_steps=1)
    tr = _port_trainer(base, cfg)
    tr.training_step(0, port_batches[0])
    out = tmp_path / "vae_pipe"
    tr.save_pipeline(str(out))
    assert (out / "vae_config.json").exists()
    assert (out / "checkpoint-1").is_dir()
    want = tr.eval_model().state_dict()
    if use_ema:
        assert any(not torch.equal(want[k], v)
                   for k, v in tr.vae.state_dict().items())
    ldm_cfg = PT.LDMTrainingConfig(vae_path=str(out), af_models=True,
                                   use_shift_loss=False, use_ema=False)
    ldm = PT.create_trainer("ldm", PT.BaseTrainingConfig(resolution=RES),
                            ldm_cfg, device="cpu")
    ldm.init_modules(unet_config=asdict(TINY_UNET_CFG),
                     scheduler_config=SCHED_CFG)
    assert ldm.vae_config.to_dict() == json.loads(
        json.dumps(tr.vae_config.to_dict()))
    ldm.init_params(seed=3)
    for k, v in ldm.vae.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_validate_reconstructs_and_scores(tmp_path, port_batches):
    from PIL import Image
    vdir = tmp_path / "valid"
    vdir.mkdir()
    rng = np.random.default_rng(4)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (RES, RES, 3), np.uint8)).save(
            vdir / f"{i}.png")
    base, cfg = _jax_cfgs(tmp_path, gradient_accumulation_steps=1)
    base.valid_data_dir = str(vdir)
    tr = _port_trainer(base, cfg)
    tr.set_dataset(PT.SyntheticDataset(resolution=RES, length=8))
    out = tr.validate(0)
    assert out["recon"].shape == (5, RES, RES, 3)
    for k in ("val_mse", "valid_mse", "valid_perceptual", "valid_psnr",
              "valid_recon_ffd"):
        assert np.isfinite(out[k]), k
    assert out["valid_recon_ffd"] >= -1e-6


def test_lpips_path_swaps_the_bank(tmp_path):
    ckpt = tmp_path / "vgg16.pth"
    _fake_vgg_checkpoint(str(ckpt))
    base, cfg = _jax_cfgs(tmp_path, lpips_vgg_path=str(ckpt))
    try:
        _port_trainer(base, cfg)
        assert PP._is_vgg(PP._filters())
    finally:
        PP._DEFAULT_FILTERS = None


# -- the CLI ------------------------------------------------------------------

def _tiny_vae_cli_config(tmp_path):
    (tmp_path / "vae.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in asdict(TINY_VAE_CFG).items()}))
    cfg = {"base": {"logging_dir": "logs", "output_dir": str(tmp_path / "o"),
                    "train_batch_size": 2, "resolution": RES,
                    "num_epochs": 1, "checkpointing_steps": 2,
                    "save_model_epochs": 1, "seed": 0,
                    "resume_from_checkpoint": "latest"},
           "vae": {"model_cfg": str(tmp_path / "vae.json"),
                   "use_shift_loss": True, "use_ema": True,
                   "learning_rate": 1e-3}}
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    return p


def test_train_cli_runs_vae_and_resumes(tmp_path):
    from afldm_tpu_torch.scripts import train as cli
    cfg = _tiny_vae_cli_config(tmp_path)
    assert cli.main([str(cfg), "--device", "cpu", "--max_steps", "2"]) == 2
    out = tmp_path / "o"
    assert (out / "checkpoint-2").is_dir()
    assert (out / "pipeline" / "vae_config.json").exists()
    assert cli.main([str(cfg), "--device", "cpu", "--max_steps", "3"]) == 3
    state = PT.restore_checkpoint(str(out / "checkpoint-3"))
    assert state["step"] == 3 and state["optimizer"]["micro_step"] == 1


def test_repo_vae_config_builds_the_afvae_trainer():
    """configs/vae/train_afvae_imagenet.json names the AF-VAE of
    model_afvae.json and the defaults the full-width run uses."""
    cfgs = PT.load_training_config(
        str(REPO / "configs/vae/train_afvae_imagenet.json"))
    base, cfg = cfgs["base"], cfgs["vae"]
    assert (base.resolution, base.train_batch_size) == (256, 4)
    assert cfg.use_shift_loss and not cfg.use_disc
    assert cfg.gradient_accumulation_steps == 2
    assert not base.gradient_checkpointing
    vc = PM.AutoencoderKLConfig.from_diffusers(json.loads(
        (REPO / cfg.model_cfg).read_text()))
    assert vc.alias_free and vc.downsample_ratio == 8
