"""bf16 training on the CPU: the models the trainers add at bf16 (the SD
UNet, the ControlNet, the discriminator) against Flax ``dtype=bf16``, and
one step of each of the five trainers at ``mixed_precision="bf16"``
against the JAX trainer given the same draws and the same start.

The JAX side compiles without XLA's excess precision and with its
filtered activations and attention in the Pallas kernels' bf16 semantics
(test_torch_bf16.py's ``_exact`` and ``_kernel_semantics``; for a trainer
its step function is lowered again with that option). Its draws are
reproduced from ``fold_in(PRNGKey(seed), step)`` in the dtype the JAX
trainer draws them (bf16 where it draws them in the latents' dtype), and
its gradients are captured inside its step (a ``jax.debug.callback`` in
its optimizer's update). Starting weights are drawn with numpy
(``numpy_init``) on both sides: one JAX compile per trainer, the five
compiling in threads at once (XLA compiles outside the GIL).

Tolerances:
- models: RMS of the difference at most MODEL_RATIO of Flax's own bf16 -
  f32 RMS gap on the same inputs (test_torch_bf16.py);
- a trainer's logged losses within 1e-2 relative of JAX's;
- each parameter's gradient of at least GRAD_MIN_NUMEL elements: RMS(port
  - JAX) at most TENSOR_RATIO of JAX's own RMS gap, RMS(JAX's bf16
  gradient - the f32 gradient on the same draws). An RMS ratio over a
  few hundred elements is noisy: the sound port reads up to 1.51 (the
  tiny I2SB UNet's 1024-element mid-block to_v weight; the next 1.49 and
  1.43), so 1.5 is too tight per tensor. A plain dk whose ds takes the
  softmax scale twice fails in each trainer, its first failing tensor at
  3.0-9.3 of the gap. A fault of one rounding (dp rounded to bf16 before
  dp - delta, or ds truncated, not rounded) reads 1.55 and 1.50 here,
  within bf16's own noise: test_torch_bf16_bwd.py fails both (its flash
  backward cases read 1.50 and 1.89-2.03 of JAX's gap, against
  ATTN_RATIO 0.05 or VJP_RATIO 1.25). The smaller tensors (biases, norm scales: 8-64 elements) are
  held together, their differences and JAX's gaps pooled per trained
  module, within GRAD_RATIO (measured per tensor: medians 0.52-1.08 of
  the gap, the largest 2.08 at an 8-element group-norm weight of the tiny
  VAE); and over all of a module's gradients the port's own gap at most
  GRAD_RATIO of JAX's. The f32 gradient is the port's f32 trainer's,
  which the f32 trainer tests hold to JAX's to rounding (1e-5 of a
  parameter after an update). A tensor whose gradient is zero in exact
  arithmetic (the self-attention ``to_k`` biases: softmax ignores a shift
  of every key; the ControlNet trainer's cross-attention over its
  all-zero text embeddings) is held instead to GRAD_NOISE of the largest
  gradient's RMS;
- the parameters after the step within 2 lr of JAX's (and an f32 ulp):
  Adam's first update is lr · sign(g) wherever |g| is well above epsilon,
  so an element whose gradient is within rounding of zero may move by lr
  either way (ROADMAP Queue 3: an elementwise 1e-5 is the wrong bound
  there).
"""

import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu.train import (SyntheticDataset as JaxSynthetic,
                             create_trainer as jax_create_trainer,
                             epoch_batches as jax_epoch_batches)
from afldm_tpu_torch import models as T
from afldm_tpu_torch import train as PT
from test_torch_bf16 import (_NO_EXCESS, _exact, _f32, _kernel_semantics,
                             _model_close, _rms,
                             kernel_semantics)  # noqa: F401 (a fixture)
from test_torch_harness import (load_port, nchw, nhwc, numpy_init,
                                port_state, rand)

torch.set_num_threads(1)

BF = torch.bfloat16
LR = 1e-4
N_BATCH, RES, RATIO = 4, 16, 2
GRAD_RATIO = 1.5
TENSOR_RATIO = 2.0
GRAD_NOISE = 1e-2
GRAD_MIN_NUMEL = 256
# the tiny LDM configs' scheduler (tests/test_train.py)
LDM_TIMESTEPS = 100


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


# -- the models --------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_models():
    """The tiny SD UNet and ControlNet of the normal-estimation CLI: Flax
    at bf16 and f32, their numpy-drawn parameters, the port's at bf16."""
    from afldm_tpu_torch.scripts.shift_normal_estimation import load_configs
    ucfg, _, _ = load_configs(tiny=True)
    jcfg = J.UNet2DConditionConfig.from_diffusers(_tuples(ucfg),
                                                  alias_free=True)
    ju = {dt: J.UNet2DConditionModel(jcfg, dtype=dt)
          for dt in (jnp.bfloat16, jnp.float32)}
    jc = {dt: J.ControlNetModel(J.ControlNetConfig.from_unet_config(jcfg),
                                dtype=dt) for dt in (jnp.bfloat16,
                                                     jnp.float32)}
    lat, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ehs = jnp.zeros((1, 77, 16))
    up = numpy_init(ju[jnp.float32], lat, t, ehs, seed=1)
    cp = numpy_init(jc[jnp.float32], lat, t, ehs, lat, seed=2)
    tcfg = T.UNet2DConditionConfig.from_diffusers(ucfg, alias_free=True)
    tu = load_port(T.UNet2DConditionModel(tcfg, dtype=BF), up)
    tc = load_port(T.ControlNetModel(T.ControlNetConfig.from_unet_config(
        tcfg), dtype=BF), cp)
    return ju, jc, up, cp, tu, tc


def _sd_inputs():
    rng = np.random.default_rng(20)
    return (rand(rng, (2, 8, 8, 4)), np.array([999, 421], np.int32),
            rand(rng, (2, 77, 16)), rand(rng, (2, 8, 8, 4)))


def test_sd_unet_at_bf16(sd_models, kernel_semantics):
    ju, _, up, _, tu, _ = sd_models
    x, t, ehs, _ = _sd_inputs()
    want, want32 = (_f32((_exact if dt == jnp.bfloat16 else jax.jit)(
        lambda p, *a, m=ju[dt]: m.apply(p, *a)[0])(
            up, *(jnp.asarray(a) for a in (x, t, ehs))))
        for dt in (jnp.bfloat16, jnp.float32))
    got, stored = tu(nchw(x), torch.from_numpy(t), torch.from_numpy(ehs))
    assert got.dtype == BF and all(s.dtype == BF for s in stored)
    assert all(p.dtype == torch.float32 for p in tu.parameters())
    _model_close(nhwc(got.float()), want, want32, "unet")


def test_controlnet_at_bf16(sd_models, kernel_semantics):
    _, jc, _, cp, _, tc = sd_models
    x, t, ehs, cond = _sd_inputs()

    def flat(res):
        down, mid, _ = res
        return jnp.concatenate([r.astype(jnp.float32).ravel()
                                for r in (*down, mid)])
    want, want32 = (np.asarray((_exact if dt == jnp.bfloat16 else jax.jit)(
        lambda p, *a, m=jc[dt]: flat(m.apply(p, *a)))(
            cp, *(jnp.asarray(a) for a in (x, t, ehs, cond))))
        for dt in (jnp.bfloat16, jnp.float32))
    down, mid, _ = tc(nchw(x), torch.from_numpy(t), torch.from_numpy(ehs),
                      nchw(cond))
    assert mid.dtype == BF and all(r.dtype == BF for r in down)
    got = np.concatenate([nhwc(r.float()).ravel() for r in (*down, mid)])
    _model_close(got, want, want32, "unet")


@pytest.mark.parametrize("antialias", [False, True])
def test_discriminator_at_bf16(antialias):
    kw = dict(depth=3, hidden_channels=16, antialias=antialias)
    jb, j32 = J.Discriminator(dtype=jnp.bfloat16, **kw), J.Discriminator(**kw)
    # 64 px: 72 logits (at 32 px 8, too few for an RMS ratio: 0.8-2.0 of
    # the gap over two draws)
    x = rand(np.random.default_rng(21), (2, 64, 64, 3))
    p = numpy_init(j32, jnp.zeros((1, 64, 64, 3)), seed=4)
    want = _f32(_exact(jb.apply)(p, jnp.asarray(x)))
    want32 = _f32(jax.jit(j32.apply)(p, jnp.asarray(x)))
    tm = load_port(T.Discriminator(dtype=BF, **kw), p)
    got = tm(nchw(x))
    assert got.dtype == BF
    _model_close(nhwc(got.float()), want, want32, "unet")


# -- one step of each trainer --------------------------------------------------

def _key(step):
    return jax.random.fold_in(jax.random.PRNGKey(0), step)


def _offsets(k_off, ratio):
    max_off = int(RES * 0.75 // 2)
    return tuple(int(jax.random.randint(k, (), -max_off, max_off + 1))
                 / ratio for k in (k_off, jax.random.fold_in(k_off, 1)))


LAT = (N_BATCH, RES // RATIO, RES // RATIO, 4)


def _normal(key, dt=jnp.bfloat16):
    return nchw(jax.random.normal(key, LAT, dt).astype(jnp.float32))


def _ldm_draws(step, n_t=1000):
    """LDM and SD text: (k_enc, k_noise, k_t, k_off), the two noises drawn
    in the latents' dtype."""
    k_enc, k_noise, k_t, k_off = jax.random.split(_key(step), 4)
    ti, tj = _offsets(k_off, RATIO)
    return {"enc_eps": _normal(k_enc), "noise": _normal(k_noise),
            "t": torch.from_numpy(np.array(jax.random.randint(
                k_t, (N_BATCH,), 0, n_t))).long(), "ti": ti, "tj": tj}


def _vae_draws(step):
    k_s1, k_s2, k_off1, k_off2 = jax.random.split(_key(step), 4)
    max_off = int(RES * 0.75 // 2)
    ti, tj = (int(jax.random.randint(k, (), -max_off, max_off + 1))
              for k in (k_off1, k_off2))
    return {"eps": _normal(k_s1), "eps_shift": _normal(k_s2),
            "eps_disc": _normal(_key(step)), "ti": ti, "tj": tj}


def _i2sb_draws(step):
    """The bridge noise is drawn in x_t's dtype, float32."""
    k_noise, k_t, k_off = jax.random.split(_key(step), 3)
    ti, tj = _offsets(k_off, RATIO)
    return {"noise": _normal(k_noise, jnp.float32),
            "t": torch.from_numpy(np.array(jax.random.randint(
                k_t, (N_BATCH,), 0, 1000))).long(), "ti": ti, "tj": tj}


def _norm_draws(step, zero_input_prob=0.5):
    k_zero, k_noise, k_off = jax.random.split(_key(step), 3)
    ti, tj = _offsets(k_off, RATIO)
    zero = jax.random.uniform(k_zero, (N_BATCH, 1, 1, 1)) < zero_input_prob
    return {"zero": torch.from_numpy(np.array(zero).reshape(-1)),
            "noise": _normal(k_noise), "ti": ti, "tj": tj}


def _capture_tx(tx, store):
    """``tx`` that hands each gradient tree to ``store`` as numpy."""
    def update(grads, state, params=None):
        jax.debug.callback(lambda g: store.append(
            jax.tree_util.tree_map(np.array, g)), grads)
        return tx.update(grads, state, params)
    return optax.GradientTransformation(tx.init, update)


def _no_excess(fn):
    """A jitted step lowered again and compiled without excess precision
    at its first call."""
    compiled = {}

    def run(*args):
        if not compiled:
            compiled["fn"] = fn.lower(*args).compile(_NO_EXCESS)
        return compiled["fn"](*args)
    return run


def _capture_opt(opt, named, store):
    """The port optimizer's ``step`` records the named gradients (float32)
    before it applies them."""
    step = opt.step

    def run():
        store.append({n: p.grad.detach().float().clone()
                      for n, p in named if p.grad is not None})
        return step()
    opt.step = run


def _fixed_init(module, params):
    """A Flax module whose ``init`` returns ``params`` (numpy-drawn), so
    that a JAX trainer's ``prepare_modules`` compiles no init."""
    object.__setattr__(module, "init", lambda *a, **k: params)


def _sd_cfgs():
    from test_train_sd import TINY_SD, TINY_VAE
    return TINY_VAE, TINY_SD


class Spec:
    """One trainer of the test: its name, configs and draws, and where its
    modules, optimizers and step live in either package."""

    def __init__(self, name, jax_cfg, port_cfg_cls, draws, base_kw=None):
        self.name, self.jax_cfg, self.port_cfg_cls = name, jax_cfg, \
            port_cfg_cls
        self.draws, self.base_kw = draws, base_kw or {}


def _specs():
    from afldm_tpu.train import (I2SBLDMTrainingConfig, LDMTrainingConfig,
                                 VAETrainingConfig)
    from afldm_tpu.train.config import NormControlNetConfig, \
        SDTextTrainingConfig
    common = dict(learning_rate=LR, lr_warmup_steps=0)
    return {
        "ldm": Spec("ldm", LDMTrainingConfig(
            vae_path="", scheduler_path="", af_models=True,
            use_shift_loss=True, use_cross_attn=True, use_ema=True,
            **common), PT.LDMTrainingConfig,
            functools.partial(_ldm_draws, n_t=LDM_TIMESTEPS),
            {"gradient_checkpointing": True}),
        # the VAE and ControlNet trainers without their shift losses, whose
        # second passes roughly double a JAX compile; the LDM, I2SB and SD
        # text trainers keep theirs (CFA LOAD through the bf16 backward)
        "vae": Spec("vae", VAETrainingConfig(
            model_cfg="", use_shift_loss=False, use_ema=True,
            gradient_accumulation_steps=1, **common), PT.VAETrainingConfig,
            _vae_draws),
        "i2sb": Spec("i2sb", I2SBLDMTrainingConfig(
            af_models=True, is_ode=False, use_cfa=True, use_ema=True,
            **common), PT.I2SBLDMTrainingConfig, _i2sb_draws),
        "sd_text": Spec("sd_text", SDTextTrainingConfig(
            af_models=True, use_shift_loss=True, use_cross_attn=True,
            use_ema=True, **common), PT.SDTextTrainingConfig, _ldm_draws),
        "norm_controlnet": Spec("norm_controlnet", NormControlNetConfig(
            af_models=True, use_shift_loss=False, zero_input_prob=0.5,
            **common), PT.NormControlNetConfig, _norm_draws),
    }


def _base(tmp, **kw):
    from afldm_tpu.train import BaseTrainingConfig
    return BaseTrainingConfig(output_dir=str(tmp), resolution=RES,
                              train_batch_size=N_BATCH, num_epochs=1,
                              seed=0, **kw)


def _init_kwargs(name, port):
    """init_modules' config arguments of trainer ``name`` (the tiny
    configs of the f32 trainer tests)."""
    import json
    from test_torch_harness import REPO
    from test_train import SCHED_CFG, TINY_UNET_CFG, TINY_VAE_CFG
    if name in ("ldm", "i2sb"):
        sched = SCHED_CFG if name == "ldm" else {
            k: v for k, v in json.loads((REPO / "configs/sr/"
                                         "i2sb_scheduler.json").read_text())
            .items() if not k.startswith("_")}
        if port:
            vae = T.AutoencoderKLConfig(**asdict(TINY_VAE_CFG))
            unet = T.UNet2DConfig(**{
                k: v for k, v in asdict(TINY_UNET_CFG).items()
                if k in T.UNet2DConfig.__dataclass_fields__})
            return dict(vae_config=vae, unet_config=unet,
                        scheduler_config=sched)
        return dict(vae_config=TINY_VAE_CFG, unet_config=TINY_UNET_CFG,
                    scheduler_config=sched)
    if name == "vae":
        vae = (T.AutoencoderKLConfig(**asdict(TINY_VAE_CFG)) if port
               else TINY_VAE_CFG)
        return dict(vae_config=vae)
    from test_torch_sd_train import SCHED, StubText
    tv, ts = _sd_cfgs()
    if port:
        tv, ts = (T.AutoencoderKLConfig(**asdict(tv)),
                  T.UNet2DConditionConfig(**asdict(ts)))
    kw = dict(vae_config=tv, unet_config=ts)
    if name == "sd_text":
        kw.update(scheduler_config=SCHED, text_encoder=StubText(not port))
    return kw


def _jax_start(name, tr):
    """Numpy-drawn starting weights for JAX trainer ``tr``: {role: params},
    each module's ``init`` fixed to return them; and the arguments of its
    ``prepare_modules``."""
    img = jnp.zeros((1, RES, RES, 3))
    lat, t = jnp.zeros((1, RES // RATIO, RES // RATIO, 4)), \
        jnp.zeros((1,), jnp.int32)
    if name == "vae":
        p = numpy_init(tr.model, img, seed=5)
        _fixed_init(tr.model, p)
        return {"vae": p}, {}
    vp = numpy_init(tr.vae, img, seed=6)
    if name in ("ldm", "i2sb"):
        up = numpy_init(tr.unet, lat, t, seed=7)
        _fixed_init(tr.unet, up)
        return {"vae": vp, "unet": up}, {"vae_params": vp}
    ehs = jnp.zeros((1, 77, 16))
    up = numpy_init(tr.unet, lat, t, ehs, seed=7)
    start = {"vae": vp, "unet": up}
    if name == "norm_controlnet":
        cp = numpy_init(tr.controlnet, lat, t, ehs, lat, seed=8)
        _fixed_init(tr.controlnet, cp)
        start["controlnet"] = cp
    return start, {"vae_params": vp, "unet_params": up}


def _port_states(name, start):
    s = {k: port_state(v) for k, v in start.items()}
    if name == "vae":
        return {"vae_state": s["vae"]}
    out = {"vae_state": s["vae"], "unet_state": s["unet"]}
    if name == "norm_controlnet":
        out["controlnet_state"] = s["controlnet"]
    return out


def _jax_step(spec, tmp, batch):
    """One bf16 step of the JAX trainer: (start, logs, gradients {role:
    torch-named}, parameters after it {role: torch-named})."""
    tr = jax_create_trainer(spec.name, _base(tmp, mixed_precision="bf16",
                                             **spec.base_kw), spec.jax_cfg)
    tr.init_modules(**_init_kwargs(spec.name, port=False))
    tr.init_optimizers(100)
    grads = {}
    tr.tx = _capture_tx(tr.tx, grads.setdefault("main", []))
    if spec.name == "norm_controlnet":
        tr.cn_tx = _capture_tx(tr.cn_tx, grads.setdefault("controlnet", []))
    start, kw = _jax_start(spec.name, tr)
    tr.prepare_modules(**kw)
    attr = "_g_step" if spec.name == "vae" else "_step_fn"
    setattr(tr, attr, _no_excess(getattr(tr, attr)))
    logs = tr.training_step(0, batch)
    main = "vae" if spec.name == "vae" else "unet"
    g = {main: port_state(grads["main"][0])}
    after = {main: port_state(tr.state.params)}
    if spec.name == "norm_controlnet":
        g["controlnet"] = port_state(grads["controlnet"][0])
        after["controlnet"] = port_state(tr.cn_state.params)
    return start, logs, g, after


def _port_step(spec, tmp, batch, start, mixed_precision):
    """One step of the port's trainer from ``start``: (trainer, logs,
    gradients {role: torch-named}, parameters after it)."""
    base = PT.BaseTrainingConfig(**asdict(_base(
        tmp, mixed_precision=mixed_precision, **spec.base_kw)))
    tr = PT.create_trainer(spec.name, base,
                           spec.port_cfg_cls(**asdict(spec.jax_cfg)),
                           device="cpu")
    tr.init_modules(**_init_kwargs(spec.name, port=True))
    tr.init_optimizers(100)
    tr.prepare_modules(**_port_states(spec.name, start))
    main = tr.vae if spec.name == "vae" else tr.unet
    mods = {("vae" if spec.name == "vae" else "unet"): main}
    if spec.name == "norm_controlnet":
        mods["controlnet"] = tr.controlnet
    grads = {}
    opts = {"vae": tr.opt, "unet": tr.opt,
            "controlnet": getattr(tr, "cn_opt", None)}
    for role, m in mods.items():
        _capture_opt(opts[role], list(m.named_parameters()),
                     grads.setdefault(role, []))
    logs = tr.training_step(0, batch, spec.draws(0))
    after = {role: {n: p.detach().clone() for n, p in m.named_parameters()}
             for role, m in mods.items()}
    return tr, logs, {r: g[0] for r, g in grads.items()}, after


@pytest.fixture(scope="module")
def batch():
    ds = JaxSynthetic(resolution=RES, length=8)
    b = next(iter(jax_epoch_batches(ds, N_BATCH)))
    from test_torch_sd_train import CAPTIONS
    b["caption"] = CAPTIONS
    b["normal"] = b["input"][:, ::-1].copy()
    return b


@pytest.fixture(scope="module")
def runs(batch, tmp_path_factory):
    """Each trainer's JAX bf16 step (one compile) and the port's bf16 and
    f32 steps from the same start with the same draws, computed once."""
    out = {}
    specs = _specs()
    tmps = {name: tmp_path_factory.mktemp(name) for name in specs}
    with pytest.MonkeyPatch.context() as mp:
        _kernel_semantics(mp.setattr)
        with ThreadPoolExecutor(len(specs)) as ex:
            jax_runs = {name: ex.submit(_jax_step, spec, tmps[name], batch)
                        for name, spec in specs.items()}
            jax_runs = {name: f.result() for name, f in jax_runs.items()}
    for name, spec in specs.items():
        start, jlogs, jgrads, jafter = jax_runs[name]
        tr, logs, grads, after = _port_step(spec, tmps[name], batch, start,
                                            "bf16")
        _, logs32, grads32, _ = _port_step(spec, tmps[name], batch, start,
                                           None)
        out[name] = dict(trainer=tr, jlogs=jlogs, jgrads=jgrads,
                         jafter=jafter, logs=logs, grads=grads,
                         grads32=grads32, after=after, logs32=logs32)
    return out


TRAINERS = ["ldm", "vae", "i2sb", "sd_text", "norm_controlnet"]


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_builds_bf16_on_float32_parameters(runs, name):
    tr = runs[name]["trainer"]
    assert tr.weight_dtype == BF
    models = [tr.vae] + ([] if name == "vae" else [tr.unet])
    if name == "norm_controlnet":
        models.append(tr.controlnet)
    for m in models:
        assert m.dtype == BF
        assert all(p.dtype == torch.float32 for p in m.parameters())
    if getattr(tr, "ema", None) is not None:
        assert all(e.dtype == torch.float32 for e in tr.ema.params)
    for st in tr.opt.opt.state.values():
        assert all(v.dtype == torch.float32 for v in st.values()
                   if torch.is_tensor(v) and v.ndim)


@pytest.mark.parametrize("name", TRAINERS)
def test_step_losses_match_jax_at_bf16(runs, name):
    r = runs[name]
    for k, want in r["jlogs"].items():
        if want == 0:
            continue
        got = r["logs"][k]
        assert abs(got - want) <= 1e-2 * abs(want), (k, got, want)
    # and bf16 is not float32: the losses moved
    assert r["logs"]["train_loss"] != r["logs32"]["train_loss"]


@pytest.mark.parametrize("name", TRAINERS)
def test_gradients_match_jax_at_bf16(runs, name):
    r = runs[name]
    for role, want in r["jgrads"].items():
        got, f32 = r["grads"][role], r["grads32"][role]
        assert set(got) == set(f32) and set(got) <= set(want)
        scale = max(_rms(g.numpy()) for g in f32.values())
        small_d, small_gap, own, jax_gap = [], [], [], []
        for n, g in got.items():
            g, w, g32 = g.numpy(), want[n].numpy(), f32[n].numpy()
            d, gap = _rms(g - w), _rms(w - g32)
            own.append((g - g32).ravel())
            jax_gap.append((w - g32).ravel())
            if n.endswith("to_k.bias") or _rms(w - g32) == 0:
                assert d <= GRAD_NOISE * scale, (role, n, d, scale)
            elif g.size >= GRAD_MIN_NUMEL:
                assert d <= TENSOR_RATIO * gap, (role, n, d, gap)
            else:
                small_d.append((g - w).ravel())
                small_gap.append((w - g32).ravel())
        d, gap = (_rms(np.concatenate(a)) for a in (small_d, small_gap))
        assert d <= GRAD_RATIO * gap, (role, "the small tensors", d, gap)
        own, gap = (_rms(np.concatenate(a)) for a in (own, jax_gap))
        assert own <= GRAD_RATIO * gap, (role, "the port's own gap", own,
                                         gap)


@pytest.mark.parametrize("name", TRAINERS)
def test_params_after_step_match_jax_at_bf16(runs, name):
    r = runs[name]
    for role, want in r["jafter"].items():
        got = r["after"][role]
        assert set(got) == set(want)
        for n, w in want.items():
            err = float((got[n] - w).abs().max())
            ulp = float(np.spacing(np.float32(w.abs().max())))
            assert err <= 2 * LR + ulp, (role, n, err)


def test_sd_interpolation_pipeline_runs_at_bf16():
    """The tiny SD image interpolation (the CLI's configs, 3 frames) on a
    bf16 pipeline (``init_random_interp_pipeline(dtype=bfloat16)``, once
    refused): one DDIM step, finite frames in [0, 1]; and the same start
    at f32 lands within bf16's reach of it."""
    from afldm_tpu_torch.pipelines import init_random_interp_pipeline
    from afldm_tpu_torch.scripts.image_interpolation import (image_pair,
                                                             load_configs)
    from afldm_tpu_torch.shift.simple_flow import predict_flow
    frames = {}
    for dt in (BF, torch.float32):
        pipe = init_random_interp_pipeline(*load_configs(tiny=True), seed=0,
                                           device="cpu", dtype=dt)
        assert pipe.unet.dtype == pipe.vae.dtype == dt
        res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
        img0, img1 = image_pair(res)
        frames[dt] = np.asarray(pipe(
            img0, img1, num_frames=3, num_inference_steps=1,
            generator=torch.Generator().manual_seed(1),
            flows=predict_flow(img0, img1)), np.float32)
    got = frames[BF]
    assert got.shape == (3, 64, 64, 3) and np.isfinite(got).all()
    assert got.min() >= 0 and got.max() <= 1
    assert 0 < _rms(got - frames[torch.float32]) < 0.1
