"""The port's CFA interpolation on the FFHQ UNet against the JAX package:
the two-KV blended attention (``sdpa2``, the plain version of K6, and its
autograd Function), ``Attention`` and ``UNet2DModel`` with a second stored
map and alpha, and ``LDMPipeline.denoise`` in interp mode.

The JAX side runs its Pallas kernels in interpret mode (``sdpa2_flash``,
jitted) and its plain ``sdpa2_xla``. Tolerances: attention 1e-5 absolute
(f32 sums in another order), its gradients 1e-5 of their scale (at least
absolute: alpha's gradient is a sum over every output); layers 1e-5
absolute; the UNet and the 2-step interp denoise 1e-5 relative to the
output's scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu.ops.attention import sdpa2_flash, sdpa2_xla
from afldm_tpu_torch import models as T
from afldm_tpu_torch.ops import attention as TA
from test_torch_harness import (assert_rel_close, jax_apply, jax_init,
                                load_port, nchw, nhwc, rand, tt)
from test_torch_models import UNET, _randomize

torch.set_num_threads(1)

ATOL = 1e-5
_sdpa2_flash = jax.jit(sdpa2_flash)


def _alpha(kind, n):
    a = np.linspace(0.1, 0.9, n).astype(np.float32)
    return {"scalar": np.float32(0.3), "frames": a,
            "frames11": a[:, None, None]}[kind]


def _inputs(rng, B, H, Lq, Lk, D, kv_batch):
    """q and four K/V tensors: numpy for JAX (K/V repeated to the batch)
    and torch for the port (K/V expanded from their batch, stride 0)."""
    q = rand(rng, (B, H, Lq, D))
    kvs = [rand(rng, (kv_batch, H, Lk, D)) for _ in range(4)]
    j = [np.repeat(t, B // kv_batch, axis=0) for t in kvs]
    t = [tt(x).expand(B, -1, -1, -1) if kv_batch == 1 else tt(x) for x in kvs]
    return q, j, t


@pytest.mark.parametrize("alpha", ["scalar", "frames", "frames11"])
@pytest.mark.parametrize("shape", [(3, 2, 64, 64, 24, 1),
                                   (3, 2, 37, 50, 40, 3)],
                         ids=["kv-from-1", "ragged"])
def test_sdpa2_plain_matches_jax(rng, alpha, shape):
    B, H, Lq, Lk, D, nkv = shape
    q, jkv, tkv = _inputs(rng, B, H, Lq, Lk, D, nkv)
    a = _alpha(alpha, B)
    got = TA.sdpa2_eager(tt(q), *tkv, tt(np.asarray(a)))
    for fn in (_sdpa2_flash, sdpa2_xla):
        want = fn(jnp.asarray(q), *map(jnp.asarray, jkv), jnp.asarray(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the dispatcher and the kernel's wrapper take the plain version on
    # the CPU
    for fn in (TA.sdpa2, TA.flash2_fwd):
        torch.testing.assert_close(fn(tt(q), *tkv, tt(np.asarray(a))), got,
                                   atol=0, rtol=0)


def test_sdpa2_dispatcher_routes_by_shape(rng, monkeypatch):
    """D <= 256 with equal K/V shapes takes the kernel's wrapper; D > 256
    or K/V sets of different lengths the plain version."""
    calls = []
    real = TA.flash2_fwd
    monkeypatch.setattr(TA, "flash2_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q = tt(rand(rng, (1, 1, 8, 24)))
    kv = [tt(rand(rng, (1, 1, 8, 24))) for _ in range(4)]
    TA.sdpa2(q, *kv, 0.5)
    assert calls == [1]
    short = tt(rand(rng, (1, 1, 4, 24)))
    TA.sdpa2(q, kv[0], kv[1], short, short, 0.5)
    big = [tt(rand(rng, (1, 1, 8, 264))) for _ in range(5)]
    TA.sdpa2(*big, 0.5)
    assert calls == [1]


@pytest.mark.parametrize("alpha", ["scalar", "frames"])
def test_sdpa2_grad_matches_jax(rng, alpha):
    """The Function's backward (the two-pass VJP through the flash
    Function) against jax.grad of ``sdpa2_flash``, alpha's gradient
    included."""
    B, H, L, D = 2, 2, 32, 24
    q = rand(rng, (B, H, L, D))
    kvs = [rand(rng, (B, H, L, D)) for _ in range(4)]
    a = np.asarray(_alpha(alpha, B))
    g = rand(rng, (B, H, L, D))

    def loss(*args):
        return jnp.sum(sdpa2_flash(*args) * g)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        jnp.asarray(q), *map(jnp.asarray, kvs), jnp.asarray(a))
    ins = [tt(x).requires_grad_() for x in (q, *kvs, a)]
    out = TA.sdpa2(*ins)
    got = torch.autograd.grad(out, ins, tt(g))
    for x, w in zip(got, want):
        # 1e-5 of the gradient's scale: alpha's sums B·H·L·D products
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(x.numpy(), np.asarray(w),
                                   atol=ATOL * scale)


# -- Attention and the FFHQ UNet with two stored maps ----------------------------

@pytest.fixture(scope="module")
def attention_pair():
    x = rand(np.random.default_rng(1), (3, 4, 4, 16))
    jm = J.Attention(num_heads=2, groups=4)
    p = _randomize(jax_init(jm, jnp.asarray(x)))
    return jm, p, load_port(T.Attention(16, 2, groups=4), p)


@pytest.mark.parametrize("alpha", ["default", "scalar", "frames",
                                   "frames11"])
def test_attention_interp_matches_jax(attention_pair, alpha):
    jm, p, tm = attention_pair
    rng = np.random.default_rng(2)
    x = rand(rng, (3, 4, 4, 16))
    m0, m1 = rand(rng, (1, 4, 4, 16)), rand(rng, (1, 4, 4, 16))
    a = None if alpha == "default" else _alpha(alpha, 3)
    want, want_stored = jax_apply(jm)(
        p, jnp.asarray(x), jnp.asarray(m0.reshape(1, 16, 16)),
        jnp.asarray(m1.reshape(1, 16, 16)),
        None if a is None else jnp.asarray(a))
    got, stored = tm(nchw(x), nchw(m0), nchw(m1),
                     None if a is None else tt(np.asarray(a)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(nhwc(stored).reshape(3, 16, 16),
                                  np.asarray(want_stored))


@pytest.mark.parametrize("alpha,which", [(0.0, 0), (1.0, 1)])
def test_attention_interp_endpoints_equal_load(attention_pair, alpha, which):
    """alpha = 0 is LOAD from the first map, alpha = 1 from the second."""
    _, _, tm = attention_pair
    rng = np.random.default_rng(3)
    x = nchw(rand(rng, (3, 4, 4, 16)))
    maps = (nchw(rand(rng, (1, 4, 4, 16))), nchw(rand(rng, (1, 4, 4, 16))))
    got, _ = tm(x, *maps, alpha)
    want, _ = tm(x, maps[which])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def unet_pair():
    jm = J.UNet2DModel(J.UNet2DConfig(**UNET))
    p = _randomize(jax_init(jm, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))),
                   seed=5)
    return jm, p, load_port(T.UNet2DModel(T.UNet2DConfig(**UNET)), p)


@pytest.mark.parametrize("alpha", ["scalar", "frames11"])
def test_unet_interp_pass_matches_jax(unet_pair, alpha):
    jm, p, tm = unet_pair
    rng = np.random.default_rng(4)
    refs = [rand(rng, (1, 8, 8, 4)) for _ in range(2)]
    x = rand(rng, (3, 8, 8, 4))
    a = _alpha(alpha, 3)
    jmaps = [jax_apply(jm)(p, jnp.asarray(r), jnp.asarray(501))[1]
             for r in refs]
    tmaps = [tm(nchw(r), 501)[1] for r in refs]
    want, _ = jax_apply(jm)(p, jnp.asarray(x), jnp.asarray(501),
                            kv_in=jmaps[0], kv_in2=jmaps[1],
                            alpha=jnp.asarray(a))
    got, _ = tm(nchw(x), 501, kv_in=tmaps[0], kv_in2=tmaps[1],
                alpha=tt(np.asarray(a)))
    assert_rel_close(nhwc(got), want, ATOL, "eps (interp)")
    # alpha 0 and 1: LOAD from one map
    for a_end, maps in ((0.0, tmaps[0]), (1.0, tmaps[1])):
        end, _ = tm(nchw(x), 501, kv_in=tmaps[0], kv_in2=tmaps[1],
                    alpha=a_end)
        load, _ = tm(nchw(x), 501, kv_in=maps)
        torch.testing.assert_close(end, load, atol=1e-5, rtol=0)


def test_ldm_denoise_interp_matches_jax():
    """Two STORE passes, then a 2-step interp denoise of 3 frames with one
    alpha per frame, on the tiny FFHQ pipeline of the CLI."""
    from afldm_tpu.pipelines import LDMPipeline as JPipe
    from afldm_tpu.schedulers import DDIMScheduler as JDDIM
    from afldm_tpu_torch.pipelines import LDMPipeline as TPipe
    from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    ju = J.UNet2DModel(J.UNet2DConfig.from_diffusers(ucfg, alias_free=True))
    up = _randomize(jax_init(ju, jnp.zeros((1, 8, 8, 4)),
                             jnp.zeros((1,), jnp.int32)), seed=7)
    tu = load_port(T.UNet2DModel(
        T.UNet2DConfig.from_diffusers(ucfg, alias_free=True)), up)
    jv = J.AutoencoderKL(J.AutoencoderKLConfig.from_diffusers(vcfg))
    jp = JPipe(jv, None, ju, up, JDDIM.from_config(scfg), scaling_factor=1)
    tp = TPipe(None, tu, TDDIM.from_config(scfg), scaling_factor=1)
    rng = np.random.default_rng(8)
    ends = [rand(rng, (1, 8, 8, 4)) for _ in range(2)]
    frames = rand(rng, (3, 8, 8, 4))
    a = np.asarray([0.0, 0.5, 1.0], np.float32)
    jkv = [jp.denoise(jnp.asarray(e), 2, collect_kv=True)[1] for e in ends]
    tkv = [tp.denoise(nchw(e), 2, collect_kv=True)[1] for e in ends]
    want, _ = jp.denoise(jnp.asarray(frames), 2, kv_traj=jkv[0],
                         kv_traj2=jkv[1], alpha=a[:, None, None])
    got, none = tp.denoise(nchw(frames), 2, kv_traj=tkv[0], kv_traj2=tkv[1],
                           alpha=a[:, None, None])
    assert none is None
    assert_rel_close(nhwc(got), want, ATOL, "interp latents")
