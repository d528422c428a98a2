"""bfloat16 activations on the serving path, on the CPU, against the JAX
package at bf16 (numpy inputs from a seed, JAX parameters carried across
with ``from_flax``).

What is held, and how tightly:

- ``_apply_sep`` (the resamplers' circulant products) with
  ``set_af_bf16_split`` on, and off, against JAX's ``_apply_sep`` at
  bf16: no element more than one bf16 ulp off, at most 1 % of them
  different (float32 sums in another order on a rounding edge).
- The filtered activation's plain versions (K5, K1) at bf16 and every
  level against ``filtered_act_pallas`` at bf16 in interpret mode
  ('default': against test_torch_precision.py's numpy emulation): no
  element more than one ulp off, at most 0.1 % different (measured: one
  element in 8192 at K5 'highest'; the f32 sums run in XLA's order there,
  and at a level as test_torch_precision.py holds them at f32). An
  element that cancels to near zero may carry ATOL besides.
- ``sdpa``, ``sdpa2`` and ``flash_fwd``'s plain path at bf16 against the
  JAX flash kernels in interpret mode (``sdpa_flash``, ``sdpa2_flash``,
  ``_flash_3d``) with the port's key tile as their ``block_k``: RMS of the
  difference at most ATTN_RATIO of JAX's own bf16 - f32 RMS gap, max 2
  bf16 ulps of the output's largest magnitude; ``_flash_3d``'s lse within
  1e-5. Both compute the TPU kernels' online softmax, which rounds p
  unnormalised; ``sdpa_xla`` (the normalised p rounded) lies 1.0-1.6 times
  that gap from it (``test_flash_tiling_explains_the_kernel``), and the
  online form is the closer of the two to float32.
- ResnetBlock2D, Attention, the AF up/downsamplers, the tiny UNet, the
  tiny AF-VAE (encode, decode) and the tiny protocol (2 steps, 2 shifts)
  at ``dtype=bfloat16`` against Flax's ``dtype=jnp.bfloat16``, compiled
  without XLA's excess precision and with the filtered activations in its
  Pallas kernels' semantics (``_kernel_semantics``: the filtered
  activations, and the attention through ``sdpa_flash`` and
  ``sdpa2_flash`` at the port's key tile): RMS of the difference
  at most the fraction in MODEL_RATIO of JAX's own bf16 - f32 RMS gap on
  the same inputs, and the port's own error against JAX at f32 at most
  ACCURACY of that gap; the protocol's PSNRs within PSNR_ATOL of JAX's at
  bf16 and at f32.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu.ops import attention as JA
from afldm_tpu.ops import ideal_lpf as JL
from afldm_tpu.ops import set_af_precision as jax_set_af_precision
from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch import models as T
from afldm_tpu_torch.models.layers import set_compute_dtype
from afldm_tpu_torch.ops import attention as TA
from afldm_tpu_torch.ops import filtered_act as TF
from afldm_tpu_torch.ops import ideal_lpf as TL
from test_torch_harness import (jax_apply, jax_init, load_port, nchw, nhwc,
                                numpy_init, rand)

torch.set_num_threads(1)

BF = torch.bfloat16
# attention's plain paths against the JAX flash kernels, as a share of
# JAX's own bf16 - f32 RMS gap
ATTN_RATIO = 0.05
# the models against Flax at bf16, as a share of Flax's own bf16 - f32
# RMS gap on the same inputs
# RMS on the same inputs (blocks: 0.142 measured for the resnet block, 0
# for the attention block and the AF resamplers; whole models: 0.95 UNet,
# 1.01 encoder, measured); and the port's own bf16 - f32 RMS error at most
# ACCURACY of JAX's. A block's difference is float32 sums in another order
# (the group norm's statistics, cuDNN's or XLA's convolutions) that land a
# bf16 rounding on the other side of its edge, 0.1 % of the elements; a
# whole model amplifies those flips as it amplifies its own roundings, so
# at its output the two bf16 runs lie about as far apart as either from
# float32, and only that, not bit agreement, is claimed there
MODEL_RATIO = {"resnet": 0.3, "attention": 0.05, "downsample": 0.05,
               "upsample": 0.05, "unet": 1.25, "vae_encode": 1.25,
               "vae_decode": 1.25, "protocol": 1.25}
ACCURACY = 1.25
# the protocol's masked PSNRs within this of JAX's at bf16 and at f32: the
# repo's equivariance-parity budget
PSNR_ATOL = 0.1


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _bf16(a):
    """numpy float32 -> the nearest bf16 values, as float32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


# float32 sums in another order: an element that cancels to near zero
# carries this absolute error, many of its own ulps
ATOL = 1e-6


def _ulps(a, b, atol=ATOL):
    """|a - b| beyond ``atol`` in bf16 ulps of the larger of |a| and |b|
    (2^(e - 8) for |v| = m·2^e, 0.5 <= m < 1), for bf16-valued arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    d = np.maximum(np.abs(a - b) - atol, 0.0)
    return np.where(d > 0, d / np.ldexp(1.0, e - 8), 0.0)


def _assert_ulp_close(got, want, share=1e-3):
    """No element more than one ulp off (beyond ATOL), at most ``share`` of
    them different."""
    got, want = np.asarray(got), np.asarray(want)
    u = _ulps(got, want)
    differ = float((got != want).mean())
    assert u.max() <= 1 and differ <= share, (u.max(), differ)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t32(t):
    return t.detach().float().numpy()


@pytest.fixture
def reset():
    """Both packages back to 'highest' and no bf16 split after the test."""
    yield
    TL.set_af_precision("highest")
    TL.set_af_bf16_split(False)
    jax_set_af_precision("highest")
    JL.set_af_bf16_split(False)


# -- the circulant resamplers ------------------------------------------------

@pytest.mark.parametrize("split", [True, False], ids=["split", "promoted"])
@pytest.mark.parametrize("op", ["up", "down"])
def test_apply_sep_at_bf16_matches_jax(reset, split, op):
    rng = np.random.default_rng(0)
    x = _bf16(rand(rng, (2, 16, 12, 3)))  # NHWC, bf16 values
    build = JL._upsample_op if op == "up" else JL._downsample_op
    want = _f32(JL._apply_sep(jnp.asarray(x, jnp.bfloat16), build(16, 2),
                              build(12, 2), bf16_split=split))
    TL.set_af_bf16_split(split)
    fn = TL.upsample_rfft if op == "up" else TL.downsample_rfft
    got = fn(nchw(x).to(BF), 2)
    assert got.dtype == BF
    _assert_ulp_close(nhwc(got.float()), want, share=0.01)
    if split:  # the split changes the result
        TL.set_af_bf16_split(False)
        assert not torch.equal(fn(nchw(x).to(BF), 2), got)


def test_split_is_read_at_call_time(reset):
    assert TL.af_bf16_split() is False
    TL.set_af_bf16_split(1)
    assert TL.af_bf16_split() is True
    from afldm_tpu_torch.ops import set_af_bf16_split
    set_af_bf16_split(False)
    assert TL.af_bf16_split() is False


# -- the filtered activation's plain versions --------------------------------

def _jax_pallas(x, mode, level):
    """``filtered_act_pallas`` at bf16 and ``level`` (interpret mode): a
    new jitted function per level (the kernels read it at trace time)."""
    jax_set_af_precision(level)
    try:
        f = jax.jit(lambda v, _level=level: filtered_act_pallas(
            v, "silu", mode))
        return _f32(f(jnp.asarray(x, jnp.bfloat16)))
    finally:
        jax_set_af_precision("highest")


# (NHWC shape, JAX mode, the port's plain version and wrapper): K5 at 8 px,
# K1's spatial chain at 96 px
FILTERED_CASES = [((2, 8, 8, 64), "channel", "plane"),
                  ((1, 96, 96, 2), "spatial", "banded")]


@pytest.mark.parametrize("lev", ["highest", "high", "default"])
@pytest.mark.parametrize("shape,mode,kernel", FILTERED_CASES,
                         ids=["k5", "k1"])
def test_filtered_act_plain_at_bf16_matches_pallas(reset, shape, mode,
                                                   kernel, lev):
    """The plain version, and the wrapper on a CPU tensor, at bf16: the f32
    function between a bf16 load and a bf16 store, as the Pallas kernel
    computes a bf16 x. XLA's CPU dot runs 'default' exactly inside Pallas
    too, so there the reference is test_torch_precision.py's numpy
    emulation of the split, rounded to bf16."""
    from test_torch_precision import np_forward
    rng = np.random.default_rng(1)
    x = _bf16(rand(rng, shape))
    if lev == "default":
        want = nhwc(torch.from_numpy(_bf16(np_forward(
            nchw(x).numpy(), lev, "k5" if kernel == "plane" else "k1"))))
    else:
        want = _jax_pallas(x, mode, lev)
    plain = getattr(TF, f"filtered_act_{kernel}_plain")
    got = plain(nchw(x).to(BF), "silu", lev)
    assert got.dtype == BF
    TL.set_af_precision(lev)
    wrapped = getattr(TF, f"filtered_act_{kernel}")(nchw(x).to(BF), "silu")
    assert torch.equal(wrapped, got)
    # f(f32(x)) rounded once
    assert torch.equal(got, plain(nchw(x), "silu", lev).to(BF))
    _assert_ulp_close(nhwc(got.float()), want)


def test_filtered_act_bf16_backward_on_the_cpu():
    """The CPU plain path keeps autograd at bf16: the gradient is the f32
    VJP of the same values, rounded to bf16."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_bf16(rand(rng, (1, 2, 8, 8)))).to(BF)
    g = torch.from_numpy(_bf16(rand(rng, (1, 2, 8, 8)))).to(BF)
    xr = x.clone().requires_grad_()
    TF.filtered_act_fused(xr, "silu").backward(g)
    want = TF.filtered_act_plane_bwd_plain(x.float(), g.float(), "silu")
    assert xr.grad.dtype == BF
    assert torch.equal(xr.grad, want.to(BF))


# -- attention ---------------------------------------------------------------

def _qkv(rng, shape, n=3):
    return [_bf16(rand(rng, shape)) for _ in range(n)]


def _scale_ulp(a):
    """The bf16 ulp of the largest magnitude of ``a``: attention's outputs
    are averages, an element near zero carries the absolute error of its
    row's weights."""
    return float(np.ldexp(1.0, np.frexp(np.abs(a).max())[1] - 8))


def _attn_close(got, want, want32):
    """RMS(got - want) <= ATTN_RATIO x RMS(want - want32), max |got -
    want| <= 2 ulps of the output's scale."""
    gap = _rms(want - want32)
    assert gap > 0
    ratio = _rms(got - want) / gap
    assert ratio <= ATTN_RATIO, ratio
    assert np.abs(got - want).max() <= 2 * _scale_ulp(want)
    return ratio


def _block_k(D):
    """The port's bf16 key tile at head dim D, as JAX's ``block_k``."""
    return TA.flash_bf16_key_tile(D)


@pytest.mark.parametrize("shape", [(2, 2, 256, 40), (1, 3, 64, 24),
                                   (2, 1, 16, 8)])
def test_sdpa_at_bf16_matches_sdpa_xla(shape):
    """``sdpa`` at bf16 against ``sdpa_flash`` at bf16 in interpret mode
    with the port's key tile (once ``sdpa_xla``, whose normalised p the
    port's K3 rounded before it took the TPU kernel's function)."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, shape)
    bk = _block_k(shape[-1])
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    want = _f32(JA.sdpa_flash(*jb, None, 1024, bk))
    want32 = _f32(JA.sdpa_flash(*(jnp.asarray(t) for t in (q, k, v)), None,
                                1024, bk))
    tb = [torch.from_numpy(t).to(BF) for t in (q, k, v)]
    got = TA.sdpa(*tb)
    assert got.dtype == BF
    _attn_close(_t32(got), want, want32)
    out, lse = TA.flash_fwd(*tb)
    assert out.dtype == BF and lse.dtype == torch.float32
    assert torch.equal(out, got)


def test_sdpa2_at_bf16_matches_sdpa2_xla():
    """``sdpa2`` at bf16 against ``sdpa2_flash`` at bf16 in interpret mode
    with the port's key tile (once ``sdpa2_xla``)."""
    rng = np.random.default_rng(4)
    q, k0, v0, k1, v1 = _qkv(rng, (3, 2, 64, 24), 5)
    alpha = np.float32([0.0, 0.3, 1.0])[:, None, None]
    bk = _block_k(24)
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k0, v0, k1, v1)]
    want = _f32(JA.sdpa2_flash(*jb, jnp.asarray(alpha), None, 512, bk))
    want32 = _f32(JA.sdpa2_flash(*(jnp.asarray(t) for t in (q, k0, v0, k1,
                                                             v1)),
                                 jnp.asarray(alpha), None, 512, bk))
    tb = [torch.from_numpy(t).to(BF) for t in (q, k0, v0, k1, v1)]
    got = TA.sdpa2(*tb, torch.from_numpy(alpha))
    assert got.dtype == BF
    _attn_close(_t32(got), want, want32)
    assert torch.equal(got, TA.flash2_fwd(*tb, torch.from_numpy(alpha)))


def test_flash_fwd_plain_against_flash_3d():
    """``flash_fwd``'s plain path at bf16 against ``_flash_3d`` at the
    port's key tile over two tiles: lse within 1e-5, out within ATTN_RATIO
    and 2 ulps (was within 1.6 of the gap, when the port rounded p
    normalised)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, (4, 256, 40))
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    jout, jlse = JA._flash_3d(*jb, 1 / math.sqrt(40), 512, _block_k(40))
    want32 = _f32(JA._flash_3d(*(jnp.asarray(t) for t in (q, k, v)),
                               1 / math.sqrt(40), 512, _block_k(40))[0])
    out, lse = TA.flash_fwd(*(torch.from_numpy(t).to(BF) for t in (q, k, v)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-6)
    _attn_close(_t32(out), _f32(jout), want32)


def _tiles_emulation(q, k, v, bk=128, normalised=False):
    """bf16 attention over ``bk``-key tiles in float32 (torch, bf16-valued
    inputs): an online softmax that rounds exp(s - running max) to bf16
    (``normalised`` False, the TPU kernel's and the port's K3), or two
    passes that first take the row max and sum, then round exp(s - m) / l
    (``sdpa_xla``'s rounding, which the port's K3 took before)."""
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if normalised:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        return torch.matmul((p / p.sum(-1, keepdim=True)).to(BF).float(), v)
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for j in range(0, s.shape[-1], bk):
        st = s[..., j:j + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        c = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + torch.matmul(p.to(BF).float(), v[..., j:j + bk, :])
        m = m_new
    return acc / l


@pytest.mark.parametrize("L,D", [(1024, 24), (256, 40)])
def test_flash_tiling_explains_the_kernel(L, D):
    """The online softmax at the port's key tile is ``_flash_3d`` at that
    ``block_k`` (within ATTN_RATIO); rounding p before the row's max and
    sum are known moves the output from ``sdpa_xla`` at bf16 by more than
    bf16's own error (RMS ratio 1.3 measured at both shapes), while the
    normalised two-pass rounding stays within ATTN_RATIO of it; and the
    online form lies nearer float32 than ``sdpa_xla`` does (0.95 and 0.91
    of its gap measured), within ACCURACY."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, (2, L, D))
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    want = _f32(JA.sdpa_xla(*jb))
    f32 = _f32(JA.sdpa_xla(*(jnp.asarray(t) for t in (q, k, v))))
    gap = _rms(want - f32)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    online = _tiles_emulation(tq, tk, tv, _block_k(D)).to(BF).float().numpy()
    two_pass = _tiles_emulation(tq, tk, tv, normalised=True).to(BF).float()
    kernel = _f32(JA._flash_3d(*jb, 1 / math.sqrt(D), 1024, _block_k(D))[0])
    _attn_close(online, kernel, f32)
    assert 1.0 < _rms(online - want) / gap < 1.6
    assert _rms(two_pass.numpy() - want) / gap <= ATTN_RATIO
    assert _rms(online - f32) <= ACCURACY * gap


# -- the models at bf16 --------------------------------------------------------

# XLA's CPU compiler may keep a float32 value through a bf16 round trip
# (excess precision: the AF downsampler's conv output reached the circulant
# product unrounded, half of its outputs a bf16 ulp off). The JAX side
# compiles without it, so that every bf16 rounding the program writes
# happens, as in the port.
_NO_EXCESS = {"xla_allow_excess_precision": False}


def _exact(fn):
    """``fn`` jitted and compiled without excess precision."""
    return lambda *args: jax.jit(fn).lower(*args).compile(_NO_EXCESS)(*args)


def _filtered_act_semantics(orig):
    """The JAX models' filtered activation as its Pallas kernels compute a
    bf16 x (float32 inside, rounded once; ``filtered_act_pallas`` at bf16
    equals it, ``test_filtered_act_plain_at_bf16_matches_pallas``), which
    the port's K5 and K1 follow, where those take the shape (H, W % 4 ==
    0). On the CPU the JAX package runs the XLA chain instead, whose 2x
    intermediate is rounded to bf16 before the activation."""
    from afldm_tpu.ops.ideal_lpf import filtered_nonlinearity

    def fused(x, act="silu"):
        if x.ndim >= 4 and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0:
            return filtered_nonlinearity(x.astype(jnp.float32),
                                         act).astype(x.dtype)
        return orig(x, act)
    return fused


def _jax_key_tile(D, Lk):
    """JAX's ``block_k`` for the port's bf16 key tile at (D, Lk): one block
    up to the tile, else the tile, which ``_pick_block`` must take."""
    bk = TA.flash_bf16_key_tile(D)
    if Lk > bk and JA._pick_block(Lk, bk) != bk:
        raise ValueError(f"the JAX flash kernel cannot tile Lk={Lk} in the "
                         f"port's {bk}-key tiles")
    return bk


def _attention_semantics(sdpa_orig, sdpa2_orig):
    """The JAX models' attention at bf16 as the TPU kernels compute it,
    which the port's K3 and K6 follow: ``sdpa_flash`` and ``sdpa2_flash``
    in interpret mode with the port's key tile as ``block_k`` (one Q block)
    wherever the port's ``sdpa`` and ``sdpa2`` take their kernels (D <= 256;
    for ``sdpa2`` K/V sets of one shape). Elsewhere, and at f32, the JAX
    dispatch as it is (``sdpa_xla`` on the CPU)."""
    def sdpa(q, k, v, scale=None):
        if q.dtype == jnp.bfloat16 and q.shape[-1] <= TA.FLASH_MAX_D:
            return JA.sdpa_flash(q, k, v, scale, q.shape[-2],
                                 _jax_key_tile(q.shape[-1], k.shape[-2]))
        return sdpa_orig(q, k, v, scale)

    def sdpa2(q, k0, v0, k1, v1, alpha, scale=None):
        if (q.dtype == jnp.bfloat16 and q.shape[-1] <= TA.FLASH_MAX_D
                and k0.shape == k1.shape):
            return JA.sdpa2_flash(q, k0, v0, k1, v1, alpha, scale,
                                  q.shape[-2],
                                  _jax_key_tile(q.shape[-1], k0.shape[-2]))
        return sdpa2_orig(q, k0, v0, k1, v1, alpha, scale)
    return sdpa, sdpa2


def _kernel_semantics(setattr_=setattr):
    """Sets the JAX models' filtered activation (``_filtered_act_semantics``)
    and attention (``_attention_semantics``) to their Pallas kernels' bf16
    semantics, through ``setattr_``: monkeypatch's in a test, the builtin
    in a subprocess of its own."""
    import afldm_tpu.models.attention_blocks as jblocks
    import afldm_tpu.models.layers as jlayers
    setattr_(jlayers, "filtered_act_fused",
             _filtered_act_semantics(jlayers.filtered_act_fused))
    sdpa, sdpa2 = _attention_semantics(jlayers.sdpa, jlayers.sdpa2)
    setattr_(jlayers, "sdpa", sdpa)
    setattr_(jlayers, "sdpa2", sdpa2)
    setattr_(jblocks, "sdpa", sdpa)


@pytest.fixture
def kernel_semantics(monkeypatch):
    _kernel_semantics(monkeypatch.setattr)


def _randomize(params, seed=1):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(l) + 0.1 * rng.standard_normal(l.shape)
              .astype(np.float32) for l in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _model_close(got, want, want32, what):
    """RMS(got - want) <= MODEL_RATIO[what] x RMS(want - want32), and
    RMS(got - want32) <= ACCURACY x RMS(want - want32)."""
    gap = _rms(want - want32)
    assert gap > 0, what
    ratio = _rms(np.asarray(got) - want) / gap
    assert ratio <= MODEL_RATIO[what], (what, ratio)
    assert _rms(np.asarray(got) - want32) <= ACCURACY * gap, what
    return ratio


def _pair(jcls, *args, **kw):
    """The Flax module at bf16 and at f32."""
    return jcls(*args, dtype=jnp.bfloat16, **kw), jcls(*args, **kw)


def _apply_both(jb, j32, p, *args, method=None):
    """(bf16 output, f32 output) of a Flax pair, as float32 numpy."""
    def run(m):
        return lambda p, *a: m.apply(p, *a, method=method)
    return (_f32(_exact(run(jb))(p, *args)), _f32(jax.jit(run(j32))(p,
                                                                   *args)))


def test_resnet_block_at_bf16(kernel_semantics):
    rng = np.random.default_rng(7)
    x, t = rand(rng, (2, 8, 8, 16)), rand(rng, (2, 24))
    jb, j32 = _pair(J.ResnetBlock2D, 32, groups=4, filtered_act=True)
    p = _randomize(jax_init(j32, jnp.asarray(x), jnp.asarray(t)))
    want, want32 = _apply_both(jb, j32, p, jnp.asarray(x), jnp.asarray(t))
    tm = load_port(set_compute_dtype(T.ResnetBlock2D(
        16, 32, 24, groups=4, filtered_act=True), BF), p)
    got = tm(nchw(x), torch.from_numpy(t))
    assert got.dtype == BF
    _model_close(nhwc(got.float()), want, want32, "resnet")
    assert all(q.dtype == torch.float32 for q in tm.parameters())


def test_attention_at_bf16(kernel_semantics):
    rng = np.random.default_rng(8)
    x, ref = rand(rng, (3, 4, 4, 16)), rand(rng, (1, 4, 4, 16))
    jb, j32 = _pair(J.Attention, num_heads=2, groups=4)
    p = _randomize(jax_init(j32, jnp.asarray(x)))
    tm = load_port(set_compute_dtype(T.Attention(16, 2, groups=4), BF), p)
    for kv in (None, ref):
        jkv = () if kv is None else (jnp.asarray(kv.reshape(1, 16, 16)),)
        want, want32 = (_f32(_exact(lambda p, *a: m.apply(p, *a)[0])(
            p, jnp.asarray(x), *jkv)) for m in (jb, j32))
        got, _ = tm(nchw(x), *(() if kv is None else (nchw(kv),)))
        _model_close(nhwc(got.float()), want, want32, "attention")


@pytest.mark.parametrize("what", ["downsample", "upsample"])
def test_af_resamplers_at_bf16(what):
    rng = np.random.default_rng(9)
    x = rand(rng, (2, 8, 8, 4))
    jcls = J.Downsample2D if what == "downsample" else J.Upsample2D
    jb, j32 = _pair(jcls, 6, alias_free=True)
    p = _randomize(jax_init(j32, jnp.asarray(x)))
    want, want32 = _apply_both(jb, j32, p, jnp.asarray(x))
    tcls = T.Downsample2D if what == "downsample" else T.Upsample2D
    tm = load_port(set_compute_dtype(tcls(4, 6, alias_free=True), BF), p)
    got = tm(nchw(x))
    assert got.dtype == BF
    _model_close(nhwc(got.float()), want, want32, what)


def _tiny_jax():
    """The tiny FFHQ UNet and AF-VAE of the CLI in the JAX package, at bf16
    and f32, and their numpy-drawn parameters."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    juc = UNet2DConfig.from_diffusers(ucfg, alias_free=True)
    jvc = AutoencoderKLConfig.from_diffusers(vcfg)
    ju = {dt: UNet2DModel(juc, dtype=dt) for dt in (jnp.bfloat16,
                                                   jnp.float32)}
    jv = {dt: AutoencoderKL(jvc, dtype=dt) for dt in (jnp.bfloat16,
                                                     jnp.float32)}
    up = numpy_init(ju[jnp.float32], jnp.zeros((1, 8, 8, 4)),
                    jnp.zeros((1,), jnp.int32))
    vp = numpy_init(jv[jnp.float32], jnp.zeros((1, 64, 64, 3)), seed=1)
    return dict(ju=ju, jv=jv, up=up, vp=vp, ucfg=ucfg, vcfg=vcfg, scfg=scfg)


@pytest.fixture(scope="module")
def tiny():
    """``_tiny_jax`` and the port's modules at bf16 on its parameters."""
    out = _tiny_jax()
    tcfg = T.UNet2DConfig.from_diffusers(out["ucfg"], alias_free=True)
    tvc = T.AutoencoderKLConfig.from_diffusers(out["vcfg"])
    out["tu"] = load_port(T.UNet2DModel(tcfg, dtype=BF), out["up"])
    out["tv"] = load_port(T.AutoencoderKL(tvc, dtype=BF), out["vp"])
    return out


def test_tiny_unet_at_bf16(tiny, kernel_semantics):
    rng = np.random.default_rng(10)
    x = rand(rng, (2, 8, 8, 4))
    t = np.asarray([999, 501], np.int32)
    want, want32 = (_f32(_exact(lambda p, x, t: tiny["ju"][dt].apply(
        p, x, t)[0])(tiny["up"], jnp.asarray(x), jnp.asarray(t)))
        for dt in (jnp.bfloat16, jnp.float32))
    got, stored = tiny["tu"](nchw(x), torch.from_numpy(t))
    assert got.dtype == BF and all(s.dtype == BF for s in stored)
    _model_close(nhwc(got.float()), want, want32, "unet")


def test_tiny_vae_at_bf16(tiny, kernel_semantics):
    rng = np.random.default_rng(11)
    img = rand(rng, (2, 64, 64, 3))
    z = rand(rng, (2, 8, 8, 4))
    jb, j32 = tiny["jv"][jnp.bfloat16], tiny["jv"][jnp.float32]
    want, want32 = (_f32(_exact(lambda p, x: m.apply(p, x, method=m.encode)[
        0])(tiny["vp"], jnp.asarray(img))) for m in (jb, j32))
    mean, _ = tiny["tv"].encode(nchw(img))
    assert mean.dtype == BF
    _model_close(nhwc(mean.float()), want, want32, "vae_encode")
    want, want32 = _apply_both(jb, j32, tiny["vp"], jnp.asarray(z),
                               method=jb.decode)
    dec = tiny["tv"].decode(nchw(z))
    assert dec.dtype == BF
    _model_close(nhwc(dec.float()), want, want32, "vae_decode")


# JAX's tiny protocol at bf16 and f32, in a process of its own: the
# pipeline jits inside, so excess precision is switched off for the whole
# process (XLA_FLAGS)
_JAX_PROTOCOL = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path[:0] = [{tests!r}, {repo!r}]
from test_torch_bf16 import _kernel_semantics, _tiny_jax
from test_torch_harness import rand
_kernel_semantics()
from afldm_tpu.pipelines import LDMPipeline, shift_equivariance_eval
from afldm_tpu.schedulers import DDIMScheduler
t = _tiny_jax()
lat = rand(np.random.default_rng(15), (1, 8, 8, 4))
out = {{}}
for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
    r = shift_equivariance_eval(
        LDMPipeline(t["jv"][dt], t["vp"], t["ju"][dt], t["up"],
                    DDIMScheduler.from_config(t["scfg"])),
        init_latent=jnp.asarray(lat), num_inference_steps=2,
        num_shift_steps=2)
    out[name + "_psnrs"] = np.asarray(r.psnrs, np.float32)
    out[name + "_outputs"] = np.asarray(r.outputs, np.float32)
np.savez({out!r}, lat=lat, **out)
"""


def test_tiny_protocol_at_bf16(tiny, tmp_path):
    """2 steps, 2 shifts: per-shift masked PSNR, and the outputs."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    from afldm_tpu_torch.pipelines import LDMPipeline as TPipe
    from afldm_tpu_torch.pipelines import shift_equivariance_eval as teval
    from afldm_tpu_torch.schedulers import DDIMScheduler as TDDIM
    tests = Path(__file__).resolve().parent
    out = tmp_path / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c", _JAX_PROTOCOL.format(
        tests=str(tests), repo=str(tests.parent), out=str(out))], env=env,
        check=True, timeout=600)
    ref = np.load(out)
    got = teval(TPipe(tiny["tv"], tiny["tu"], TDDIM.from_config(
        tiny["scfg"])), init_latent=nchw(ref["lat"]), num_inference_steps=2,
        num_shift_steps=2)
    assert np.isfinite(got.psnrs).all()
    for name in ("bf16", "f32"):
        d = np.abs(got.psnrs - ref[name + "_psnrs"]).max()
        assert d <= PSNR_ATOL, (name, got.psnrs, ref[name + "_psnrs"])
    _model_close(got.outputs, ref["bf16_outputs"], ref["f32_outputs"],
                 "protocol")


# -- the entry points ------------------------------------------------------

def test_shift_cli_bf16_smoke(reset, capsys):
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import main
    res = main(["--tiny", "--device", "cpu", "--num_inference_steps", "2",
                "--shift_steps", "2", "--bf16"])
    assert np.isfinite(res.psnrs).all() and res.outputs.dtype == np.float32
    assert "mean shift-equivariance PSNR" in capsys.readouterr().out
    TL.set_af_bf16_split(True)
    split = main(["--tiny", "--device", "cpu", "--num_inference_steps", "2",
                  "--shift_steps", "2", "--bf16"])
    assert not np.array_equal(split.outputs, res.outputs)


def test_loaders_take_the_dtype(tmp_path):
    import json
    from afldm_tpu_torch.pipelines import (init_random_interp_pipeline,
                                           init_random_pipeline,
                                           load_pipeline)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    cfgs = load_configs(tiny=True)
    pipe = init_random_pipeline(*cfgs, device="cpu", dtype=BF)
    f32 = init_random_pipeline(*cfgs, device="cpu")
    assert pipe.unet.dtype == pipe.vae.dtype == BF
    for a, b in ((pipe.unet, f32.unet), (pipe.vae, f32.vae)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) and sa[k].dtype == sb[k].dtype
                   for k in sa)
    (tmp_path / "unet_config.json").write_text(json.dumps(cfgs[0]))
    (tmp_path / "vae_config.json").write_text(json.dumps(cfgs[1]))
    loaded = load_pipeline(str(tmp_path), device="cpu", allow_random=True,
                           dtype=BF)
    assert loaded.unet.dtype == BF
    # the SD-family UNet computes in bf16 too (once refused)
    from afldm_tpu_torch.scripts.image_interpolation import \
        load_configs as sd_configs
    interp = init_random_interp_pipeline(*sd_configs(tiny=True),
                                         device="cpu", dtype=BF)
    assert interp.unet.dtype == interp.vae.dtype == BF
    assert all(p.dtype == torch.float32 for p in interp.unet.parameters())


def test_bench_measures_bf16(monkeypatch):
    """``scripts.bench``'s bf16 rows on the tiny UNet: compute and weights
    in bf16 (the root bench.py's ``cast_params``), the bf16 peak share."""
    from afldm_tpu_torch.scripts import bench
    from test_torch_bench import _tiny_unet
    monkeypatch.setattr(bench, "unet_config", _tiny_unet)
    d = bench.measure(n_steps=2, repeats=1, device="cpu",
                      return_details=True, dtype=BF, cast_params=True)
    assert d["dtype"] == d["weights"] == "bfloat16"
    assert d["af_precision"] == "highest" and d["steps_per_s"] > 0
    assert d["mfu_vs_989tflops_bf16"] == pytest.approx(
        d["tflop_per_s"] / 989.0)
