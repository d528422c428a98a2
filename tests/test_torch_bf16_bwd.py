"""The bf16 backward on the CPU: the plain versions of the flash backward
(K4a, K4b) and of the filtered activation's backward (K5b, K2) at bf16,
against the JAX package at bf16 (numpy inputs from a seed).

What is held, and how tightly:

- ``_bwd_dq_plain`` and ``_bwd_dkv_plain`` at bf16 against
  ``_flash_bwd_3d`` (the JAX kernels in interpret mode) on the same bf16
  q, k, v, dO and the same f32 lse and delta: RMS of the difference at most
  ATTN_RATIO of JAX's own bf16 - f32 gap (the same kernels on the same
  values in f32), max at most 2 bf16 ulps of the output's largest
  magnitude. Both round ds (and p for dv) to bf16 before the second
  product and the gradients once; they differ by f32 sum orders, which
  flip a bf16 rounding now and then.
- The whole bf16 VJP, ``sdpa`` through autograd, against ``jax.vjp`` of
  ``sdpa_flash`` at the port's key tile (``flash_vjp``: JAX's flash
  forward, the function the port's K3 computes, then ``_sdpa_bwd``: delta
  from that forward's out, then ``_flash_bwd_3d``): within ATTN_RATIO of
  JAX's own gap, as above (once ``sdpa_xla``'s forward with JAX's flash
  VJP, when the port's K3 rounded p normalised). Against ``jax.vjp`` of
  ``sdpa_flash`` at its default blocks (one 1024-key block; ``sdpa2``
  against ``sdpa2_flash``) the forwards round p at other running maxima
  where Lk exceeds the port's tile, which moves delta = rowsum(dO·O) and
  with it every ds: held to VJP_RATIO.
- K/V expanded from one image (the CFA LOAD batch): both packages form
  one bf16 dk and dv per leading index (the kernels write them dense) and
  sum them over the batch, in another order: the port's autograd in
  float32, rounded to bf16 once (``sum_to_size`` of a bf16 tensor); XLA,
  the transpose of ``jnp.repeat`` under jit, in bf16, rounded after each
  addition (measured: equal to ((g0 + g1) + g2) in bf16, 0.71 of JAX's
  own gap from the float32 sum). So the port is held to JAX's per-index
  gradients summed its way, at ATTN_RATIO, and its error against float32
  must not exceed JAX's.
- ``filtered_act_plane_bwd_plain`` and ``filtered_act_banded_bwd_plain``
  at bf16 and every level against ``jax.vjp`` of ``filtered_act_pallas``
  at bf16 (interpret mode), on the plane route (8 px) and the spatial one
  (96 px): no element more than one bf16 ulp off beyond the f32 atol, at
  most 0.1 % different; at 'default', where XLA's CPU dot runs exactly
  inside Pallas, against test_torch_precision.py's numpy emulation of the
  split, rounded to bf16, by the same rule. The f32 atol is
  test_torch_bf16.py's ATOL, and at 'high' and 96 px the level's own max
  error in f32, the bound test_torch_precision.py holds the f32 plain
  version to there (its exact sums against XLA's f32 sums move the bf16
  lo pieces of intermediates worth ~1e-5 of the output; measured 2.9 bf16
  ulps beyond ATOL at one element of 9216).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops import attention as JA
from afldm_tpu.ops import set_af_precision as jax_set_af_precision
from afldm_tpu.ops.pallas_kernels import filtered_act_pallas
from afldm_tpu_torch.ops import attention as TA
from afldm_tpu_torch.ops import filtered_act as TF
from afldm_tpu_torch.ops import ideal_lpf as TL
from test_torch_bf16 import (ATOL, ATTN_RATIO, _bf16, _f32, _jax_key_tile,
                             _rms, _scale_ulp, _t32, _ulps)
from test_torch_harness import nchw, nhwc, rand

torch.set_num_threads(1)

BF = torch.bfloat16
# the whole VJP against jax.vjp(sdpa_flash) at bf16 and its default
# blocks, whose key tile may differ from the port's, as a share of JAX's
# own bf16 - f32 gap
VJP_RATIO = 1.25


def _attn_close(got, want, want32, ratio=ATTN_RATIO, ulps=2):
    """RMS(got - want) <= ratio x RMS(want - want32), max |got - want| <=
    ``ulps`` bf16 ulps of the output's scale. Returns the RMS ratio."""
    got, want, want32 = (np.asarray(a, np.float32)
                         for a in (got, want, want32))
    assert got.shape == want.shape
    gap = _rms(want - want32)
    assert gap > 0
    r = _rms(got - want) / gap
    assert r <= ratio, r
    assert np.abs(got - want).max() <= ulps * _scale_ulp(want)
    return r


# (B, H, Lq, Lk, D, K/V batch): the UNets' head dims 24 and 40, 77 text
# tokens, and K/V expanded from one image
BWD_SHAPES = [(2, 2, 256, 256, 40, 2), (1, 3, 64, 64, 24, 1),
              (1, 2, 64, 77, 40, 1), (3, 2, 64, 64, 24, 1)]
BWD_IDS = ["256x40", "64x24", "cross77", "expanded"]


def _qkv(shape, seed):
    B, H, Lq, Lk, D, _ = shape
    rng = np.random.default_rng(seed)
    q, do = (_bf16(rand(rng, (B * H, Lq, D))) for _ in range(2))
    k, v = (_bf16(rand(rng, (B * H, Lk, D))) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("shape", BWD_SHAPES[:3], ids=BWD_IDS[:3])
def test_flash_bwd_plain_at_bf16_matches_flash_bwd_3d(shape):
    """The plain versions of K4a and K4b against the JAX kernels in
    interpret mode, given the same lse and delta."""
    q, k, v, do = _qkv(shape, 0)
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do)]
    out, lse = JA._flash_3d(*jb[:3], scale, 1024, 1024)
    delta = jnp.sum(jb[3].astype(jnp.float32) * out.astype(jnp.float32),
                    axis=-1, keepdims=True)
    want = JA._flash_bwd_3d(*jb, lse, delta, scale, 1024, 1024)
    want32 = JA._flash_bwd_3d(*(jnp.asarray(t) for t in (q, k, v, do)),
                              lse, delta, scale, 1024, 1024)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(BF) for t in (q, k, v, do))
    tl, td = (torch.from_numpy(np.array(t)) for t in (lse, delta))
    dq = TA.flash_bwd_dq(tq, tk, tv, tdo, tl, td, scale)
    dk, dv = TA.flash_bwd_dkv(tq, tk, tv, tdo, tl, td, scale)
    for got, w, w32 in zip((dq, dk, dv), want, want32):
        assert got.dtype == BF
        _attn_close(_t32(got), _f32(w), _f32(w32))


def _port_tiled_flash(q, k, v):
    """``sdpa_flash`` with the port's key tile as its ``block_k`` (one Q
    block): the forward the port computes, and JAX's flash VJP on it."""
    return JA.sdpa_flash(q, k, v, None, q.shape[-2],
                         _jax_key_tile(q.shape[-1], k.shape[-2]))


def _jax_vjp(q, k, v, do, nkv, attn=JA.sdpa_flash):
    """jax.vjp of ``attn`` at the dtype of the inputs, K/V repeated from
    ``nkv`` images to q's batch (the JAX blocks' ``jnp.repeat``)."""
    reps = q.shape[0] // k.shape[0]

    def f(q, k, v):
        if reps > 1:
            k, v = jnp.repeat(k, reps, 0), jnp.repeat(v, reps, 0)
        return attn(q, k, v)
    fn = jax.jit(lambda q, k, v, g: jax.vjp(f, q, k, v)[1](g))
    return fn.lower(q, k, v, do).compile(
        {"xla_allow_excess_precision": False})(q, k, v, do)


@pytest.mark.parametrize("ref", ["flash_vjp", "sdpa_flash"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=BWD_IDS)
def test_sdpa_bf16_gradient_matches_jax_vjp(shape, ref):
    """sdpa at bf16 through autograd (the flash Function: the plain
    forward, then K4a and K4b's plain versions) against ``jax.vjp`` of
    ``sdpa_flash`` at bf16 at the port's key tile (``flash_vjp``) and at
    its default blocks; K/V per leading index or expanded from one image
    (each leading index's dk and dv summed by autograd)."""
    B, H, Lq, Lk, D, nkv = shape
    q, k, v, do = _qkv(shape, 1)
    if nkv == 1 and B > 1:  # one image's K/V for every leading index
        k, v = k[:H], v[:H]
    shp = lambda a, n: a.reshape(n, H, *a.shape[1:])  # noqa: E731
    jq, jk, jv, jdo = (shp(jnp.asarray(t), n) for t, n in
                       ((q, B), (k, k.shape[0] // H), (v, v.shape[0] // H),
                        (do, B)))
    attn = _port_tiled_flash if ref == "flash_vjp" else JA.sdpa_flash
    ratio = ATTN_RATIO if ref == "flash_vjp" else VJP_RATIO
    want = _jax_vjp(*(t.astype(jnp.bfloat16) for t in (jq, jk, jv, jdo)),
                    nkv, attn)
    want32 = _jax_vjp(jq, jk, jv, jdo, nkv, attn)
    tq, tk, tv = (torch.from_numpy(np.asarray(t)).to(BF).requires_grad_()
                  for t in (jq, jk, jv))
    expand = tk.shape[0] < B
    ek, ev = ((t.expand(B, -1, -1, -1) for t in (tk, tv)) if expand
              else (tk, tv))
    out = TA.sdpa(tq, ek, ev)
    assert out.dtype == BF
    out.backward(torch.from_numpy(np.asarray(jdo)).to(BF))
    if expand and ref == "flash_vjp":
        # JAX's per-index gradients, summed in float32 and rounded once
        per = _jax_vjp(*(t.astype(jnp.bfloat16) for t in (
            jq, jnp.repeat(jk, B, 0), jnp.repeat(jv, B, 0), jdo)), 1, attn)
        summed = [_bf16(_f32(g).sum(0, keepdims=True)) for g in per[1:]]
        for t, w, w32, s in zip((tk, tv), want[1:], want32[1:], summed):
            assert _rms(_t32(t.grad) - _f32(w32)) <= _rms(_f32(w)
                                                           - _f32(w32))
            _attn_close(_t32(t.grad), s, _f32(w32))
        want = (want[0],)
    for t, w, w32 in zip((tq, tk, tv), want, want32):
        assert t.grad.dtype == BF and t.grad.shape == t.shape
        _attn_close(_t32(t.grad), _f32(w), _f32(w32), ratio,
                    2 if ref == "flash_vjp" else 4)


def test_sdpa2_bf16_gradient_matches_jax_vjp():
    """sdpa2's bf16 VJP (two K3 recomputes, then K4a and K4b once per KV
    set) against ``jax.vjp`` of ``sdpa2_flash`` at bf16
    (tests/test_attention.py::test_sdpa2_grad_bf16 is its JAX
    counterpart), with one alpha per frame."""
    rng = np.random.default_rng(2)
    args = [_bf16(rand(rng, (3, 2, 64, 24))) for _ in range(5)]
    do = _bf16(rand(rng, (3, 2, 64, 24)))
    alpha = np.float32([0.2, 0.5, 0.9])[:, None, None]

    def jvjp(dt):
        def f(*a):
            return JA.sdpa2_flash(*a, jnp.asarray(alpha))
        fn = jax.jit(lambda *a: jax.vjp(f, *a[:5])[1](a[5]))
        ins = [jnp.asarray(t, dt) for t in (*args, do)]
        return fn.lower(*ins).compile(
            {"xla_allow_excess_precision": False})(*ins)
    want, want32 = jvjp(jnp.bfloat16), jvjp(jnp.float32)
    ts = [torch.from_numpy(t).to(BF).requires_grad_() for t in args]
    out = TA.sdpa2(*ts, torch.from_numpy(alpha))
    assert out.dtype == BF
    out.backward(torch.from_numpy(do).to(BF))
    for t, w, w32 in zip(ts, want, want32):
        assert t.grad.dtype == BF
        _attn_close(_t32(t.grad), _f32(w), _f32(w32), VJP_RATIO, 4)


# -- the filtered activation's backward ---------------------------------------

@pytest.fixture
def reset():
    yield
    TL.set_af_precision("highest")
    jax_set_af_precision("highest")


def _jax_pallas_vjp(x, g, mode, level, dt=jnp.bfloat16):
    """jax.vjp of ``filtered_act_pallas`` at ``dt`` and ``level``
    (interpret mode): a new jitted function per level."""
    jax_set_af_precision(level)
    try:
        f = jax.jit(lambda v, w, _level=level: jax.vjp(
            lambda u: filtered_act_pallas(u, "silu", mode), v)[1](w)[0])
        return _f32(f(jnp.asarray(x, dt), jnp.asarray(g, dt)))
    finally:
        jax_set_af_precision("highest")


# (NHWC shape, JAX mode, the port's kernel): K5b at 8 px, K2 at 96 px
BWD_CASES = [((2, 8, 8, 64), "channel", "plane"),
             ((1, 96, 96, 2), "spatial", "banded")]


@pytest.mark.parametrize("lev", ["highest", "high", "default"])
@pytest.mark.parametrize("shape,mode,kernel", BWD_CASES,
                         ids=["k5b", "k2"])
def test_filtered_act_bwd_plain_at_bf16_matches_pallas(reset, shape, mode,
                                                       kernel, lev):
    """The plain version (and the autograd Function on a CPU tensor) at
    bf16: the f32 VJP of the bf16 values, rounded once."""
    from test_torch_precision import np_backward
    rng = np.random.default_rng(3)
    x, g = _bf16(rand(rng, shape)), _bf16(rand(rng, shape))
    if lev == "default":
        want = nhwc(torch.from_numpy(_bf16(np_backward(
            nchw(x).numpy(), nchw(g).numpy(), lev,
            "k5b" if kernel == "plane" else "k2"))))
    else:
        want = _jax_pallas_vjp(x, g, mode, lev)
    atol = ATOL
    if lev == "high" and mode == "spatial":
        atol = float(np.abs(_jax_pallas_vjp(x, g, mode, lev, jnp.float32)
                            - _jax_pallas_vjp(x, g, mode, "highest",
                                              jnp.float32)).max())
    plain = getattr(TF, f"filtered_act_{kernel}_bwd_plain")
    tx, tg = nchw(x).to(BF), nchw(g).to(BF)
    got = plain(tx, tg, "silu", lev)
    assert got.dtype == BF
    assert torch.equal(got, plain(tx.float(), tg.float(), "silu",
                                  lev).to(BF))
    TL.set_af_precision(lev)
    xr = tx.clone().requires_grad_()
    getattr(TF, f"filtered_act_{kernel}")(xr, "silu").backward(tg)
    assert torch.equal(xr.grad, got)
    got = nhwc(got.float())
    assert _ulps(got, want, atol).max() <= 1
    assert float((got != want).mean()) <= 1e-3
