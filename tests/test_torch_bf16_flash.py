"""The bf16 flash forwards' plain versions on the CPU against the JAX flash
kernels in interpret mode (numpy inputs from a seed of the case's
parameters): ``flash_fwd_plain`` against ``_flash_3d`` and
``flash2_fwd_plain`` against ``_flash2_3d``, both at a key tile of 128 (the
JAX ``block_k``), at the head dims 8, 24, 40, 80 and 160 and Lk of 77 (one
tile), 256 and 1024. JAX's ``_pick_block`` takes no block below 128 unless
Lk fits in one, so a ragged Lk such as 200 cannot be tiled this way.

What is held, and how tightly:

- The function before the output's rounding: q given in float32 (bf16
  values) and k, v in bf16, both packages round p to v's dtype and return
  the f32 output. RMS of the difference at most ATTN_RATIO of JAX's own
  gap there (the same kernel on float32 k and v: the error of p's
  rounding). The rounded output is that value rounded once.
- The bf16 output: max at most 2 bf16 ulps of the output's largest
  magnitude; lse within 1e-5. The RMS ratio is not taken on the rounded
  outputs: two float32 implementations sum in other orders, and where an
  output average cancels to near zero that flips its bf16 rounding; at D
  >= 40 and Lk = 1024 those flips alone came near ATTN_RATIO of JAX's gap,
  and JAX's own outputs lie as far from an exact float64 evaluation of the
  same function as the plain version's.
- Accuracy: the online softmax's RMS error against float32 at most
  ACCURACY of ``sdpa_xla``'s at bf16 (measured 0.91-0.95 for K3's plain
  version, 0.76-0.77 for K6's, which rounds once where ``sdpa2_xla``
  rounds each set's output and then the blend).
- ``sdpa_eager`` and ``sdpa2_eager``, what the dispatchers take beyond the
  kernels (D > 256, K/V sets of unequal shapes), keep ``sdpa_xla``'s and
  ``sdpa2_xla``'s semantics at bf16: max 2 ulps of the output's scale, RMS
  of the difference at most EAGER_RATIO of JAX's own gap. Rounded outputs
  are compared there (both round p and the output inside), so the float32
  sum orders' flips count: 0.078 measured at D = 320, where a score sums
  320 products. The online softmax lies 1.0-1.6 of the gap from
  ``sdpa_xla`` (test_torch_bf16.py), so the bound still tells the two
  roundings apart.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu.ops import attention as JA
from afldm_tpu_torch.ops import attention as TA
from test_torch_bf16 import (ACCURACY, ATTN_RATIO, _bf16, _f32, _rms,
                             _scale_ulp, _t32)
from test_torch_harness import rand

torch.set_num_threads(1)

BF = torch.bfloat16
DIMS = [8, 24, 40, 80, 160]
KEYS = [77, 256, 1024]
KEY_TILE = 128
# the eager paths against sdpa_xla / sdpa2_xla on rounded outputs, as a
# share of JAX's own gap: chip_smoke's BF16_FLASH_RATIO, its bound for one
# function summed in two orders
EAGER_RATIO = 0.1


def _inputs(seed, lq_shape, lk_shape, n_kv):
    rng = np.random.default_rng(seed)
    q = _bf16(rand(rng, lq_shape))
    return q, [_bf16(rand(rng, lk_shape)) for _ in range(n_kv)]


def _close_before_rounding(got, want, want32):
    """RMS(got - want) <= ATTN_RATIO x RMS(want - want32), f32 outputs."""
    gap = _rms(want - want32)
    assert gap > 0
    ratio = _rms(got - want) / gap
    assert ratio <= ATTN_RATIO, ratio


def _within_ulps(got, want, ulps=2):
    assert np.abs(got - want).max() <= ulps * _scale_ulp(want)


@pytest.mark.parametrize("Lk", KEYS)
@pytest.mark.parametrize("D", DIMS)
def test_flash_fwd_plain_matches_flash_3d(D, Lk):
    q, (k, v) = _inputs([3, D, Lk], (2, 128, D), (2, Lk, D), 2)
    scale = 1 / math.sqrt(D)
    jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (k, v))
    want_u, jlse = JA._flash_3d(jnp.asarray(q), jk, jv, scale, 1024,
                                KEY_TILE)
    want32, _ = JA._flash_3d(*(jnp.asarray(t) for t in (q, k, v)), scale,
                             1024, KEY_TILE)
    want_b, _ = JA._flash_3d(jnp.asarray(q, jnp.bfloat16), jk, jv, scale,
                             1024, KEY_TILE)
    tk, tv = (torch.from_numpy(t).to(BF) for t in (k, v))
    got_u, lse_u = TA.flash_fwd_plain(torch.from_numpy(q), tk, tv,
                                      key_tile=KEY_TILE)
    got_b, lse = TA.flash_fwd_plain(torch.from_numpy(q).to(BF), tk, tv,
                                    key_tile=KEY_TILE)
    assert got_u.dtype == torch.float32 and got_b.dtype == BF
    _close_before_rounding(got_u.numpy(), np.asarray(want_u),
                           np.asarray(want32))
    assert torch.equal(got_b, got_u.to(BF))  # rounded once
    _within_ulps(_t32(got_b), _f32(want_b))
    for got_lse in (lse, lse_u):
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(jlse),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("Lk", KEYS)
@pytest.mark.parametrize("D", DIMS)
def test_flash2_fwd_plain_matches_flash2_3d(D, Lk):
    q, kvs = _inputs([4, D, Lk], (3, 64, D), (3, Lk, D), 4)
    alpha = np.float32([0.0, 0.3, 1.0]).reshape(3, 1, 1)
    scale = 1 / math.sqrt(D)
    ja = jnp.asarray(alpha)
    jkv = [jnp.asarray(t, jnp.bfloat16) for t in kvs]
    want_u = JA._flash2_3d(jnp.asarray(q), *jkv, ja, scale, 512, KEY_TILE)
    want32 = JA._flash2_3d(*(jnp.asarray(t) for t in (q, *kvs)), ja, scale,
                           512, KEY_TILE)
    want_b = JA._flash2_3d(jnp.asarray(q, jnp.bfloat16), *jkv, ja, scale,
                           512, KEY_TILE)
    tkv = [torch.from_numpy(t).to(BF) for t in kvs]
    ta = torch.from_numpy(alpha)
    got_u = TA.flash2_fwd_plain(torch.from_numpy(q), *tkv, ta,
                                key_tile=KEY_TILE)
    got_b = TA.flash2_fwd_plain(torch.from_numpy(q).to(BF), *tkv, ta,
                                key_tile=KEY_TILE)
    assert got_u.dtype == torch.float32 and got_b.dtype == BF
    _close_before_rounding(got_u.numpy(), np.asarray(want_u),
                           np.asarray(want32))
    assert torch.equal(got_b, got_u.to(BF))  # one rounding after the blend
    _within_ulps(_t32(got_b), _f32(want_b))


# (batch·heads, Lq, Lk, D): the FFHQ UNet's 32 px attention, the SD UNet's
# 64 px, 32 px and 16 px levels (cut in batch and, at 64 px, in tokens)
ACCURACY_SHAPES = [(2, 1024, 1024, 24), (2, 1024, 1024, 40),
                   (2, 1024, 1024, 80), (2, 256, 256, 160)]


@pytest.mark.parametrize("shape", ACCURACY_SHAPES,
                         ids=["x".join(map(str, s)) for s in ACCURACY_SHAPES])
def test_online_flash_is_as_accurate_as_sdpa_xla(shape):
    """RMS(plain at bf16 - f32) <= ACCURACY x RMS(sdpa_xla at bf16 - f32)
    on the same bf16 values, for K3's and K6's plain versions at the
    port's key tile."""
    B, Lq, Lk, D = shape
    q, (k, v, k1, v1) = _inputs([5, *shape], (B, Lq, D), (B, Lk, D), 4)
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, k1, v1)]
    j32 = [jnp.asarray(t) for t in (q, k, v, k1, v1)]
    alpha = np.float32([0.3, 0.8]).reshape(2, 1, 1)
    tb = [torch.from_numpy(t).to(BF) for t in (q, k, v, k1, v1)]
    for got, xla, f32 in (
            (TA.flash_fwd_plain(*tb[:3])[0], JA.sdpa_xla(*jb[:3]),
             JA.sdpa_xla(*j32[:3])),
            (TA.flash2_fwd_plain(*tb, torch.from_numpy(alpha)),
             JA.sdpa2_xla(*jb, jnp.asarray(alpha)),
             JA.sdpa2_xla(*j32, jnp.asarray(alpha)))):
        err = _rms(_t32(got) - _f32(f32))
        assert err <= ACCURACY * _rms(_f32(xla) - _f32(f32)), err


def test_key_tile_follows_the_padded_head_dim():
    """The kernels' table at D padded to a multiple of 16 within {32, 48,
    64, 80, 128, 160, 256}: 128 keys up to DP = 128, 64 at 160, 32 at
    256."""
    tiles = {d: TA.flash_bf16_key_tile(d) for d in range(1, 257)}
    for lo, hi, bk in ((1, 128, 128), (129, 160, 64), (161, 256, 32)):
        assert {tiles[d] for d in range(lo, hi + 1)} == {bk}, (lo, hi)
    for bad in (0, 257):
        with pytest.raises(ValueError):
            TA.flash_bf16_key_tile(bad)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors, ``flash_fwd`` and ``flash2_fwd`` at bf16 are the
    online plain versions at the kernels' key tile; at f32 the softmax
    attention and ``sdpa2_eager``."""
    q, kvs = _inputs(6, (2, 3, 64, 40), (2, 3, 300, 40), 4)
    tq, tkv = torch.from_numpy(q), [torch.from_numpy(t) for t in kvs]
    alpha = torch.tensor([0.25, 0.5])
    out, lse = TA.flash_fwd(tq.to(BF), *(t.to(BF) for t in tkv[:2]))
    want, want_lse = TA.flash_fwd_plain(tq.to(BF), *(t.to(BF)
                                                     for t in tkv[:2]))
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    # 300 keys: two full 128-key tiles and a ragged one, not one pass
    assert not torch.equal(out, TA.sdpa_eager(tq.to(BF), *(
        t.to(BF) for t in tkv[:2])))
    assert torch.equal(TA.flash_fwd(tq, *tkv[:2])[0],
                       TA._attention_plain(tq, *tkv[:2])[0])
    got2 = TA.flash2_fwd(tq.to(BF), *(t.to(BF) for t in tkv), alpha)
    assert torch.equal(got2, TA.flash2_fwd_plain(
        tq.to(BF), *(t.to(BF) for t in tkv), alpha))
    assert torch.equal(TA.flash2_fwd(tq, *tkv, alpha),
                       TA.sdpa2_eager(tq, *tkv, alpha))


def test_eager_paths_keep_sdpa_xla_semantics():
    """Beyond the kernels the dispatchers take the plain softmax: ``sdpa``
    at D = 320 (the VAE mid-block's kind of head) against ``sdpa_xla`` at
    bf16, and ``sdpa2`` over K/V sets of unequal lengths against
    ``sdpa2_xla``."""
    q, (k, v) = _inputs(7, (2, 64, 320), (2, 64, 320), 2)
    tb = [torch.from_numpy(t).to(BF) for t in (q, k, v)]
    got = TA.sdpa(*tb)
    assert torch.equal(got, TA.sdpa_eager(*tb))
    _eager_close(_t32(got),
                 _f32(JA.sdpa_xla(*(jnp.asarray(t, jnp.bfloat16)
                                    for t in (q, k, v)))),
                 _f32(JA.sdpa_xla(*(jnp.asarray(t) for t in (q, k, v)))))
    q, (k0, v0) = _inputs(8, (2, 64, 24), (2, 64, 24), 2)
    _, (k1, v1) = _inputs(9, (2, 1, 24), (2, 32, 24), 2)
    alpha = np.float32([0.3, 0.6]).reshape(2, 1, 1)
    args = (q, k0, v0, k1, v1)
    tb = [torch.from_numpy(t).to(BF) for t in args]
    got = TA.sdpa2(*tb, torch.from_numpy(alpha))
    assert torch.equal(got, TA.sdpa2_eager(*tb, torch.from_numpy(alpha)))
    _eager_close(_t32(got),
                 _f32(JA.sdpa2_xla(*(jnp.asarray(t, jnp.bfloat16)
                                     for t in args), jnp.asarray(alpha))),
                 _f32(JA.sdpa2_xla(*(jnp.asarray(t) for t in args),
                                   jnp.asarray(alpha))))


def _eager_close(got, want, want32):
    gap = _rms(want - want32)
    assert gap > 0
    assert _rms(got - want) <= EAGER_RATIO * gap, _rms(got - want) / gap
    _within_ulps(got, want)
