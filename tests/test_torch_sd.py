"""The port's SD-family UNet and the interpolation's flow utilities against
the JAX package: ``BasicTransformerBlock``, ``Transformer2DModel`` and
``UNet2DConditionModel`` on the tiny config of the interpolation CLI, with
and without stored maps (STORE, LOAD and interp with one alpha per frame);
``get_intermediate_warp_mask``, ``forward_backward_consistency_check``,
``upsample_noise`` and ``collect_noise_pixel`` given the JAX draws, and the
Lucas-Kanade ``predict_flow``.

Tolerances: blocks 1e-5 absolute; the UNet 1e-5 relative to the output's
scale; the flow utilities exact where the arithmetic is the same and 1e-6
where it sums in another order; ``predict_flow`` 1e-4 px.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu.models.layers import KVHelper as JKV
from afldm_tpu.shift import flow as JF
from afldm_tpu.shift import simple_flow as JS
from afldm_tpu_torch import models as T
from afldm_tpu_torch.scripts.image_interpolation import TINY_UNET
from afldm_tpu_torch.shift import flow as TF
from afldm_tpu_torch.shift import simple_flow as TS
from test_torch_harness import (assert_rel_close, jax_apply, jax_init,
                                load_port, nchw, nhwc, rand, tt)
from test_torch_models import _randomize

torch.set_num_threads(1)

ATOL = 1e-5
SD_CFG = {k: tuple(v) if isinstance(v, list) else v
          for k, v in dict(TINY_UNET, alias_free=True).items()}


def _maybe(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else tt(a)


# -- transformer blocks -----------------------------------------------------------

@pytest.fixture(scope="module")
def block_pair():
    rng = np.random.default_rng(1)
    x, e = rand(rng, (3, 16, 16)), rand(rng, (1, 7, 12))
    jm = J.BasicTransformerBlock(num_heads=2, head_dim=8)
    p = _randomize(jax_init(jm, jnp.asarray(x), jnp.asarray(e)))
    return jm, p, load_port(T.BasicTransformerBlock(16, 2, 8, 12), p)


@pytest.mark.parametrize("mode", ["store", "load", "interp", "interp-default"])
def test_transformer_block_matches_jax(block_pair, mode):
    """attn1's K/V from the tokens, one stored map (batch 1, broadcast
    over the frames) or a blend of two with one alpha per frame; attn2
    over a batch-1 text context. The stored map is the post-norm1 map."""
    jm, p, tm = block_pair
    rng = np.random.default_rng(2)
    x, e = rand(rng, (3, 16, 16)), rand(rng, (1, 7, 12))
    m0, m1 = rand(rng, (1, 16, 16)), rand(rng, (1, 16, 16))
    args = {"store": (None, None, None), "load": (m0, None, None),
            "interp": (m0, m1, np.asarray([0.0, 0.4, 1.0], np.float32)),
            "interp-default": (m0, m1, None)}[mode]
    want, wstored = jax_apply(jm)(p, jnp.asarray(x), jnp.asarray(e),
                                  *map(_maybe, args))
    got, stored = tm(tt(x), tt(e), *map(_t, args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(stored.detach().numpy(), np.asarray(wstored),
                               atol=ATOL)


@pytest.mark.parametrize("depth", [1, 2])
def test_transformer2d_matches_jax(depth):
    rng = np.random.default_rng(3)
    x, e = rand(rng, (2, 4, 4, 16)), rand(rng, (1, 7, 12))
    maps = [rand(rng, (1, 16, 16)) for _ in range(2 * depth)]
    a = np.asarray([0.25, 0.75], np.float32)
    jm = J.Transformer2DModel(num_heads=2, head_dim=8, depth=depth, groups=4)

    def apply(p, x, e, k1, k2, a):
        kv = JKV(k1, k2, a)
        out = jm.apply(p, x, e, kv)
        return out, kv.collected()

    p = _randomize(jax.jit(lambda x, e: jm.init(
        jax.random.PRNGKey(0), x, e, JKV()))(jnp.asarray(x), jnp.asarray(e)))
    tm = load_port(T.Transformer2DModel(16, 2, 8, 12, depth=depth,
                                        groups=4), p)
    for k1, k2 in ((None, None), (maps[:depth], None),
                   (maps[:depth], maps[depth:])):
        want, wmaps = jax.jit(apply)(
            p, jnp.asarray(x), jnp.asarray(e),
            None if k1 is None else [jnp.asarray(m) for m in k1],
            None if k2 is None else [jnp.asarray(m) for m in k2],
            jnp.asarray(a))
        kv = T.KVHelper(None if k1 is None else [tt(m) for m in k1],
                        None if k2 is None else [tt(m) for m in k2], tt(a))
        got = tm(nchw(x), tt(e), kv)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
        assert len(kv.collected()) == len(wmaps) == depth
        for g, w in zip(kv.collected(), wmaps):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=ATOL)


# -- the tiny SD UNet ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_pair():
    jm = J.UNet2DConditionModel(J.UNet2DConditionConfig(**SD_CFG))
    p = _randomize(jax_init(jm, jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, 16))), seed=4)
    tm = load_port(T.UNet2DConditionModel(T.UNet2DConditionConfig(**SD_CFG)),
                   p)
    return jm, p, tm


def test_sd_unet_store_load_interp_match_jax(sd_pair):
    jm, p, tm = sd_pair
    rng = np.random.default_rng(5)
    ends = [rand(rng, (1, 8, 8, 4)) for _ in range(2)]
    x = rand(rng, (3, 8, 8, 4))
    e = rand(rng, (1, 77, 16)) * 0.5
    a = np.asarray([0.0, 0.5, 1.0], np.float32)[:, None, None]
    japply = jax_apply(jm)
    jmaps, tmaps = [], []
    for lat in ends:  # STORE
        want, wmaps = japply(p, jnp.asarray(lat), jnp.asarray([701]),
                             jnp.asarray(e))
        got, maps = tm(nchw(lat), torch.tensor([701]), tt(e))
        assert_rel_close(nhwc(got), want, ATOL, "eps (STORE)")
        assert len(maps) == len(wmaps) == 4  # down, mid, 2 x up
        for g, w in zip(maps, wmaps):
            assert_rel_close(g.detach().numpy(), w, ATOL, "stored map")
        jmaps.append(wmaps)
        tmaps.append(maps)
    want, _ = japply(p, jnp.asarray(x), jnp.asarray(701), jnp.asarray(e),
                     kv_in=jmaps[0])
    got, _ = tm(nchw(x), 701, tt(e), kv_in=tmaps[0])
    assert_rel_close(nhwc(got), want, ATOL, "eps (LOAD)")
    want, _ = japply(p, jnp.asarray(x), jnp.asarray(701), jnp.asarray(e),
                     kv_in=jmaps[0], kv_in2=jmaps[1], alpha=jnp.asarray(a))
    got, _ = tm(nchw(x), 701, tt(e), kv_in=tmaps[0], kv_in2=tmaps[1],
                alpha=tt(a))
    assert_rel_close(nhwc(got), want, ATOL, "eps (interp)")


def test_sd_unet_loads_jax_names_strictly(sd_pair):
    """Every key of the port's SD UNet comes from the JAX parameters
    (transformer_blocks_0, attn1, ff/net_0_proj, net_2, proj_in, ...) and
    none is left over."""
    _, p, tm = sd_pair
    keys = set(tm.state_dict())
    for k in ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
              ".weight",
              "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj"
              ".weight",
              "up_blocks.1.attentions.1.transformer_blocks.0.ff.net.2.bias",
              "mid_block.attentions.0.proj_in.weight",
              "down_blocks.0.downsamplers.0.conv.weight"):
        assert k in keys, k


def test_sd_config_refuses_per_block_head_dims():
    cfg = T.UNet2DConditionConfig.from_diffusers(
        {"_class_name": "UNet2DConditionModel", "sample_size": 32},
        alias_free=True)
    assert cfg.sample_size == 32 and cfg.alias_free
    with pytest.raises(NotImplementedError, match="per-block"):
        T.UNet2DConditionConfig.from_diffusers(
            {"attention_head_dim": [5, 10, 20, 20]})


# -- flow utilities ---------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_intermediate_warp_mask_matches_jax(rng, alpha):
    """The occlusion mask is exact; the backward flow equals JAX's where
    the target is hit exactly once, and is 0 (finite) where it is
    occluded, which JAX leaves to the scatter order."""
    flow = rand(rng, (2, 12, 10, 2)) * 3
    occ = (rng.random((2, 12, 10, 1)) > 0.7).astype(np.float32)
    wf, wo = JF.get_intermediate_warp_mask(jnp.asarray(flow),
                                           jnp.asarray(occ), alpha)
    gf, go = TF.get_intermediate_warp_mask(nchw(flow), nchw(occ), alpha)
    np.testing.assert_array_equal(nhwc(go), np.asarray(wo))
    keep = np.asarray(wo) == 0
    assert keep.any() and (~keep).any()
    np.testing.assert_allclose(nhwc(gf) * keep, np.asarray(wf) * keep,
                               atol=1e-6)
    assert np.all(nhwc(gf)[np.broadcast_to(~keep, nhwc(gf).shape)] == 0)


def test_consistency_check_matches_jax(rng):
    fwd = rand(rng, (2, 12, 10, 2)) * 2
    bwd = -fwd + rand(rng, (2, 12, 10, 2)) * 0.6
    want = JF.forward_backward_consistency_check(jnp.asarray(fwd),
                                                 jnp.asarray(bwd))
    got = TF.forward_backward_consistency_check(nchw(fwd), nchw(bwd))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(nhwc(g), np.asarray(w))
        assert 0 < np.asarray(w).mean() < 1


def test_noise_upsample_and_collect_match_jax(rng):
    """Given the JAX draws, the variance-preserving upsample and the
    re-aggregation with fresh noise on occluded pixels."""
    noise = rand(rng, (1, 4, 5, 3))
    kz, kf = jax.random.split(jax.random.PRNGKey(3))
    want_hi = JF.upsample_noise(jnp.asarray(noise), 4, kz)
    z = jax.random.normal(kz, (1, 16, 20, 3), jnp.float32)
    got_hi = TF.upsample_noise(nchw(noise), 4, z=nchw(z))
    np.testing.assert_allclose(nhwc(got_hi), np.asarray(want_hi), atol=1e-6)
    occ = (rng.random((1, 16, 20, 1)) > 0.6).astype(np.float32)
    want = JF.collect_noise_pixel(want_hi, jnp.asarray(occ), 4, kf)
    fresh = jax.random.normal(kf, want_hi.shape, jnp.float32)
    got = TF.collect_noise_pixel(got_hi, nchw(occ), 4, fresh=nchw(fresh))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


def test_noise_draws_follow_generator():
    noise = torch.zeros(1, 2, 3, 3)
    a = TF.upsample_noise(noise, 2, generator=torch.Generator().manual_seed(1))
    b = TF.upsample_noise(noise, 2, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    # every 2 x 2 patch of the centred draw sums to 0
    assert float(a.reshape(1, 2, 3, 2, 3, 2).sum((3, 5)).abs().max()) < 1e-6
    occ = torch.ones(1, 1, 6, 6)
    c = TF.collect_noise_pixel(a, occ, 2,
                               generator=torch.Generator().manual_seed(2))
    fresh = torch.randn(a.shape, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(
        c, fresh.reshape(1, 2, 3, 2, 3, 2).sum((3, 5)) / 2)


def test_predict_flow_matches_jax():
    """LK flow both ways and the occlusion masks on the CLI's 64 px pair
    (a blocky image and its copy rolled by 8 px)."""
    from afldm_tpu_torch.scripts.image_interpolation import image_pair
    img0, img1 = image_pair(64)
    want = JS.predict_flow(jnp.asarray(nhwc(img0)), jnp.asarray(nhwc(img1)))
    got = TS.predict_flow(img0, img1)
    for name, g, w in zip(("fwd", "fwd_occ", "bwd", "bwd_occ"), got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4,
                                   err_msg=name)
    assert float(np.abs(np.asarray(want[0])).max()) > 1  # it did move
