"""The port's layers and models against the JAX package, with the JAX
parameters carried across through ``from_flax`` and loaded strictly.

Tolerances: single layers 1e-5 absolute (f32 conv / group-norm rounding
differs between XLA and PyTorch at ~1e-6); whole reduced models 1e-4
relative to the output's scale (rounding compounds over dozens of layers).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afldm_tpu import models as J
from afldm_tpu_torch import models as T
from test_torch_harness import (assert_rel_close, jax_apply, jax_init,
                                load_port, nchw, nhwc, rand, tt)

torch.set_num_threads(1)

ATOL = 1e-5


def _randomize(params, seed=1):
    """Perturb every leaf: Flax initialises biases to 0 and norm scales to
    1, which would leave those conversions untested."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(l) + 0.1 * rng.standard_normal(l.shape)
              .astype(np.float32) for l in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("cin,cout,filtered,temb", [
    (16, 16, False, True), (16, 32, True, True), (8, 16, True, False)])
def test_resnet_block(rng, cin, cout, filtered, temb):
    x = rand(rng, (2, 8, 8, cin))
    t = rand(rng, (2, 24)) if temb else None
    jm = J.ResnetBlock2D(cout, groups=4, filtered_act=filtered)
    p = _randomize(jax_init(jm, jnp.asarray(x),
                            None if t is None else jnp.asarray(t)))
    want = jax_apply(jm)(p, jnp.asarray(x), None if t is None else jnp.asarray(t))
    tm = load_port(T.ResnetBlock2D(cin, cout, 24 if temb else None,
                                   groups=4, filtered_act=filtered), p)
    got = tm(nchw(x), None if t is None else tt(t))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_attention_store_and_load(rng):
    x = rand(rng, (3, 4, 4, 16))
    ref_map = rand(rng, (1, 4, 4, 16))
    jm = J.Attention(num_heads=2, groups=4)
    p = _randomize(jax_init(jm, jnp.asarray(x)))
    tm = load_port(T.Attention(16, 2, groups=4), p)
    # STORE: self-attention, returns the pre-norm map
    want, want_stored = jax_apply(jm)(p, jnp.asarray(x))
    got, stored = tm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(nhwc(stored).reshape(3, 16, 16),
                               np.asarray(want_stored), atol=0)
    # LOAD: K/V from a batch-1 stored map, broadcast over the batch of 3
    want, _ = jax_apply(jm)(p, jnp.asarray(x),
                       jnp.asarray(ref_map.reshape(1, 16, 16)))
    got, _ = tm(nchw(x), nchw(ref_map))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_attention_load_repeats_override_batch(rng):
    """A stored batch of 2 over 4 frames repeats each map twice, as
    jnp.repeat does."""
    x = rand(rng, (4, 4, 4, 16))
    ref_map = rand(rng, (2, 4, 4, 16))
    jm = J.Attention(num_heads=2, groups=4)
    p = _randomize(jax_init(jm, jnp.asarray(x)))
    tm = load_port(T.Attention(16, 2, groups=4), p)
    want, _ = jax_apply(jm)(p, jnp.asarray(x),
                            jnp.asarray(ref_map.reshape(2, 16, 16)))
    got, _ = tm(nchw(x), nchw(ref_map))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("alias_free,padding", [(False, 1), (False, 0),
                                                (True, 1)])
def test_downsample(rng, alias_free, padding):
    x = rand(rng, (2, 8, 8, 4))
    jm = J.Downsample2D(6, padding=padding, alias_free=alias_free)
    p = _randomize(jax_init(jm, jnp.asarray(x)))
    want = jax_apply(jm)(p, jnp.asarray(x))
    tm = load_port(T.Downsample2D(4, 6, padding=padding,
                                  alias_free=alias_free), p)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("alias_free", [False, True])
def test_upsample(rng, alias_free):
    x = rand(rng, (2, 4, 6, 4))
    jm = J.Upsample2D(6, alias_free=alias_free)
    p = _randomize(jax_init(jm, jnp.asarray(x)))
    want = jax_apply(jm)(p, jnp.asarray(x))
    tm = load_port(T.Upsample2D(4, 6, alias_free=alias_free), p)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("flip,shift", [(True, 0), (False, 1)])
def test_timestep_embedding(flip, shift):
    t = np.asarray([0, 7, 981], np.int64)
    want = J.get_timestep_embedding(jnp.asarray(t), 33, flip, shift)
    got = T.get_timestep_embedding(torch.from_numpy(t), 33, flip, shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_timestep_embedding_module(rng):
    x = rand(rng, (2, 8))
    jm = J.TimestepEmbedding(12)
    p = _randomize(jax_init(jm, jnp.asarray(x)))
    tm = load_port(T.TimestepEmbedding(8, 12), p)
    np.testing.assert_allclose(tm(tt(x)).detach().numpy(),
                               np.asarray(jax_apply(jm)(p, jnp.asarray(x))),
                               atol=ATOL)


def test_kv_helper():
    h = T.KVHelper(("a", "b"))
    assert (h.take(), h.take()) == (("a", None), ("b", None))
    h.push(1)
    assert h.collected() == (1,)
    assert T.KVHelper().take() == (None, None)
    h2 = T.KVHelper(("a",), ("c",), alpha=0.25)
    assert h2.take() == ("a", "c") and h2.alpha == 0.25


# -- reduced UNet (the --tiny config of scripts/shift_ldm_ffhq.py) -----------

UNET = dict(sample_size=8, block_out_channels=(32, 64),
            down_block_types=("AttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "AttnUpBlock2D"),
            layers_per_block=1, attention_head_dim=8, norm_num_groups=8,
            alias_free=True)


@pytest.fixture(scope="module")
def unet_pair():
    jm = J.UNet2DModel(J.UNet2DConfig(**UNET))
    p = _randomize(jax_init(jm, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))),
                   seed=5)
    tm = load_port(T.UNet2DModel(T.UNet2DConfig(**UNET)), p)
    return jm, p, tm


def test_unet_store_pass(unet_pair):
    jm, p, tm = unet_pair
    x = rand(np.random.default_rng(3), (2, 8, 8, 4))
    want, want_maps = jax_apply(jm)(p, jnp.asarray(x), jnp.asarray([981, 1]))
    got, maps = tm(nchw(x), torch.tensor([981, 1]))
    assert_rel_close(nhwc(got), want, 1e-4, "eps")
    assert len(maps) == len(want_maps) == 4  # down, mid, 2 x up
    for g, w in zip(maps, want_maps):
        assert_rel_close(nhwc(g).reshape(w.shape), w, 1e-4, "stored map")


def test_unet_load_pass(unet_pair):
    jm, p, tm = unet_pair
    rng = np.random.default_rng(4)
    ref = rand(rng, (1, 8, 8, 4))
    x = rand(rng, (3, 8, 8, 4))
    _, jmaps = jax_apply(jm)(p, jnp.asarray(ref), jnp.asarray(501))
    want, _ = jax_apply(jm)(p, jnp.asarray(x), jnp.asarray(501), kv_in=jmaps)
    _, tmaps = tm(nchw(ref), 501)
    got, _ = tm(nchw(x), 501, kv_in=tmaps)
    assert_rel_close(nhwc(got), want, 1e-4, "eps (LOAD)")


def test_unet_config_from_diffusers():
    cfg = T.UNet2DConfig.from_diffusers({"_class_name": "UNet2DModel",
                                         "sample_size": 16}, alias_free=True)
    assert cfg.sample_size == 16 and cfg.alias_free
    assert cfg.resolved_filtered_act()
    assert dataclasses.replace(cfg, filtered_act=False) \
        .resolved_filtered_act() is False


# -- reduced AF-VAE ------------------------------------------------------------

VAE = dict(block_out_channels=(16, 16, 16, 16), layers_per_block=1,
           latent_channels=4, norm_num_groups=8, sample_size=64,
           scaling_factor=0.6, alias_free=True,
           down_filtered_act=(False, True, True, True),
           up_filtered_act=(True, True, True, False),
           up_rescale=(True, True, True))


@pytest.fixture(scope="module")
def vae_pair():
    jm = J.AutoencoderKL(J.AutoencoderKLConfig(**VAE))
    p = _randomize(jax_init(jm, jnp.zeros((1, 64, 64, 3))), seed=6)
    tm = load_port(T.AutoencoderKL(T.AutoencoderKLConfig(**VAE)), p)
    return jm, p, tm


def test_vae_encode(vae_pair):
    jm, p, tm = vae_pair
    x = rand(np.random.default_rng(7), (1, 64, 64, 3))
    wm, wl = jax_apply(jm, "encode")(p, jnp.asarray(x))
    gm, gl = tm.encode(nchw(x))
    assert_rel_close(nhwc(gm), wm, 1e-4, "mean")
    assert_rel_close(nhwc(gl), wl, 1e-4, "logvar")


def test_vae_decode(vae_pair):
    jm, p, tm = vae_pair
    z = rand(np.random.default_rng(8), (2, 8, 8, 4))
    want = jax_apply(jm, "decode")(p, jnp.asarray(z))
    got = tm.decode(nchw(z))
    assert_rel_close(nhwc(got), want, 1e-4, "decode")


def test_vae_config():
    cfg = T.AutoencoderKLConfig.from_diffusers({"up_rescale": [True]})
    assert cfg.alias_free and cfg.downsample_ratio == 8
    assert not T.AutoencoderKLConfig.from_diffusers(
        {"up_rescale": [True], "alias_free": False}).alias_free


def test_gaussian_sample_follows_generator(rng):
    mean, logvar = (torch.from_numpy(rand(rng, (1, 4, 2, 2)))
                    for _ in range(2))
    got = T.gaussian_sample(mean, logvar, torch.Generator().manual_seed(3))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, mean + torch.exp(0.5 * logvar) * noise)
