"""Shared helpers of the PyTorch-port parity tests, and the port's
package-level checks: weight conversion keys, the import guard and the
device default.

Helpers: inputs come from numpy, go to JAX as NHWC and to the port as NCHW;
JAX parameters go across through ``afldm_tpu_torch.models.convert.from_flax``
and load with ``strict=True``.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from afldm_tpu.models.convert import flax_to_torch
from afldm_tpu_torch.models.convert import from_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "afldm_tpu_torch"


# -- helpers shared by the test_torch_* files --------------------------------

def nchw(a) -> torch.Tensor:
    """NHWC numpy/JAX array -> NCHW float tensor (a copy: JAX arrays are
    read-only)."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def port_state(params) -> dict:
    """JAX params (with or without the 'params' collection) -> state dict."""
    return from_flax(flatten_dict(jax.device_get(params)))


def load_port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(port_state(params), strict=True)
    return module.eval()


def assert_rel_close(got, want, rel, what=""):
    """max |got - want| <= rel * max |want|: a tolerance relative to the
    tensor's scale, for whole models whose outputs cross zero."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} * {scale}"


def rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def jax_init(module, *args):
    return jax.jit(module.init)(jax.random.PRNGKey(0), *args)


def numpy_init(module, *args, seed=0):
    """Parameters of the JAX module's shape tree drawn with numpy (biases
    0, norm scales 1, other weights normal / sqrt(fan in)): no compiled
    init, which costs seconds per module on the CPU."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        if name == "scale":
            return np.ones(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_apply(module, method=None):
    """The module's apply, jitted (op-by-op JAX is slow on the CPU)."""
    return jax.jit(lambda p, *a, **k: module.apply(p, *a, method=method,
                                                   **k))


# -- from_flax --------------------------------------------------------------

def _tiny_unet_params():
    from afldm_tpu.models import UNet2DConfig, UNet2DModel
    cfg = UNet2DConfig(
        sample_size=8, down_block_types=("AttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "AttnUpBlock2D"),
        block_out_channels=(32, 64), layers_per_block=1,
        attention_head_dim=8, norm_num_groups=8, alias_free=True)
    return jax.eval_shape(lambda: UNet2DModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))))


def _tiny_vae_params():
    from afldm_tpu.models import AutoencoderKL, AutoencoderKLConfig
    cfg = AutoencoderKLConfig(block_out_channels=(16, 16), layers_per_block=1,
                              norm_num_groups=8, alias_free=True,
                              up_rescale=(True,))
    return jax.eval_shape(lambda: AutoencoderKL(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))


@pytest.mark.parametrize("make", [_tiny_unet_params, _tiny_vae_params],
                         ids=["unet", "vae"])
def test_from_flax_keys_match_flax_to_torch(make):
    shapes = make()
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = flax_to_torch(params)
    got = from_flax(flatten_dict(params))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k


def test_from_flax_accepts_string_paths():
    flat = {"params/conv_in/kernel": np.ones((3, 3, 2, 5), np.float32),
            "params/mid_block/attentions_0/to_out_0/kernel":
                np.ones((4, 6), np.float32),
            "params/encoder/down_blocks_1_resnets_0/norm1/scale":
                np.ones(7, np.float32)}
    got = from_flax(flat)
    assert tuple(got["conv_in.weight"].shape) == (5, 2, 3, 3)
    assert tuple(got["mid_block.attentions.0.to_out.0.weight"].shape) == (6, 4)
    assert "encoder.down_blocks.1.resnets.0.norm1.weight" in got


def test_tiny_models_load_strict():
    """Every key of the port's modules is produced by from_flax, and none
    is left over (strict loading), for the tiny pipeline of the CLI."""
    from afldm_tpu.models import (AutoencoderKL, AutoencoderKLConfig,
                                  UNet2DConfig, UNet2DModel)
    from afldm_tpu_torch import models as tm
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, _ = load_configs(tiny=True)
    ju = UNet2DModel(UNet2DConfig.from_diffusers(ucfg, alias_free=True))
    jv = AutoencoderKL(AutoencoderKLConfig.from_diffusers(vcfg))
    up = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8, 8, 4)),
                                        jnp.zeros((1,))))
    vp = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3))))
    for shapes, mod in ((up, tm.UNet2DModel(
            tm.UNet2DConfig.from_diffusers(ucfg, alias_free=True))),
            (vp, tm.AutoencoderKL(tm.AutoencoderKLConfig.from_diffusers(
                vcfg)))):
        params = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)
        mod.load_state_dict(port_state(params), strict=True)


# -- import guard -------------------------------------------------------------

_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|afldm_tpu)(?:\.|\s|$)", re.M)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_name_no_jax(path):
    text = path.read_text()
    assert not _IMPORT_RE.search(text), f"{path} imports JAX or afldm_tpu"
    assert "afldm_tpu." not in text, f"{path} names afldm_tpu."
    assert not re.search(r"\bjax\b", text), f"{path} names jax"


_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "flax", "afldm_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import afldm_tpu_torch
for m in pkgutil.walk_packages(afldm_tpu_torch.__path__, "afldm_tpu_torch."):
    importlib.import_module(m.name)
importlib.import_module("chip_smoke")
print("ok")
"""


def test_import_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


# -- device default -----------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch):
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts import shift_ldm_ffhq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_random_pipeline(*shift_ldm_ffhq.load_configs(tiny=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shift_ldm_ffhq.main(["--tiny", "--num_inference_steps", "1",
                             "--shift_steps", "1"])


def test_explicit_cpu_device_runs():
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    pipe = init_random_pipeline(*load_configs(tiny=True), device="cpu")
    assert pipe.device.type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_random_weights_follow_the_seed():
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    a = init_random_pipeline(*load_configs(tiny=True), seed=3, device="cpu")
    b = init_random_pipeline(*load_configs(tiny=True), seed=3, device="cpu")
    c = init_random_pipeline(*load_configs(tiny=True), seed=4, device="cpu")
    wa = a.unet.conv_in.weight
    assert torch.equal(wa, b.unet.conv_in.weight)
    assert not torch.equal(wa, c.unet.conv_in.weight)
