"""Flax parameters (as numpy) -> a state dict with the diffusers keys that
this package's modules carry.

Rules (the same as the JAX package's exporter):
- a path's containers get dotted indices: ``down_blocks_0`` ->
  ``down_blocks.0``, ``to_out_0`` -> ``to_out.0``, and the VAE's flattened
  ``down_blocks_0_resnets_0`` -> ``down_blocks.0.resnets.0``; names such as
  ``linear_1`` or ``conv1`` stay as they are;
- ``kernel`` -> ``weight``: conv HWIO -> OIHW, dense [in, out] -> [out, in];
- ``scale`` -> ``weight`` (norms);
- ``embedding`` -> ``embedding.weight``, not transposed.
"""

import re

import numpy as np
import torch

_CONTAINERS = ("down_blocks|up_blocks|resnets|attentions|downsamplers"
               "|upsamplers|to_out|transformer_blocks|norms|nets|net"
               "|controlnet_down_blocks|conv|layers|downsample|upsampler|mlp")


def _torch_parts(path_part: str) -> list:
    q = re.sub(r"(\d)_", r"\1.", path_part)
    q = re.sub(rf"\b({_CONTAINERS})_(\d+)", r"\1.\2", q)
    return q.split(".")


def from_flax(flat: dict) -> dict:
    """``flat`` maps a Flax parameter path (a tuple of names, or one string
    joined with '/') to its array; a leading ``params`` collection name is
    dropped. Returns {diffusers key: float tensor}."""
    out = {}
    for path, val in flat.items():
        if isinstance(path, str):
            path = tuple(path.split("/"))
        if path and path[0] == "params":
            path = path[1:]
        val = np.asarray(val)
        parts = [p for part in path[:-1] for p in _torch_parts(part)]
        leaf = path[-1]
        if leaf == "kernel":
            name = "weight"
            val = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
        elif leaf == "scale":
            name = "weight"
        elif leaf == "embedding":
            parts.append("embedding")
            name = "weight"
        else:
            name = leaf
        out[".".join(parts + [name])] = torch.tensor(val)
    return out


def text_encoder_from_flax(flat: dict) -> dict:
    """``FlaxCLIPTextModel`` parameters (flat as for ``from_flax``) -> the
    state dict of ``text_encoder.CLIPTextModel``, whose keys are the
    Hugging Face torch ``CLIPTextModel``'s: the path joined with dots,
    ``kernel`` -> ``weight`` transposed, ``scale`` and ``embedding`` ->
    ``weight``."""
    out = {}
    for path, val in flat.items():
        if isinstance(path, str):
            path = tuple(path.split("/"))
        if path and path[0] == "params":
            path = path[1:]
        val = np.asarray(val)
        leaf = path[-1]
        if leaf == "kernel":
            val = val.T
        name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
        out[".".join(path[:-1] + (name,))] = torch.tensor(val)
    return out
