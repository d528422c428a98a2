"""``checkpoint-{step}/`` training-state directories, written with
``torch.save``, with rotation that keeps the newest
``checkpoints_total_limit``, and resume-from-latest scanning. Counterpart
of ``afldm_tpu/train/checkpoint.py`` in the torch format: Orbax trees from
the JAX package are not read.

A checkpoint is written into a temporary directory and renamed into place,
so ``latest_checkpoint`` and rotation never see a half-written one.
"""

import os
import re
import shutil

import torch

STATE_FILE = "state.pt"


def _ckpt_dirs(output_dir):
    if not os.path.isdir(output_dir):
        return []
    ds = [d for d in os.listdir(output_dir)
          if re.fullmatch(r"checkpoint-\d+", d)]
    return sorted(ds, key=lambda d: int(d.split("-")[1]))


def latest_checkpoint(output_dir):
    ds = _ckpt_dirs(output_dir)
    return os.path.join(output_dir, ds[-1]) if ds else None


def save_checkpoint(output_dir, step, state, total_limit=None):
    """``state``: a dict of tensors, state dicts and numbers. Returns the
    checkpoint directory; removes the oldest beyond ``total_limit``."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if total_limit:
        ds = _ckpt_dirs(output_dir)
        while len(ds) > total_limit:
            shutil.rmtree(os.path.join(output_dir, ds.pop(0)),
                          ignore_errors=True)
    return path


def restore_checkpoint(path, map_location="cpu"):
    """The state saved under ``path``, tensors on ``map_location``."""
    f = os.path.join(path, STATE_FILE)
    if not os.path.exists(f):
        raise FileNotFoundError(
            f"{path} holds no {STATE_FILE}: not a checkpoint of this port "
            "(Orbax checkpoints of the JAX package are not read)")
    return torch.load(f, map_location=map_location, weights_only=True)


def resume_step_from_path(path):
    m = re.search(r"checkpoint-(\d+)$", path.rstrip("/"))
    return int(m.group(1)) if m else 0
