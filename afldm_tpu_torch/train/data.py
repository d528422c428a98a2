"""Input pipeline: image datasets as numpy on the host, batched by a seeded
epoch iterator. The port's own copy of ``afldm_tpu/train/data.py``:

- ``SyntheticDataset``: deterministic smooth random images, for tests,
  smoke runs and machines without data;
- ``DeadLeavesDataset``: procedural occluding-shapes images with
  natural-image statistics;
- ``ImageFolderDataset``: a recursive image-folder reader with resize,
  center or random crop and optional flip (PIL, imported when an image is
  read; the native C++ decoder is not bound yet).

Items are float32 HWC arrays in [-1, 1]; the trainer moves batches to the
device as NCHW.
"""

import os
from typing import Iterator

import numpy as np


IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class SyntheticDataset:
    """Smooth random images (bandlimited noise) in [-1, 1]."""

    def __init__(self, resolution=64, length=256, channels=3, seed=0):
        self.resolution = resolution
        self.length = length
        self.channels = channels
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        low = rng.standard_normal(
            (self.resolution // 8, self.resolution // 8, self.channels))
        img = np.kron(low, np.ones((8, 8, 1)))
        img = np.tanh(img).astype(np.float32)
        return {"input": img}


def dead_leaves_image(rng, resolution=256, min_shapes=40, max_shapes=90,
                      r_lo=6.0, r_hi=90.0):
    """One procedural 'dead leaves' image (occluding random disks /
    rectangles, power-law radii) as float32 HWC in [-1, 1].

    Dead-leaves images reproduce natural-image statistics (scale-invariant
    power spectrum, sharp occlusion edges at every scale) and are the
    standard synthetic stand-in when real photos are unavailable — exactly
    the full-band content on which resampling aliasing is visible."""
    n = int(rng.integers(min_shapes, max_shapes + 1))
    ii, jj = np.mgrid[0:resolution, 0:resolution].astype(np.float32)
    img = np.empty((resolution, resolution, 3), np.float32)
    img[:] = rng.uniform(-1, 1, (3,))
    # inverse-cube radius law, painted back-to-front (later shapes occlude)
    u = rng.uniform(0, 1, n)
    radii = 1.0 / np.sqrt(u * (1 / r_lo ** 2 - 1 / r_hi ** 2)
                          + 1 / r_hi ** 2)
    cy = rng.uniform(0, resolution, n)
    cx = rng.uniform(0, resolution, n)
    colors = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    is_disk = rng.random(n) < 0.7
    for k in range(n):
        if is_disk[k]:
            m = (ii - cy[k]) ** 2 + (jj - cx[k]) ** 2 <= radii[k] ** 2
        else:
            m = (np.abs(ii - cy[k]) <= radii[k]) \
                & (np.abs(jj - cx[k]) <= radii[k])
        img[m] = colors[k]
    return img


class DeadLeavesDataset:
    """Deterministic procedural dataset of dead-leaves images; item i is
    fully determined by (seed, i): sharp-edged content, where
    SyntheticDataset's is smooth block noise."""

    def __init__(self, resolution=256, length=2048, seed=0):
        self.resolution = resolution
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 1000003 + idx)
        return {"input": dead_leaves_image(rng, self.resolution)}


class ImageFolderDataset:
    def __init__(self, root, resolution=256, center_crop=True,
                 random_flip=False, seed=0):
        self.paths = []
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if os.path.splitext(f)[1].lower() in IMG_EXTS:
                    self.paths.append(os.path.join(dirpath, f))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.resolution = resolution
        self.center_crop = center_crop
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        from PIL import Image
        img = Image.open(self.paths[idx]).convert("RGB")
        w, h = img.size
        scale = self.resolution / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)),
                         Image.BICUBIC)
        w, h = img.size
        if self.center_crop:
            left = (w - self.resolution) // 2
            top = (h - self.resolution) // 2
        else:
            left = self.rng.integers(0, w - self.resolution + 1)
            top = self.rng.integers(0, h - self.resolution + 1)
        img = img.crop((left, top, left + self.resolution,
                        top + self.resolution))
        arr = np.asarray(img, np.float32) / 127.5 - 1.0
        if self.random_flip and self.rng.random() < 0.5:
            arr = arr[:, ::-1].copy()
        return {"input": arr}


def make_dataset(base_cfg):
    """train_data_dir when it is a directory, else SyntheticDataset at the
    configured resolution (the JAX package's rule)."""
    if base_cfg.train_data_dir and os.path.isdir(base_cfg.train_data_dir):
        return ImageFolderDataset(
            base_cfg.train_data_dir, resolution=base_cfg.resolution,
            center_crop=base_cfg.center_crop,
            random_flip=base_cfg.random_flip)
    return SyntheticDataset(resolution=base_cfg.resolution)


def epoch_batches(dataset, batch_size, seed=0, drop_last=True,
                  process_index=0, process_count=1) -> Iterator[dict]:
    """Shuffled epoch iterator yielding stacked numpy batches.

    ``batch_size`` is the GLOBAL batch; with ``process_count > 1`` every
    host draws the same seeded permutation and yields only its
    ``batch_size / process_count`` slice of each global batch (the
    DistributedSampler contract)."""
    if batch_size % process_count:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{process_count} processes")
    per_host = batch_size // process_count
    order = np.random.default_rng(seed).permutation(len(dataset))
    n_full = len(order) // batch_size
    for b in range(n_full):
        start = b * batch_size + process_index * per_host
        idxs = order[start:start + per_host]
        items = [dataset[int(i)] for i in idxs]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}
