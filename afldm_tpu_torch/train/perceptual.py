"""Perceptual loss of VAE training, NCHW. Counterpart of
``afldm_tpu/train/perceptual.py``.

The default is a fixed random-feature multi-scale conv metric (the same
seed-0 numpy filter bank as the JAX package); ``load_lpips_vgg_features``
swaps in VGG16 filters from a local torchvision or lpips checkpoint. Plain
``conv2d``, ReLU, channel normalisation and 2x2 pooling: no kernel of the
port's own.
"""

import re

import numpy as np
import torch
import torch.nn.functional as F


def _make_random_filters(seed=0, stages=((8, 3), (16, 8), (32, 16))):
    """One 3x3 conv a stage, HWIO numpy arrays scaled by 1/sqrt(9 in_c)."""
    rng = np.random.default_rng(seed)
    filters = []
    for out_c, in_c in stages:
        w = rng.standard_normal((3, 3, in_c, out_c)).astype(np.float32)
        w /= np.sqrt(9 * in_c)
        filters.append([w])
    return filters


_DEFAULT_FILTERS = None
_DEV_FILTERS = {}


def _filters():
    global _DEFAULT_FILTERS
    if _DEFAULT_FILTERS is None:
        _DEFAULT_FILTERS = _make_random_filters()
    return _DEFAULT_FILTERS


# torchvision vgg16.features conv indices per LPIPS slice
# (relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3)
_VGG16_STAGES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))

# lpips ScalingLayer constants (inputs in [-1, 1])
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_lpips_vgg_features(path, set_default=True):
    """VGG16 conv filters from a local torch checkpoint, as the stage list
    of ``perceptual_loss`` (HWIO weights and biases, numpy).

    Takes a torchvision ``vgg16`` state dict (``features.N.weight``) or an
    lpips checkpoint's backbone (``net.sliceK.N.weight``, the same
    indices). With ``set_default`` the loaded stages replace the
    random-feature proxy for every later call."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    idx_to_stage = {i: s for s, idxs in enumerate(_VGG16_STAGES)
                    for i in idxs}
    found = {}
    for key, val in sd.items():
        val = np.asarray(val)
        m = re.search(r"(\d+)\.(weight|bias)$", key)
        if not m or int(m.group(1)) not in idx_to_stage:
            continue
        if m.group(2) == "weight" and val.ndim != 4:
            continue
        found.setdefault(int(m.group(1)), {})[m.group(2)] = val
    missing = [i for i in idx_to_stage if "weight" not in found.get(i, {})]
    if missing:
        raise ValueError(f"{path} is not a VGG16 checkpoint: conv indices "
                         f"{missing} have no 4D weight")
    stages = []
    for idxs in _VGG16_STAGES:
        convs = []
        for i in idxs:
            b = found[i].get("bias")
            convs.append((found[i]["weight"].transpose(2, 3, 1, 0)
                          .astype(np.float32),
                          None if b is None else b.astype(np.float32)))
        stages.append(convs)
    if set_default:
        global _DEFAULT_FILTERS
        _DEFAULT_FILTERS = stages
    return stages


def _is_vgg(stages):
    return isinstance(stages[0][0], tuple)


def _on(stages, device):
    """The stages as (OIHW weight, bias or None) tensors on ``device``,
    cached per (bank, device)."""
    key = (id(stages), torch.device(device))
    if key not in _DEV_FILTERS:
        out = []
        for convs in stages:
            row = []
            for conv in convs:
                w, b = conv if isinstance(conv, tuple) else (conv, None)
                w = torch.from_numpy(np.ascontiguousarray(
                    w.transpose(3, 2, 0, 1))).to(device)
                row.append((w, None if b is None
                            else torch.from_numpy(b).to(device)))
            out.append(row)
        _DEV_FILTERS[key] = (stages, out)  # keeps the id's owner alive
    return _DEV_FILTERS[key][1]


def _features(x, stages, max_pool=False):
    """Per stage: 3x3 convs ("SAME") + ReLU, the channel-normalised map
    (LPIPS-style unit-norm features), then 2x2 max (VGG) or mean pooling."""
    feats = []
    h = x
    for convs in _on(stages, x.device):
        for w, b in convs:
            h = F.relu(F.conv2d(h, w, b, padding=1))
        feats.append(h / (torch.linalg.vector_norm(h, dim=1, keepdim=True)
                          + 1e-8))
        h = F.max_pool2d(h, 2) if max_pool else F.avg_pool2d(h, 2)
    return feats


def _lpips_scale(x):
    shift, scale = (torch.from_numpy(a).to(x.device).reshape(1, 3, 1, 1)
                    for a in (_LPIPS_SHIFT, _LPIPS_SCALE))
    return (x - shift) / scale


def pooled_feature_vector(x, filters=None, grid=4):
    """Fixed descriptor for Frechet-distance metrics: the unit-normed stage
    features of ``x`` (NCHW in [-1, 1]), each mean-pooled to a (grid, grid)
    cell map and concatenated in the JAX package's (cell row, cell column,
    channel) order -> (N, sum(grid^2 * C_stage))."""
    filters = filters or _filters()
    is_vgg = _is_vgg(filters)
    if is_vgg:
        x = _lpips_scale(x)
    cells = []
    for h in _features(x, filters, max_pool=is_vgg):
        n, c, hh, ww = h.shape
        g = min(grid, hh, ww)
        v = h.reshape(n, c, g, hh // g, g, ww // g).mean(dim=(3, 5))
        cells.append(v.permute(0, 2, 3, 1).reshape(n, g * g * c))
    return torch.cat(cells, dim=-1)


def perceptual_loss(a, b, filters=None):
    """Sum over stages of the mean squared feature distance (a scalar)."""
    filters = filters or _filters()
    is_vgg = _is_vgg(filters)
    if is_vgg:
        a, b = _lpips_scale(a), _lpips_scale(b)
    fa = _features(a, filters, max_pool=is_vgg)
    fb = _features(b, filters, max_pool=is_vgg)
    loss = 0.0
    for x, y in zip(fa, fb):
        loss = loss + torch.mean((x - y) ** 2)
    return loss
