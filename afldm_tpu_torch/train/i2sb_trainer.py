"""The I2SB super-resolution trainer's degradation. Counterpart of
``afldm_tpu/train/i2sb_trainer.py::degrade_sr4x``; the trainer class itself
(``I2SBTrainer``) is not ported yet (ROADMAP Queue 1 item 12)."""

from ..ops.superresolution import build_sr4x

_SR4X_CACHE = {}


def degrade_sr4x(images, sr_filter="bicubic"):
    """Fixed 4x degradation + nearest re-upsample of NCHW images, the
    operator cached per (image size, filter)."""
    key = (images.shape[-2], sr_filter)
    if key not in _SR4X_CACHE:
        _SR4X_CACHE[key] = build_sr4x(sr_filter, images.shape[-2],
                                      images.shape[1])
    return _SR4X_CACHE[key](images)
