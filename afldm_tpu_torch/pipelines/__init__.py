from .i2sb import I2SBLDMPipeline
from .interpolation import (ImageInterpolationPipeline, interp_draws,
                            slerp)
from .ldm import LDMPipeline
from .loading import (init_random_interp_pipeline, init_random_pipeline,
                      load_pipeline, resolve_device)
from .shift_eval import ShiftEvalResult, shift_equivariance_eval

__all__ = ["I2SBLDMPipeline", "ImageInterpolationPipeline", "interp_draws",
           "slerp", "LDMPipeline", "init_random_interp_pipeline",
           "init_random_pipeline", "load_pipeline", "resolve_device",
           "ShiftEvalResult", "shift_equivariance_eval"]
