from .i2sb import I2SBLDMPipeline
from .interpolation import (ImageInterpolationPipeline, interp_draws,
                            slerp)
from .ldm import LDMPipeline
from .loading import (init_random_interp_pipeline,
                      init_random_normal_pipeline, init_random_pipeline,
                      init_random_video_editing_pipeline, load_pipeline,
                      load_sd_components, resolve_device)
from .normal_control import NormalEstimationResult, NormControlPipeline
from .shift_eval import ShiftEvalResult, shift_equivariance_eval
from .video_editing import VideoEquivEditingPipeline

__all__ = ["I2SBLDMPipeline", "ImageInterpolationPipeline", "interp_draws",
           "slerp", "LDMPipeline", "init_random_interp_pipeline",
           "init_random_normal_pipeline", "init_random_pipeline",
           "init_random_video_editing_pipeline", "load_pipeline",
           "load_sd_components", "resolve_device", "NormalEstimationResult",
           "NormControlPipeline",
           "ShiftEvalResult", "shift_equivariance_eval",
           "VideoEquivEditingPipeline"]
