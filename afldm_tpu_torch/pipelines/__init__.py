from .ldm import LDMPipeline
from .loading import init_random_pipeline, resolve_device
from .shift_eval import ShiftEvalResult, shift_equivariance_eval

__all__ = ["LDMPipeline", "init_random_pipeline", "resolve_device",
           "ShiftEvalResult", "shift_equivariance_eval"]
