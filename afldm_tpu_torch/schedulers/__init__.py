from .ddim import DDIMScheduler
from .ddpm import DDPMScheduler

__all__ = ["DDIMScheduler", "DDPMScheduler"]
