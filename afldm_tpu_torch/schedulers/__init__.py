from .ddim import DDIMScheduler
from .ddpm import DDPMScheduler
from .i2sb import I2SBScheduler

__all__ = ["DDIMScheduler", "DDPMScheduler", "I2SBScheduler"]
