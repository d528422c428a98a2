"""EMA of a list of parameters with the diffusers-EMAModel decay warmup.
Counterpart of ``afldm_tpu/train/ema.py`` at its defaults (decay 0.9999,
warmup power 2/3); the average is updated in place with
``torch._foreach_*`` (one pass over all tensors), where the JAX package
builds a new tree."""

import numpy as np
import torch

DECAY = 0.9999
POWER = 2.0 / 3.0


def ema_decay(step: int) -> float:
    """diffusers ``EMAModel.get_decay``: 1 - (1 + step)^-power, clipped to
    [0, DECAY]; computed in float32, as the JAX package does."""
    f32 = np.float32
    d = f32(1.0) - (f32(1.0) + f32(step)) ** f32(-POWER)
    return float(np.clip(d, f32(0.0), f32(DECAY)))


class EMA:
    """``params``: copies of the tracked tensors; ``step``: the number of
    updates so far."""

    def __init__(self, params):
        self.params = [p.detach().clone() for p in params]
        self.step = 0

    @torch.no_grad()
    def update(self, new_params):
        """ema = ema * d + p * (1 - d), d from the warmup at step + 1."""
        self.step += 1
        d = ema_decay(self.step)
        torch._foreach_mul_(self.params, d)
        torch._foreach_add_(self.params, [p.detach() for p in new_params],
                            alpha=float(np.float32(1.0) - np.float32(d)))

    def state_dict(self) -> dict:
        return {"params": self.params, "step": self.step}

    def load_state_dict(self, state: dict):
        with torch.no_grad():
            torch._foreach_copy_(self.params, list(state["params"]))
        self.step = int(state["step"])
