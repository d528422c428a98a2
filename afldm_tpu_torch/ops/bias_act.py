"""Bias + activation + gain + clamp, NCHW. Counterpart of the JAX
package's ``ops/bias_act.py`` and of the StyleGAN-3 reference's
``torch_utils/ops/bias_act.py`` (its plain path): the activation table with
each activation's default alpha and gain, ``fma`` and ``filtered_lrelu``
as the reference's documented composition. Plain torch; no live AF-LDM
path calls it (the models use the FFT filtered activation).
"""

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from .upfirdn2d import _parse_padding, upfirdn2d


@dataclass(frozen=True)
class _Act:
    func: Callable
    def_alpha: float = 0.0
    def_gain: float = 1.0


_SQRT2 = math.sqrt(2.0)

activation_funcs = {
    "linear": _Act(lambda x, alpha: x),
    "relu": _Act(lambda x, alpha: F.relu(x), def_gain=_SQRT2),
    "lrelu": _Act(lambda x, alpha: F.leaky_relu(x, alpha),
                  def_alpha=0.2, def_gain=_SQRT2),
    "tanh": _Act(lambda x, alpha: torch.tanh(x)),
    "sigmoid": _Act(lambda x, alpha: torch.sigmoid(x)),
    "elu": _Act(lambda x, alpha: F.elu(x)),
    "selu": _Act(lambda x, alpha: F.selu(x)),
    "softplus": _Act(lambda x, alpha: F.softplus(x)),
    "swish": _Act(lambda x, alpha: F.silu(x), def_gain=_SQRT2),
}


def bias_act(x, b=None, dim=1, act="linear", alpha=None, gain=None,
             clamp=None):
    """y = clamp(act(x + b) * gain). ``b`` is 1-D along axis ``dim`` (1,
    the channels of NCHW); ``alpha`` and ``gain`` default to the
    activation's own; ``clamp`` None means no clamp."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1.0)
    if not (clamp >= 0 or clamp == -1.0):
        raise ValueError(f"clamp must be None or >= 0, got {clamp}")
    if b is not None:
        if b.ndim != 1:
            raise ValueError("b must be 1-D")
        shape = [1] * x.ndim
        shape[dim] = b.shape[0]
        x = x + b.reshape(shape)
    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def fma(a, b, c):
    """a * b + c (the reference's ``fma`` op)."""
    return a * b + c


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=_SQRT2, slope=0.2, clamp=None, flip_filter=False):
    """The StyleGAN-3 filtered leaky ReLU as its reference composition
    (``filtered_lrelu.py:_filtered_lrelu_ref``): bias, zero-stuff upsample
    and FIR (gain up²), leaky ReLU (gain, clamp), FIR and decimate. NCHW."""
    px0, px1, py0, py1 = _parse_padding(padding)
    if b is not None:
        x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=(px0, px1, py0, py1),
                  gain=up ** 2, flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
