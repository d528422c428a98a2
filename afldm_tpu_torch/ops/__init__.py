from .ideal_lpf import (
    af_precision, downsample_rfft, filtered_nonlinearity, lpf_recon_rfft,
    lpf_rfft, set_af_bf16_split, set_af_precision, subpixel_shift,
    upsample_rfft,
)
from .filtered_act import (filtered_act_banded, filtered_act_fused,
                           filtered_act_plain, filtered_act_plane)
from .attention import (flash2_fwd, flash_fwd, sdpa, sdpa2, sdpa2_eager,
                        sdpa_eager)
from .bias_act import activation_funcs, bias_act, filtered_lrelu, fma
from .upfirdn2d import (conv2d_resample, downsample2d, filter2d, setup_filter,
                        upfirdn2d, upsample2d)

__all__ = [
    "af_precision", "downsample_rfft", "filtered_nonlinearity",
    "lpf_recon_rfft", "lpf_rfft", "set_af_bf16_split",
    "set_af_precision", "subpixel_shift",
    "upsample_rfft", "filtered_act_banded", "filtered_act_fused",
    "filtered_act_plain", "filtered_act_plane", "flash2_fwd", "flash_fwd",
    "sdpa", "sdpa2", "sdpa2_eager", "sdpa_eager", "activation_funcs",
    "bias_act", "filtered_lrelu", "fma", "conv2d_resample", "downsample2d",
    "filter2d", "setup_filter", "upfirdn2d", "upsample2d",
]
