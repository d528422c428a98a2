from .flow import (bilinear_sample, collect_noise_pixel, coords_grid,
                   flow_warp, forward_backward_consistency_check,
                   get_intermediate_warp_mask, upsample_noise)
from .metrics import mask_mse, mask_psnr, psnr
from .shifters import ImageShifter, gen_valid_mask

__all__ = ["bilinear_sample", "collect_noise_pixel", "coords_grid",
           "flow_warp", "forward_backward_consistency_check",
           "get_intermediate_warp_mask", "upsample_noise", "mask_mse",
           "mask_psnr", "psnr", "ImageShifter", "gen_valid_mask"]
