from .flow import bilinear_sample, coords_grid, flow_warp
from .metrics import mask_mse, mask_psnr, psnr
from .shifters import ImageShifter, gen_valid_mask

__all__ = ["bilinear_sample", "coords_grid", "flow_warp", "mask_mse",
           "mask_psnr", "psnr", "ImageShifter", "gen_valid_mask"]
