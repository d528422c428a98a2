"""Frame-chunked decoding for the pipelines that decode many frames.
Counterpart of the single-device part of ``afldm_tpu/pipelines/_frames.py``
(``_decode_chunked``); frame sharding over several cards is not ported.
"""

import torch

# frames an encode or decode: the AF-VAE's 2x maps at 512 px
DECODE_CHUNK = 4


def decode_chunked(decode, latents, chunk=None):
    """``decode`` over ``latents`` ``chunk`` frames at a time: the alias-free
    VAE's 2x-oversampled intermediates for many frames can exhaust device
    memory at 512 px. Without ``chunk``, or with no more frames than it,
    one call."""
    if not chunk or latents.shape[0] <= chunk:
        return decode(latents)
    return torch.cat([decode(latents[i:i + chunk])
                      for i in range(0, latents.shape[0], chunk)])
