"""afldm_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of ``afldm_tpu``.

Layout mirrors the JAX package (ops, models, schedulers, shift, pipelines);
hand-written Hopper kernels live in ``kernels/`` with their CUDA sources in
``kernels/csrc/``. Tensors are NCHW. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
