"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without one. This file imports neither JAX nor
the JAX package, so it also runs on a machine with PyTorch alone:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: filtered activation atol 3e-5 / rtol 1e-4, attention 2e-5 /
1e-4 (f32 sums in another order than cuBLAS: ~1e-6 relative).
"""

import pytest
import torch

from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import attention as TA
from afldm_tpu_torch.ops import filtered_act as TF

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32, 32), (2, 64, 4, 4),
                                   (1, 8, 64, 64), (1, 4, 12, 20),
                                   (3, 5, 8, 8)])
@pytest.mark.parametrize("act", ["silu", "gelu", "mish"])
def test_plane_kernel_matches_plain(cuda, shape, act):
    x = torch.randn(shape, device=cuda)
    got = _launches("filtered_act_plane",
                    lambda: TF.filtered_act_plane(x, act))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, act),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 128, 128), (1, 2, 96, 128),
                                   (1, 1, 256, 256), (1, 1, 200, 104)])
def test_banded_kernel_matches_plain(cuda, shape):
    x = torch.randn(shape, device=cuda)
    got = _launches("filtered_act_banded",
                    lambda: TF.filtered_act_banded(x, "silu"))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, "silu"),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
def test_dispatcher_picks_kernels(cuda):
    x = torch.randn(1, 2, 8, 8, device=cuda)
    before = dict(kernels.LAUNCHES)
    TF.filtered_act_fused(x, "silu")
    TF.filtered_act_fused(torch.randn(1, 1, 128, 128, device=cuda), "silu")
    TF.filtered_act_fused(torch.randn(1, 2, 2, 2, device=cuda), "silu")
    assert kernels.LAUNCHES["filtered_act_plane"] == \
        before["filtered_act_plane"] + 1
    assert kernels.LAUNCHES["filtered_act_banded"] == \
        before["filtered_act_banded"] + 1
    with pytest.raises(ValueError):
        TF.filtered_act_fused(torch.randn(1, 1, 80, 80, device=cuda), "silu")
    with pytest.raises(TypeError):
        TF.filtered_act_plane(x.double(), "silu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (B, H, Lq, Lk, D)
    (2, 3, 64, 64, 24), (1, 2, 37, 50, 24), (2, 1, 4, 4, 24),
    (1, 4, 16, 16, 40), (1, 1, 130, 70, 8), (1, 2, 65, 129, 100),
    (1, 1, 64, 64, 256)])
def test_flash_kernel_matches_plain(cuda, shape):
    B, H, Lq, Lk, D = shape
    q = torch.randn(B, H, Lq, D, device=cuda)
    k = torch.randn(B, H, Lk, D, device=cuda)
    v = torch.randn(B, H, Lk, D, device=cuda)
    out, lse = _launches("flash_fwd", lambda: TA.flash_fwd(q, k, v))
    ref, ref_lse = TA._attention_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_expanded_and_strided_kv(cuda):
    """K/V expanded from one image (stride 0) and q as a transposed view:
    read through strides, no copies."""
    q = torch.randn(4, 64, 2, 24, device=cuda).transpose(1, 2)
    k = torch.randn(1, 2, 64, 24, device=cuda).expand(4, -1, -1, -1)
    v = torch.randn(1, 2, 64, 24, device=cuda).expand(4, -1, -1, -1)
    out = _launches("flash_fwd", lambda: TA.sdpa(q, k, v))
    ref = TA.sdpa_eager(q, k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
