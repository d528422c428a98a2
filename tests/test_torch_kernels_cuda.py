"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without one. This file imports neither JAX nor
the JAX package, so it also runs on a machine with PyTorch alone:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: filtered activation atol 3e-5 / rtol 1e-4, attention 2e-5 /
1e-4 (f32 sums in another order than cuBLAS: ~1e-6 relative); the
filtered activation's backward atol 1e-4 / rtol 1e-4 (six chained products
of values up to ~10); the flash backward 1e-4 / 1e-4 (a dk, dv row sums
over up to 1024 queries); one tiny training step, card against CPU: the
loss to 1e-4 relative and each gradient to 1e-3 of its tensor's largest,
that scale floored at 1e-4 of the largest gradient of all (the to_k biases'
exact gradient is 0, so both devices compute rounding noise there).
Every random input is drawn from a generator on the card seeded by the
case's parameters (``_seeded``), so that a run, or a ``-k`` subset of it,
draws the same values each time.
"""

import hashlib
import zlib

import numpy as np
import pytest
import torch

from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import attention as TA
from afldm_tpu_torch.ops import filtered_act as TF
from afldm_tpu_torch.ops import flash_probes as P

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
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 32), (2, 64, 4, 4), (1, 8, 64, 64), (1, 4, 12, 20),
    (3, 5, 8, 8),
    # a grid short of a wave (192 planes, one a block), plane counts that
    # P does not divide, sides of 4 mod 8, and 4 px against 64 px
    (1, 192, 32, 32), (1, 3, 64, 64), (2, 5, 12, 20), (1, 7, 4, 64),
    (1, 1, 64, 4)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh", "linear"])
def test_plane_kernel_matches_plain(cuda, shape, act):
    gen = _seeded(cuda, (shape, act))
    x = torch.randn(shape, device=cuda, generator=gen)
    got = _launches("filtered_act_plane",
                    lambda: TF.filtered_act_plane(x, act))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, act),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
def test_plane_kernel_channel_slice(cuda):
    """A non-contiguous input (a slice of the channels) runs the kernel on
    its contiguous copy."""
    gen = _seeded(cuda, "plane_kernel_channel_slice")
    x = torch.randn(2, 24, 16, 16, device=cuda, generator=gen)[:, 5:17]
    assert not x.is_contiguous()
    got = _launches("filtered_act_plane",
                    lambda: TF.filtered_act_plane(x, "silu"))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, "silu"),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
def test_plane_kernel_unaligned_base(cuda):
    """A contiguous view 4 bytes past an allocation's start: the wrapper
    copies it so that the kernel's 16-byte copies stay aligned."""
    gen = _seeded(cuda, "plane_kernel_unaligned_base")
    x = torch.randn(1 + 3 * 32 * 32, device=cuda,
                    generator=gen)[1:].view(1, 3, 32, 32)
    assert x.is_contiguous() and x.data_ptr() % 16
    got = _launches("filtered_act_plane",
                    lambda: TF.filtered_act_plane(x, "silu"))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, "silu"),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 128, 128), (1, 2, 96, 128),
                                   (1, 1, 256, 256), (1, 1, 200, 104)])
def test_banded_kernel_matches_plain(cuda, shape):
    gen = _seeded(cuda, shape)
    x = torch.randn(shape, device=cuda, generator=gen)
    got = _launches("filtered_act_banded",
                    lambda: TF.filtered_act_banded(x, "silu"))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, "silu"),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("side,planes,cap_planes", [(128, 5, 2),
                                                    (1024, 12, None)])
def test_banded_kernel_crosses_chunks(cuda, monkeypatch, side, planes,
                                      cap_planes):
    """K1 over several chunks of planes: five planes of 128 px in chunks of
    two, and 12 planes of 1024 px at the module's cap (10 planes' scratch
    a chunk)."""
    gen = _seeded(cuda, (side, planes, cap_planes))
    if cap_planes is not None:
        monkeypatch.setattr(TF, "BANDED_SCRATCH_BYTES",
                            TF.banded_scratch_bytes(side, side, cap_planes))
    assert len(TF.banded_plan(side, side, planes,
                              TF.BANDED_SCRATCH_BYTES)) > 1
    x = torch.randn(1, planes, side, side, device=cuda, generator=gen)
    got = _launches("filtered_act_banded",
                    lambda: TF.filtered_act_banded(x, "gelu"))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, "gelu"),
                               atol=3e-5, rtol=1e-4)


GEMM_SHAPES = [  # (batch, M, N, K): multiples of 4, ragged against the tiles
    (1, 132, 196, 20), (3, 68, 60, 92), (2, 256, 256, 128), (1, 4, 4, 4),
    (2, 300, 132, 516)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("a_kmajor", [False, True])
@pytest.mark.parametrize("shared_a", [False, True])
@pytest.mark.parametrize("small", [False, True])
def test_gemm_kernel_matches_matmul(cuda, shape, a_kmajor, shared_a, small):
    """K1's tiled GEMM alone against torch.matmul, A row-major or k-major,
    per batch or expanded from one matrix (batch stride 0), in either block
    tile, at edges that are not multiples of the tile."""
    gen = _seeded(cuda, (shape, a_kmajor, shared_a, small))
    batch, M, N, K = shape
    a_shape = (K, M) if a_kmajor else (M, K)
    a = (torch.randn(1, *a_shape, device=cuda,
                     generator=gen).expand(batch, -1, -1)
         if shared_a else torch.randn(batch, *a_shape, device=cuda,
                                      generator=gen))
    b = torch.randn(batch, K, N, device=cuda, generator=gen)
    got = _launches("filtered_gemm", lambda: TF.filtered_gemm(
        a, b, a_kmajor=a_kmajor, small=small))
    torch.testing.assert_close(got, TF.filtered_gemm_plain(a, b, None,
                                                           a_kmajor),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh", "linear"])
def test_gemm_kernel_activation_epilogue(cuda, act):
    """Every activation in the GEMM's epilogue, against act(torch.matmul)."""
    gen = _seeded(cuda, act)
    a = torch.randn(2, 68, 36, device=cuda, generator=gen)
    b = torch.randn(2, 36, 140, device=cuda, generator=gen)
    got = _launches("filtered_gemm", lambda: TF.filtered_gemm(a, b, act))
    torch.testing.assert_close(got, TF.filtered_gemm_plain(a, b, act),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh", "linear"])
@pytest.mark.parametrize("a_kmajor", [False, True])
@pytest.mark.parametrize("small", [False, True])
def test_gemm_kernel_reads_c_in_its_epilogue(cuda, act, a_kmajor, small):
    """The epilogue that reads C (K2's fourth product): act′(C's old
    value) ⊙ (A · B) for every activation, A row-major or k-major, in
    either block tile, edges ragged against it; relu and leaky_relu
    meet old values of exactly 0 (their slope there is 1); grad_at itself
    is left as it is."""
    gen = _seeded(cuda, (act, a_kmajor, small))
    batch, M, N, K = 2, 132, 196, 36
    a = torch.randn((batch, K, M) if a_kmajor else (batch, M, K),
                    device=cuda, generator=gen)
    b = torch.randn(batch, K, N, device=cuda, generator=gen)
    c = torch.randn(batch, M, N, device=cuda, generator=gen)
    c[:, ::7] = 0.0
    c0 = c.clone()
    got = _launches("filtered_gemm", lambda: TF.filtered_gemm(
        a, b, act, a_kmajor, small, grad_at=c))
    torch.testing.assert_close(
        got, TF.filtered_gemm_plain(a, b, act, a_kmajor, grad_at=c0),
        atol=3e-5, rtol=1e-4)
    assert torch.equal(c, c0)


def _misaligned(t):
    """t's values one float past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["batch", "K", "a_offset", "b_offset",
                                  "a_stride", "b_stride", "dtype"])
def test_gemm_refuses_operands_it_cannot_read(cuda, case):
    """filtered_gemm raises ValueError, and launches nothing, for operands
    whose batch or K disagree, that lie off a 16-byte boundary, whose row
    stride is not a multiple of 4, or that are not float32: the kernel
    would read past them or fault on its 16-byte copies."""
    gen = _seeded(cuda, case)
    a = torch.randn(3, 68, 36, device=cuda, generator=gen)
    b = torch.randn(3, 36, 140, device=cuda, generator=gen)
    if case == "batch":
        a = a[:1]
    elif case == "K":
        b = b[:, :32]
    elif case == "a_offset":
        a = _misaligned(a)
    elif case == "b_offset":
        b = _misaligned(b)
    elif case == "a_stride":
        a = torch.randn(3, 68, 38, device=cuda, generator=gen)[..., :36]
    elif case == "b_stride":
        b = torch.randn(3, 36, 142, device=cuda, generator=gen)[..., :140]
    else:
        b = b.double()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="filtered_gemm"):
        TF.filtered_gemm(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_wrappers_at_zero_planes_and_rows(cuda):
    """Every kernel wrapper given 0 planes (batch or channels 0) or 0 query
    rows returns its empty output, shaped as on the CPU, and launches
    nothing."""
    gen = _seeded(cuda, "wrappers_at_zero_planes_and_rows")
    before = dict(kernels.LAUNCHES)
    for shape in [(0, 4, 32, 32), (2, 0, 32, 32), (0, 4, 128, 128),
                  (2, 0, 96, 128)]:
        x = torch.randn(shape, device=cuda, generator=gen)
        banded = shape[-1] > TF.PLANE_MAX
        fwd = TF.filtered_act_banded if banded else TF.filtered_act_plane
        bwd = (TF.filtered_act_banded_bwd if banded
               else TF.filtered_act_plane_bwd)
        assert fwd(x, "silu").shape == shape
        assert bwd(x, x, "silu").shape == shape
        assert TF.filtered_act_fused(x, "silu").shape == shape
    a = torch.randn(0, 8, 12, device=cuda, generator=gen)
    b = torch.randn(0, 12, 16, device=cuda, generator=gen)
    assert TF.filtered_gemm(a, b).shape == (0, 8, 16)
    for B, Lq, Lk in [(0, 64, 64), (2, 0, 64)]:
        q = torch.randn(B, 2, Lq, 24, device=cuda, generator=gen)
        k, v = (torch.randn(B, 2, Lk, 24, device=cuda,
                            generator=gen) for _ in range(2))
        out, lse = TA.flash_fwd(q, k, v)
        assert out.shape == q.shape and lse.shape == (B, 2, Lq, 1)
        assert TA.flash2_fwd(q, k, v, k, v, 0.5).shape == q.shape
        do = torch.randn(q.shape, device=q.device, generator=gen)
        delta = TA._delta(do, out)
        assert TA.flash_bwd_dq(q, k, v, do, lse, delta).shape == q.shape
        dk, dv = TA.flash_bwd_dkv(q, k, v, do, lse, delta)
        assert dk.shape == k.shape and dv.shape == v.shape
        assert not dk.any() and not dv.any()
        for fn in (P.flash_probe_dots, P.flash_probe_stream):
            assert fn(q, k, v).shape == q.shape
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_dispatcher_picks_kernels(cuda):
    gen = _seeded(cuda, "dispatcher_picks_kernels")
    x = torch.randn(1, 2, 8, 8, device=cuda, generator=gen)
    before = dict(kernels.LAUNCHES)
    TF.filtered_act_fused(x, "silu")
    TF.filtered_act_fused(torch.randn(1, 1, 128, 128, device=cuda,
                                      generator=gen), "silu")
    TF.filtered_act_fused(torch.randn(1, 2, 2, 2, device=cuda,
                                      generator=gen), "silu")
    assert kernels.LAUNCHES["filtered_act_plane"] == \
        before["filtered_act_plane"] + 1
    assert kernels.LAUNCHES["filtered_act_banded"] == \
        before["filtered_act_banded"] + 1
    TF.filtered_act_fused(torch.randn(1, 1, 80, 80, device=cuda,
                                      generator=gen), "silu")
    assert kernels.LAUNCHES["filtered_act_banded"] == \
        before["filtered_act_banded"] + 2
    # a plane 4848 px wide: the forward's GEMM chain takes it
    wide = torch.randn(1, 1, 4, 4848, device=cuda, generator=gen)
    torch.testing.assert_close(TF.filtered_act_fused(wide, "silu"),
                               TF.filtered_act_plain(wide, "silu"),
                               atol=3e-5, rtol=1e-4)
    assert kernels.LAUNCHES["filtered_act_banded"] == \
        before["filtered_act_banded"] + 3
    with pytest.raises(TypeError):
        TF.filtered_act_plane(x.double(), "silu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 4, 4848), (1, 2, 1024, 1024)])
def test_wide_planes_take_a_gradient(cuda, shape):
    """Planes as wide as 4848 px and as large as 1024 px run forward (K1)
    and backward (K2) through the dispatcher where they need a gradient,
    one launch of each wrapper, and the gradient is the plain version's."""
    gen = _seeded(cuda, shape)
    x = torch.randn(shape, device=cuda, requires_grad=True, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    y = _launches("filtered_act_banded",
                  lambda: TF.filtered_act_fused(x, "silu"))
    _launches("filtered_act_banded_bwd", lambda: y.backward(g))
    torch.testing.assert_close(
        x.grad, TF.filtered_act_plane_bwd_plain(x.detach(), g, "silu"),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (B, H, Lq, Lk, D)
    (2, 3, 64, 64, 24), (1, 2, 37, 50, 24), (2, 1, 4, 4, 24),
    (1, 4, 16, 16, 40), (1, 1, 130, 70, 8), (1, 2, 65, 129, 100),
    (1, 1, 64, 64, 256)])
def test_flash_kernel_matches_plain(cuda, shape):
    gen = _seeded(cuda, shape)
    B, H, Lq, Lk, D = shape
    q = torch.randn(B, H, Lq, D, device=cuda, generator=gen)
    k = torch.randn(B, H, Lk, D, device=cuda, generator=gen)
    v = torch.randn(B, H, Lk, D, device=cuda, generator=gen)
    out, lse = _launches("flash_fwd", lambda: TA.flash_fwd(q, k, v))
    ref, ref_lse = TA._attention_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (B, H, Lq, Lk, D, K/V batch)
    (2, 8, 4096, 4096, 40, 1), (2, 8, 1024, 1024, 80, 1),
    (2, 8, 256, 256, 160, 2), (2, 8, 4096, 77, 40, 1),
    (2, 8, 256, 77, 160, 2)])
def test_flash_kernel_sd_head_dims(cuda, shape):
    """K3 at the SD UNet's head dims: self-attention at 64, 32 and 16 px
    and cross-attention over 77 text tokens."""
    gen = _seeded(cuda, shape)
    B, H, Lq, Lk, D, nkv = shape
    q = torch.randn(B, H, Lq, D, device=cuda, generator=gen)
    k, v = (torch.randn(nkv, H, Lk, D, device=cuda,
                        generator=gen).expand(B, -1, -1, -1)
            for _ in range(2))
    out, lse = _launches("flash_fwd", lambda: TA.flash_fwd(q, k, v))
    ref, ref_lse = TA._attention_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)


def _flash2_inputs(cuda, gen, B, H, Lq, Lk, D, kv_batch):
    q = torch.randn(B, H, Lq, D, device=cuda, generator=gen)
    kvs = [torch.randn(kv_batch, H, Lk, D, device=cuda,
                       generator=gen).expand(B, -1, -1, -1)
           for _ in range(4)]
    return q, kvs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 24, 40, 100, 160, 256])
@pytest.mark.parametrize("lens,kv_batch", [((64, 64), 1), ((37, 50), 3),
                                           ((130, 70), 1), ((4, 4), 3)])
def test_flash2_kernel_matches_plain(cuda, D, lens, kv_batch):
    """K6 with one alpha per frame, ragged Lq/Lk, K/V per frame or
    expanded from one image (stride 0)."""
    gen = _seeded(cuda, (D, lens, kv_batch))
    (Lq, Lk), B, H = lens, 3, 2
    q, kvs = _flash2_inputs(cuda, gen, B, H, Lq, Lk, D, kv_batch)
    alpha = torch.tensor([0.0, 0.3, 1.0], device=cuda)[:, None, None]
    got = _launches("flash2_fwd", lambda: TA.flash2_fwd(q, *kvs, alpha))
    want = TA.sdpa2_eager(q, *kvs, alpha)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.25, (0.1, 0.9)])
def test_flash2_scalar_alpha_and_3d(cuda, alpha):
    """A scalar alpha, a (N,) alpha broadcast over heads, and 3D inputs."""
    gen = _seeded(cuda, alpha)
    q, kvs = _flash2_inputs(cuda, gen, 2, 4, 64, 48, 24, 1)
    got = _launches("flash2_fwd", lambda: TA.flash2_fwd(q, *kvs, alpha))
    torch.testing.assert_close(got, TA.sdpa2_eager(q, *kvs, alpha),
                               atol=2e-5, rtol=1e-4)
    q3, kv3 = q[0], [t[0] for t in kvs]
    got3 = _launches("flash2_fwd", lambda: TA.flash2_fwd(q3, *kv3, 0.7))
    torch.testing.assert_close(got3, TA.sdpa2_eager(q3, *kv3, 0.7),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_sdpa2_function_backward_uses_flash_kernels(cuda):
    """The dispatcher's forward is K6, its backward the two-pass VJP
    through K3 recompute and the K4 pair; gradients (alpha's too) match
    autograd through the plain version."""
    gen = _seeded(cuda, "sdpa2_function_backward_uses_flash_kernels")
    q0 = torch.randn(3, 2, 64, 24, device=cuda, requires_grad=True,
                     generator=gen)
    kv0 = [torch.randn(1, 2, 64, 24, device=cuda, requires_grad=True,
                       generator=gen)
           for _ in range(4)]
    a0 = torch.tensor([0.2, 0.5, 0.8], device=cuda, requires_grad=True)
    g = torch.randn(3, 2, 64, 24, device=cuda, generator=gen)

    def run(fn):
        out = fn(q0, *(t.expand(3, -1, -1, -1) for t in kv0), a0)
        return torch.autograd.grad(out, (q0, *kv0, a0), g)

    before = dict(kernels.LAUNCHES)
    got = run(TA.sdpa2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash2_fwd"] == before["flash2_fwd"] + 1
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.LAUNCHES[name] == before[name] + 2, name
    want = run(TA.sdpa2_eager)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_expanded_and_strided_kv(cuda):
    """K/V expanded from one image (stride 0) and q as a transposed view:
    read through strides, no copies."""
    gen = _seeded(cuda, "flash_kernel_expanded_and_strided_kv")
    q = torch.randn(4, 64, 2, 24, device=cuda, generator=gen).transpose(1, 2)
    k = torch.randn(1, 2, 64, 24, device=cuda,
                    generator=gen).expand(4, -1, -1, -1)
    v = torch.randn(1, 2, 64, 24, device=cuda,
                    generator=gen).expand(4, -1, -1, -1)
    out = _launches("flash_fwd", lambda: TA.sdpa(q, k, v))
    ref = TA.sdpa_eager(q, k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32, 32), (2, 64, 4, 4),
                                   (1, 4, 64, 64), (1, 4, 12, 20),
                                   (3, 5, 8, 8), (2, 6, 16, 16),
                                   (4, 8, 64, 64)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh"])
def test_plane_bwd_kernel_matches_plain(cuda, shape, act):
    gen = _seeded(cuda, (shape, act))
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    got = _launches("filtered_act_plane_bwd",
                    lambda: TF.filtered_act_plane_bwd(x, g, act))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, act), atol=1e-4,
        rtol=1e-4)


def _plane_bwd_entry(x, g, dx, ppb, tiles, threads, act="silu"):
    """One launch of the plane backward's C entry; returns its error."""
    H, W = x.shape[-2:]
    return kernels.library("filtered_act").filtered_act_plane_bwd_f32(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(),
        *(o.data_ptr() for o in TF._plane_bwd_ops(H, W, x.device)),
        x.shape[0] * x.shape[1], H, W, ppb, tiles, threads,
        TF.ACT_CODES[act], torch.cuda.current_stream(x.device).cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8, 64, 64), (1, 7, 32, 32),
                                   (2, 5, 12, 20), (1, 9, 8, 8),
                                   (1, 13, 4, 4)])
@pytest.mark.parametrize("threads", [256, 512])
def test_plane_bwd_entry_takes_every_plan(cuda, shape, threads):
    """Every P that fits the block (up to the plane count, so the last
    block holds fewer where P does not divide it) and every micro-tile
    choice the rows allow, through the C entry at both thread counts: each
    gives the plain version's dx; a choice the rows refuse, and P = 0,
    return cudaErrorInvalidValue (1) without a launch."""
    gen = _seeded(cuda, (shape, threads))
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    want = TF.filtered_act_plane_bwd_plain(x, g, "gelu")
    H, W = shape[-2:]
    nplanes = shape[0] * shape[1]
    rows = [r for r, _, _ in TF.plane_bwd_products(H, W)]
    for ppb in range(1, nplanes + 1):
        if TF.plane_bwd_smem_bytes(H, W, ppb) > TF.SMEM_MAX_BYTES:
            break
        for tiles in range(64):
            dx = torch.full_like(x, float("nan"))
            err = _plane_bwd_entry(x, g, dx, ppb, tiles, threads, "gelu")
            wide_bad = any(not (tiles >> i) & 1 and r % 8
                           for i, r in enumerate(rows))
            assert err == (1 if wide_bad else 0), (ppb, tiles)
            if not wide_bad:
                torch.cuda.synchronize()
                torch.testing.assert_close(dx, want, atol=1e-4, rtol=1e-4,
                                           msg=f"P {ppb}, tiles {tiles}")
    dx = torch.empty_like(x)
    assert _plane_bwd_entry(x, g, dx, 0, 63, threads) == 1
    assert _plane_bwd_entry(x, g, dx, 1, 63, 384) == 1


@pytest.mark.cuda
def test_plane_bwd_kernel_misaligned_and_strided(cuda):
    """x and g off a 16-byte boundary, and g a non-contiguous view (as
    autograd may hand it), are copied to what the kernel's 16-byte copies
    read; dx is the plain version's."""
    gen = _seeded(cuda, "plane_bwd_kernel_misaligned_and_strided")
    shape = (2, 6, 32, 32)
    x = _misaligned(torch.randn(shape, device=cuda, generator=gen))
    g = torch.randn(2, 6, 32, 32, device=cuda, generator=gen).transpose(-1, -2)
    assert x.data_ptr() % 16 and not g.is_contiguous()
    got = _launches("filtered_act_plane_bwd",
                    lambda: TF.filtered_act_plane_bwd(x, g, "silu"))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, "silu"), atol=1e-4,
        rtol=1e-4)


@pytest.mark.cuda
def test_plane_function_backward_launches_kernel(cuda):
    """autograd through the dispatcher reaches the plane backward kernel at
    plane sizes and the banded one (K2) above 64 px."""
    gen = _seeded(cuda, "plane_function_backward_launches_kernel")
    x = torch.randn(2, 8, 16, 16, device=cuda, requires_grad=True,
                    generator=gen)
    g = torch.randn(2, 8, 16, 16, device=cuda, generator=gen)
    y = TF.filtered_act_fused(x, "silu")
    _launches("filtered_act_plane_bwd", lambda: y.backward(g))
    torch.testing.assert_close(
        x.grad, TF.filtered_act_plane_bwd_plain(x.detach(), g, "silu"),
        atol=1e-4, rtol=1e-4)
    xb = torch.randn(1, 2, 128, 128, device=cuda, requires_grad=True,
                     generator=gen)
    gb = torch.randn(1, 2, 128, 128, device=cuda, generator=gen)
    yb = TF.filtered_act_fused(xb, "silu")
    _launches("filtered_act_banded_bwd", lambda: yb.backward(gb))
    torch.testing.assert_close(
        xb.grad, TF.filtered_act_plane_bwd_plain(xb.detach(), gb, "silu"),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 128, 128), (1, 2, 96, 128),
                                   (1, 1, 256, 256), (1, 1, 200, 104),
                                   (1, 1, 512, 96)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh"])
def test_banded_bwd_kernel_matches_plain(cuda, shape, act):
    """K2's six GEMM launches at square and mixed planes, sides that are
    and are not multiples of the 64 and 128 px block tiles, in one chunk,
    for every activation's derivative in the epilogue that reads C."""
    gen = _seeded(cuda, (shape, act))
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    got = _launches("filtered_act_banded_bwd",
                    lambda: TF.filtered_act_banded_bwd(x, g, act))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, act), atol=1e-4,
        rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("side,planes,cap_planes", [(128, 5, 2),
                                                    (80, 7, 3),
                                                    (1024, 12, None)])
def test_banded_bwd_kernel_crosses_chunks(cuda, monkeypatch, side, planes,
                                          cap_planes):
    """K2 over several chunks of planes: five planes of 128 px in chunks of
    two, seven of 80 px in chunks of three, and 12 planes of 1024 px at
    the module's cap (10 planes' scratch a chunk); one scratch buffer,
    reused chunk after chunk."""
    gen = _seeded(cuda, (side, planes, cap_planes))
    if cap_planes is not None:
        monkeypatch.setattr(TF, "BANDED_SCRATCH_BYTES",
                            TF.banded_scratch_bytes(side, side, cap_planes))
    assert len(TF.banded_plan(side, side, planes, TF.BANDED_SCRATCH_BYTES,
                              TF.banded_bwd_products)) > 1
    x = torch.randn(1, planes, side, side, device=cuda, generator=gen)
    g = torch.randn(1, planes, side, side, device=cuda, generator=gen)
    got = _launches("filtered_act_banded_bwd",
                    lambda: TF.filtered_act_banded_bwd(x, g, "gelu"))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, "gelu"), atol=1e-4,
        rtol=1e-4)


@pytest.mark.cuda
def test_banded_bwd_kernel_misaligned_and_strided(cuda):
    """x and g off a 16-byte boundary, and g a non-contiguous view (as
    autograd may hand it), are copied to what the GEMM's 16-byte reads
    take; dx is the plain version's."""
    gen = _seeded(cuda, "banded_bwd_kernel_misaligned_and_strided")
    shape = (1, 3, 96, 128)
    x = _misaligned(torch.randn(shape, device=cuda, generator=gen))
    g = torch.randn(1, 3, 128, 96, device=cuda,
                    generator=gen).transpose(-1, -2)
    assert x.data_ptr() % 16 and not g.is_contiguous()
    got = _launches("filtered_act_banded_bwd",
                    lambda: TF.filtered_act_banded_bwd(x, g, "silu"))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, "silu"), atol=1e-4,
        rtol=1e-4)


def _attn_inputs(cuda, gen, B, H, Lq, Lk, D, kv_batch):
    q = torch.randn(B, H, Lq, D, device=cuda, generator=gen)
    k, v = (torch.randn(kv_batch, H, Lk, D, device=cuda, generator=gen)
            .expand(B, -1, -1, -1) for _ in range(2))
    out, lse = TA.flash_fwd(q, k, v)
    do = torch.randn(B, H, Lq, D, device=cuda, generator=gen)
    return q, k, v, out, lse, do


# the tile loop's head dims (DP 24 ... 256: D below, at and between them)
# and ragged lengths, shared by the forward and backward tests
TILE_DIMS = [8, 20, 24, 33, 40, 80, 100, 160, 256]
TILE_LENS = [(1, 1), (37, 77), (127, 129), (129, 4095), (4095, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (B, H, Lq, Lk, D, K/V batch)
    (2, 3, 64, 64, 24, 2), (1, 2, 37, 50, 24, 1), (2, 1, 4, 4, 24, 2),
    (2, 4, 16, 16, 24, 1), (1, 1, 130, 70, 8, 1), (1, 2, 65, 129, 100, 1),
    (1, 1, 64, 64, 256, 1), (2, 2, 1024, 1024, 24, 1),
    *[(2, 2, Lq, Lk, D, 2) for D in TILE_DIMS for Lq, Lk in TILE_LENS]])
def test_flash_bwd_kernels_match_plain(cuda, shape):
    """K4a and K4b at every BwdCfg (each DP, with D below, at and between
    them), ragged Lq and Lk, K/V per image and expanded from one."""
    gen = _seeded(cuda, shape)
    B, H, Lq, Lk, D, nkv = shape
    q, k, v, out, lse, do = _attn_inputs(cuda, gen, B, H, Lq, Lk, D, nkv)
    delta = TA._delta(do, out)
    dq = _launches("flash_bwd_dq",
                   lambda: TA.flash_bwd_dq(q, k, v, do, lse, delta))
    dk, dv = _launches("flash_bwd_dkv",
                       lambda: TA.flash_bwd_dkv(q, k, v, do, lse, delta))
    want = TA._attention_bwd_plain(q, k, v, out, lse, do)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (B, H, Lq, Lk, D, K/V batch)
    (1, 8, 4096, 77, 40, 1), (1, 8, 1024, 77, 80, 1),
    (1, 8, 256, 77, 160, 1)])
def test_flash_bwd_at_the_sd_cross_attention(cuda, shape):
    """K4a and K4b at the SD trainers' cross-attention over 77 text tokens
    (a second K/V tile of 13 valid rows): dk and dv of the padded rows are
    neither written nor summed, dq's sum over Lk masks the tail."""
    gen = _seeded(cuda, shape)
    B, H, Lq, Lk, D, nkv = shape
    q, k, v, out, lse, do = _attn_inputs(cuda, gen, B, H, Lq, Lk, D, nkv)
    delta = TA._delta(do, out)
    dq = _launches("flash_bwd_dq",
                   lambda: TA.flash_bwd_dq(q, k, v, do, lse, delta))
    dk, dv = _launches("flash_bwd_dkv",
                       lambda: TA.flash_bwd_dkv(q, k, v, do, lse, delta))
    assert dk.shape == dv.shape == (B, H, Lk, D)
    want = TA._attention_bwd_plain(q, k, v, out, lse, do)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 320, 64, 64), (1, 1280, 8, 8)])
def test_plane_bwd_at_the_sd_unet(cuda, shape):
    """K5b at the SD UNet's 64 px and 8 px levels at batch 1: its launch
    plan finds a plan there, and the kernel matches its plain version."""
    gen = _seeded(cuda, shape)
    _, c, h, w = shape
    plan = TF.plane_bwd_plan(h, w, c)
    assert plan.planes_per_block >= 1 and plan.smem_bytes <= \
        TF.SMEM_MAX_BYTES
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    got = _launches("filtered_act_plane_bwd",
                    lambda: TF.filtered_act_plane_bwd(x, g, "silu"))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, "silu"), atol=1e-4,
        rtol=1e-4)


@pytest.mark.cuda
def test_flash_function_expanded_kv_and_strided_do(cuda):
    """Through autograd: q a transposed view, K/V expanded from one image
    (stride 0) whose gradients sum over the batch, dO strided (it arrives
    through the head transpose)."""
    gen = _seeded(cuda, "flash_function_expanded_kv_and_strided_do")
    q0 = torch.randn(4, 64, 2, 24, device=cuda, requires_grad=True,
                     generator=gen)
    k0 = torch.randn(1, 2, 64, 24, device=cuda, requires_grad=True,
                     generator=gen)
    v0 = torch.randn(1, 2, 64, 24, device=cuda, requires_grad=True,
                     generator=gen)
    g = torch.randn(4, 64, 2, 24, device=cuda, generator=gen)

    def run(fn):
        out = fn(q0.transpose(1, 2), k0.expand(4, -1, -1, -1),
                 v0.expand(4, -1, -1, -1))
        return torch.autograd.grad(out.transpose(1, 2), (q0, k0, v0), g)

    before = dict(kernels.LAUNCHES)
    got = run(TA.sdpa)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.LAUNCHES[name] == before[name] + 1, name
    want = run(TA.sdpa_eager)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _tiny_step_grads(device, policy):
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    base = T.BaseTrainingConfig(resolution=64, train_batch_size=2, seed=0,
                                gradient_checkpointing=policy is not None,
                                remat_policy=policy or "full")
    cfg = T.LDMTrainingConfig(af_models=True, use_shift_loss=True,
                              use_cross_attn=True, use_ema=True)
    tr = T.create_trainer("ldm", base, cfg, device=device)
    tr.init_modules(vae_config=vcfg, unet_config=ucfg, scheduler_config=scfg)
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    images = next(T.epoch_batches(T.SyntheticDataset(resolution=64,
                                                     length=2), 2))["input"]
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    loss, _ = tr.loss_fn(x.to(device), tr.draw(0, 2))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu()
                                  for n, p in tr.unet.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_tiny_training_step_on_card_matches_cpu(cuda, policy):
    """Every kernel of the training path runs under each remat policy
    (selective checkpointing recomputes through the autograd Functions)."""
    kernels.reset_launch_counts()
    got_loss, got = _tiny_step_grads("cuda", policy)
    for name in ("filtered_act_plane", "filtered_act_plane_bwd",
                 "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.LAUNCHES[name] > 0, name
    want_loss, want = _tiny_step_grads("cpu", None)
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    largest = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        scale = max(float(g.abs().max()), 1e-4 * largest)
        assert float((got[n] - g).abs().max()) <= 1e-3 * scale, n


_TINY_VAE = dict(block_out_channels=[16, 16, 16], layers_per_block=1,
                 latent_channels=4, norm_num_groups=8, sample_size=128,
                 alias_free=True, down_filtered_act=[True, True, True],
                 up_filtered_act=[True, True, True], up_rescale=[True, True])


def _tiny_vae_step_grads(device, policy):
    from afldm_tpu_torch import train as T
    base = T.BaseTrainingConfig(resolution=128, train_batch_size=2, seed=0,
                                gradient_checkpointing=policy is not None,
                                remat_policy=policy or "full")
    cfg = T.VAETrainingConfig(use_shift_loss=True, use_disc=True)
    tr = T.create_trainer("vae", base, cfg, device=device)
    tr.init_modules(vae_config=_TINY_VAE,
                    disc_config={"depth": 3, "hidden_channels": 32})
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    images = next(T.epoch_batches(T.SyntheticDataset(resolution=128,
                                                     length=2), 2))["input"]
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(device)
    logs = tr.generator_backward(x, tr.draw(0, 2))
    return ({k: float(v) for k, v in logs.items()},
            {n: p.grad.detach().cpu() for n, p in tr.vae.named_parameters()})


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_tiny_vae_step_on_card_matches_cpu(cuda, policy):
    """One generator step of a tiny AF-VAE (128 px top level) with shift
    loss and the adaptive GAN term: the banded kernels and their backward
    run under each remat policy, and the losses and gradients match the
    CPU's (losses relative to max(|loss|, 1e-2): the GAN term is a mean of
    logits of either sign)."""
    kernels.reset_launch_counts()
    got_logs, got = _tiny_vae_step_grads("cuda", policy)
    for name in ("filtered_act_plane", "filtered_act_plane_bwd",
                 "filtered_act_banded", "filtered_act_banded_bwd"):
        assert kernels.LAUNCHES[name] > 0, name
    want_logs, want = _tiny_vae_step_grads("cpu", None)
    for k, w in want_logs.items():
        assert abs(got_logs[k] - w) <= 1e-4 * max(abs(w), 1e-2), k
    largest = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        scale = max(float(g.abs().max()), 1e-4 * largest)
        assert float((got[n] - g).abs().max()) <= 1e-3 * scale, n


# -- the flash attribution probes (P1, P2) ---------------------------------------

def _probe_inputs(device, gen, B, H, Lq, Lk, D, kv_batch):
    q = torch.randn(B, H, Lq, D, device=device, generator=gen)
    k, v = (torch.randn(kv_batch, H, Lk, D, device=device, generator=gen)
            .expand(B, -1, -1, -1) for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 24, 32, 40, 80, 128, 160, 256])
@pytest.mark.parametrize("lens,kv_batch", [((64, 64), 2), ((128, 256), 1),
                                           ((1024, 1024), 2)])
def test_flash_probe_kernels_match_plain(cuda, D, lens, kv_batch):
    """Each within a share of max |want|: P1 2e-5 (nothing normalises its
    values, which grow as sqrt(Lk·D)); P2 1e-5 (it sums each tile's 64 rows
    in another order than the plain version). K/V expanded from one image
    when kv_batch is 1 (stride 0)."""
    gen = _seeded(cuda, (D, lens, kv_batch))
    from afldm_tpu_torch.ops import flash_probes as P
    q, k, v = _probe_inputs(cuda, gen, 2, 3, *lens, D, kv_batch)
    for name, plain, rel in (("flash_probe_dots", P.flash_probe_dots_plain,
                              2e-5),
                             ("flash_probe_stream",
                              P.flash_probe_stream_plain, 1e-5)):
        got = _launches(name, lambda: getattr(P, name)(q, k, v))
        want = plain(q, k, v)
        err = float((got - want).abs().max())
        assert err <= rel * float(want.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(63, 64), (64, 100), (1, 64)])
def test_flash_probe_kernels_need_multiples_of_64(cuda, lens):
    gen = _seeded(cuda, lens)
    from afldm_tpu_torch.ops import flash_probes as P
    q, k, v = _probe_inputs(cuda, gen, 1, 1, *lens, 16, 1)
    for fn in (P.flash_probe_dots, P.flash_probe_stream):
        with pytest.raises(ValueError, match="multiples of 64"):
            fn(q, k, v)


# -- the widened banded window (K1, K2) ---------------------------------

WIDE_SHAPES = [(2, 3, 80, 80), (1, 2, 68, 92), (1, 2, 32, 128),
               (1, 1, 640, 640), (1, 1, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_banded_kernels_widened_window(cuda, shape):
    """K1 and K2 at the sizes between and beyond the old 96-512 px window:
    68-92 px, mixed 32x128, and planes above 512 px (one or two planes a
    chunk, their GEMM grids many waves deep)."""
    gen = _seeded(cuda, shape)
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    got = _launches("filtered_act_banded",
                    lambda: TF.filtered_act_fused(x, "silu"))
    torch.testing.assert_close(got, TF.filtered_act_plain(x, "silu"),
                               atol=3e-5, rtol=1e-4)
    dx = _launches("filtered_act_banded_bwd",
                   lambda: TF.filtered_act_banded_bwd(x, g, "silu"))
    torch.testing.assert_close(
        dx, TF.filtered_act_plane_bwd_plain(x, g, "silu"), atol=1e-4,
        rtol=1e-4)


# -- the register-tiled flash forward (K3, K6): head dims, lengths -------


@pytest.mark.cuda
@pytest.mark.parametrize("D", TILE_DIMS)
@pytest.mark.parametrize("lens", TILE_LENS)
def test_flash_tile_loop_dims_and_ragged_lengths(cuda, D, lens):
    """K3 (out and the lse that K4 reads) and K6 at every padded head dim
    (DP 24 ... 256, D below, at and between them) and ragged Lq/Lk."""
    gen = _seeded(cuda, (D, lens))
    Lq, Lk = lens
    q = torch.randn(2, 2, Lq, D, device=cuda, generator=gen)
    k, v, k1, v1 = (torch.randn(2, 2, Lk, D, device=cuda,
                                generator=gen) for _ in range(4))
    out, lse = _launches("flash_fwd", lambda: TA.flash_fwd(q, k, v))
    ref, ref_lse = TA._attention_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)
    alpha = torch.tensor([0.25, 0.75], device=cuda)[:, None, None]
    got = _launches("flash2_fwd",
                    lambda: TA.flash2_fwd(q, k, v, k1, v1, alpha))
    torch.testing.assert_close(got, TA.sdpa2_eager(q, k, v, k1, v1, alpha),
                               atol=2e-5, rtol=1e-4)


def _views(cuda, gen, B, H, L, D, kind):
    """(B, H, L, D) inputs laid out as ``kind``: contiguous; a transposed
    view (row stride H·D); a slice of a wider tensor (row stride D + 3,
    not a multiple of 4 floats: the scalar copy); expanded from one image
    (batch stride 0); a base 4 bytes past a 16-byte boundary (the scalar
    copy)."""
    if kind == "contiguous":
        return torch.randn(B, H, L, D, device=cuda, generator=gen)
    if kind == "transposed":
        return torch.randn(B, L, H, D, device=cuda,
                           generator=gen).transpose(1, 2)
    if kind == "sliced":
        return torch.randn(B, H, L, D + 3, device=cuda, generator=gen)[..., :D]
    if kind == "expanded":
        return torch.randn(1, H, L, D, device=cuda,
                           generator=gen).expand(B, -1, -1, -1)
    flat = torch.randn(B * H * L * D + 1, device=cuda, generator=gen)
    t = flat[1:].view(B, H, L, D)
    assert t.data_ptr() % 16 == 4
    return t


LAYOUTS = ["contiguous", "transposed", "sliced", "expanded", "misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [24, 40, 64])
@pytest.mark.parametrize("q_kind,kv_kind", [
    ("transposed", "expanded"), ("sliced", "contiguous"),
    ("contiguous", "sliced"), ("misaligned", "expanded"),
    ("contiguous", "misaligned"), ("transposed", "transposed")])
def test_flash_tile_loop_strides_and_alignment(cuda, D, q_kind, kv_kind):
    """Strided and stride-0 q, k, v are read through their strides without
    a copy, and an unaligned base or row stride takes the masked scalar
    copy in place of cp.async: both give the plain version's values."""
    gen = _seeded(cuda, (D, q_kind, kv_kind))
    B, H, L = 3, 2, 130
    q = _views(cuda, gen, B, H, L, D, q_kind)
    k, v, k1, v1 = (_views(cuda, gen, B, H, L, D, kv_kind) for _ in range(4))
    assert all(t.stride(-1) == 1 for t in (q, k, v))
    out, lse = _launches("flash_fwd", lambda: TA.flash_fwd(q, k, v))
    ref, ref_lse = TA._attention_plain(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)
    alpha = torch.tensor([0.0, 0.5, 1.0], device=cuda)
    got = _launches("flash2_fwd",
                    lambda: TA.flash2_fwd(q, k, v, k1, v1, alpha))
    torch.testing.assert_close(got, TA.sdpa2_eager(q, k, v, k1, v1, alpha),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [24, 40, 80])
@pytest.mark.parametrize("q_kind,do_kind,kv_kind", [
    ("transposed", "transposed", "expanded"),
    ("sliced", "contiguous", "contiguous"),
    ("contiguous", "sliced", "expanded"),
    ("contiguous", "contiguous", "sliced"),
    ("misaligned", "transposed", "expanded"),
    ("contiguous", "misaligned", "contiguous"),
    ("transposed", "contiguous", "misaligned")])
def test_flash_bwd_strides_and_alignment(cuda, D, q_kind, do_kind, kv_kind):
    """K4a and K4b read strided and stride-0 q, dO, k and v through their
    strides; an unaligned base or row stride in any of them takes the
    masked scalar copy in place of cp.async: both give the plain version's
    gradients."""
    gen = _seeded(cuda, (D, q_kind, do_kind, kv_kind))
    B, H, L = 3, 2, 130
    q = _views(cuda, gen, B, H, L, D, q_kind)
    do = _views(cuda, gen, B, H, L, D, do_kind)
    k, v = (_views(cuda, gen, B, H, L, D, kv_kind) for _ in range(2))
    assert all(t.stride(-1) == 1 for t in (q, do, k, v))
    out, lse = TA.flash_fwd(q, k, v)
    delta = TA._delta(do, out)
    dq = _launches("flash_bwd_dq",
                   lambda: TA.flash_bwd_dq(q, k, v, do, lse, delta))
    dk, dv = _launches("flash_bwd_dkv",
                       lambda: TA.flash_bwd_dkv(q, k, v, do, lse, delta))
    want = TA._attention_bwd_plain(q, k, v, out, lse, do)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sliced", "misaligned", "expanded"])
def test_flash_probes_scalar_and_strided_staging(cuda, kind):
    """P1 and P2 through the scalar copy and through stride 0."""
    gen = _seeded(cuda, kind)
    from afldm_tpu_torch.ops import flash_probes as P
    q, k, v = (_views(cuda, gen, 2, 2, 128, 40, kind) for _ in range(3))
    for name, plain, rel in (("flash_probe_dots", P.flash_probe_dots_plain,
                              2e-5),
                             ("flash_probe_stream",
                              P.flash_probe_stream_plain, 1e-5)):
        got = _launches(name, lambda: getattr(P, name)(q, k, v))
        want = plain(q, k, v)
        err = float((got - want).abs().max())
        assert err <= rel * float(want.abs().max()), (name, err)


# -- the reduced precision levels: the bf16 tensor-core variants ------------

# A variant agrees with its plain version at the same level when the RMS of
# their difference is at most LEVEL_RMS_RATIO of the level's own RMS error
# (plain at the level against plain at 'highest'), and their max difference
# at most the level's own max error: the tensor core sums in another order
# than cuBLAS, and a 1-ulp change of an f32 intermediate can move its bf16
# split by one bf16 ulp of lo ('high') or of hi ('default') at a few
# elements, so the max is bounded loosely and the RMS tightly.
LEVEL_RMS_RATIO = 0.25


def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def assert_level_close(got, want, exact):
    own_rms, own_max = _rms(want - exact), float((want - exact).abs().max())
    assert own_rms > 0, "the level changed nothing"
    err_rms, err_max = _rms(got - want), float((got - want).abs().max())
    assert err_rms <= LEVEL_RMS_RATIO * own_rms, (err_rms, own_rms)
    assert err_max <= own_max, (err_max, own_max)


@pytest.fixture(params=["high", "default"])
def level(request):
    from afldm_tpu_torch.ops import set_af_precision
    set_af_precision(request.param)
    yield request.param
    set_af_precision("highest")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 32), (2, 64, 4, 4), (1, 8, 64, 64), (1, 4, 12, 20),
    (3, 5, 8, 8), (1, 7, 4, 64), (1, 192, 32, 32)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_plane_level_variant_matches_plain(cuda, level, shape, act):
    gen = _seeded(cuda, (level, shape, act))
    x = torch.randn(shape, device=cuda, generator=gen)
    got = _launches(f"filtered_act_plane:{level}",
                    lambda: TF.filtered_act_plane(x, act))
    assert_level_close(got, TF.filtered_act_plane_plain(x, act, level),
                       TF.filtered_act_plane_plain(x, act, "highest"))


def _walk_planes(level, side, case):
    """Plane counts of side × side planes for K5's persistent walk at
    ``level``: one plane; one short of and one past the largest grid (the
    blocks an SM × the SMs: every block one group, or one block two); and
    several planes an iteration, each block walking several groups, the
    last one ragged."""
    full = TF.plane_mma_plan(side, side, 1 << 20, level)
    grid = full.per_sm * TF.NUM_SMS
    return {"one": 1, "grid-1": grid - 1, "grid+1": grid + 1,
            "several": 3 * full.planes * grid + 5}[case]


@pytest.mark.cuda
@pytest.mark.parametrize("side, case", [
    (64, "one"), (64, "grid-1"), (64, "grid+1"), (32, "several"),
    (8, "several"), (4, "several")])
def test_plane_level_persistent_walk(cuda, level, side, case):
    """K5's bf16 variant walks its planes in persistent blocks (the
    operators staged once, the next group's x in flight): every plane
    count gives the plain version at the level."""
    n = _walk_planes(level, side, case)
    plan = TF.plane_mma_plan(side, side, n, level)
    groups = -(-n // plan.planes)
    assert plan.grid == min(groups, plan.per_sm * TF.NUM_SMS)
    assert (groups > plan.grid) == (case in ("grid+1", "several"))
    assert (plan.planes > 1) == (case == "several")
    gen = _seeded(cuda, (level, side, case))
    x = torch.randn((1, n, side, side), device=cuda, generator=gen)
    got = _launches(f"filtered_act_plane:{level}",
                    lambda: TF.filtered_act_plane(x, "silu"))
    assert_level_close(got, TF.filtered_act_plane_plain(x, "silu", level),
                       TF.filtered_act_plane_plain(x, "silu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 64, 64), (2, 64, 4, 4)])
def test_plane_level_bf16_x_rounds_the_f32_walk(cuda, level, shape):
    """K5's bf16 variant on a bf16 x (raw bf16 planes in flight, widened
    as they are split; lo pieces zero) is the f32 x variant on the widened
    x, rounded once to bf16, bit for bit; that one is held to the plain
    version at the level."""
    gen = _seeded(cuda, (level, shape, "bf16_x"))
    x = torch.randn(shape, device=cuda, generator=gen).to(BF)
    got = _launches(f"filtered_act_plane:{level}/bf16",
                    lambda: TF.filtered_act_plane(x, "silu"))
    wide = _launches(f"filtered_act_plane:{level}",
                     lambda: TF.filtered_act_plane(x.float(), "silu"))
    assert got.dtype == BF and torch.equal(got, wide.to(BF))
    assert_level_close(wide,
                       TF.filtered_act_plane_plain(x.float(), "silu", level),
                       TF.filtered_act_plane_plain(x.float(), "silu",
                                                   "highest"))


@pytest.mark.cuda
def test_plane_level_channel_slice(cuda, level):
    """A slice of the channels runs K5's bf16 variant on its contiguous
    copy."""
    gen = _seeded(cuda, (level, "plane_level_channel_slice"))
    x = torch.randn(2, 24, 16, 16, device=cuda, generator=gen)[:, 5:17]
    assert not x.is_contiguous()
    got = _launches(f"filtered_act_plane:{level}",
                    lambda: TF.filtered_act_plane(x, "silu"))
    assert_level_close(got, TF.filtered_act_plane_plain(x, "silu", level),
                       TF.filtered_act_plane_plain(x, "silu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 32), (2, 64, 4, 4), (1, 8, 64, 64), (1, 4, 12, 20),
    (3, 5, 8, 8), (1, 7, 4, 64)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_plane_bwd_level_variant_matches_plain(cuda, level, shape, act):
    gen = _seeded(cuda, (level, shape, act))
    x, g = (torch.randn(shape, device=cuda, generator=gen) for _ in range(2))
    got = _launches(f"filtered_act_plane_bwd:{level}",
                    lambda: TF.filtered_act_plane_bwd(x, g, act))
    assert_level_close(got, TF.filtered_act_plane_bwd_plain(x, g, act, level),
                       TF.filtered_act_plane_bwd_plain(x, g, act, "highest"))


def _bwd_walk_planes(level, side, case):
    """Plane counts of side × side planes for K5b's persistent walk at
    ``level`` (``_walk_planes``' cases): one plane; one short of and one
    past the largest grid; several planes an iteration, each block walking
    several groups, the last one ragged."""
    full = TF.plane_mma_bwd_plan(side, side, 1 << 20, level)
    grid = full.per_sm * TF.NUM_SMS
    return {"one": 1, "grid-1": grid - 1, "grid+1": grid + 1,
            "several": 3 * full.planes * grid + 5}[case]


@pytest.mark.cuda
@pytest.mark.parametrize("side, case", [
    (64, "one"), (64, "grid-1"), (64, "grid+1"), (32, "several"),
    (8, "several"), (4, "several")])
def test_plane_bwd_level_persistent_walk(cuda, level, side, case):
    """K5b's bf16 variant walks its planes in persistent blocks (the next
    group's x and g in flight, the operators resident or phased): fewer
    groups than the largest grid, one more, and a plane count that is not a
    multiple of P give the plain version at the level."""
    n = _bwd_walk_planes(level, side, case)
    plan = TF.plane_mma_bwd_plan(side, side, n, level)
    groups = -(-n // plan.planes)
    assert plan.grid == min(groups, plan.per_sm * TF.NUM_SMS)
    assert (groups > plan.grid) == (case in ("grid+1", "several"))
    assert (n % plan.planes != 0) == (case == "several")
    gen = _seeded(cuda, (level, side, case, "bwd"))
    x, g = (torch.randn((1, n, side, side), device=cuda, generator=gen)
            for _ in range(2))
    got = _launches(f"filtered_act_plane_bwd:{level}",
                    lambda: TF.filtered_act_plane_bwd(x, g, "silu"))
    assert_level_close(got, TF.filtered_act_plane_bwd_plain(x, g, "silu",
                                                            level),
                       TF.filtered_act_plane_bwd_plain(x, g, "silu",
                                                       "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_bwd_level_zero_planes(cuda, level, dtype):
    """0 planes: an empty dx and no launch."""
    x = torch.empty((0, 4, 64, 64), device=cuda, dtype=dtype)
    key = f"filtered_act_plane_bwd:{level}" + (
        "/bf16" if dtype == torch.bfloat16 else "")
    before = kernels.LAUNCHES[key]
    dx = TF.filtered_act_plane_bwd(x, x, "silu")
    assert dx.shape == x.shape and kernels.LAUNCHES[key] == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 64, 64), (1, 6, 20, 12)])
def test_plane_bwd_level_takes_a_strided_cotangent(cuda, level, shape):
    """Through autograd the cotangent of K5's level variant arrives
    strided (here transposed); K5b's level variant takes its contiguous
    copy and gives the plain version at the level."""
    gen = _seeded(cuda, (level, shape, "strided"))
    x = torch.randn(shape, device=cuda, generator=gen).requires_grad_()
    w = torch.randn(shape[:2] + shape[:1:-1], device=cuda, generator=gen)
    y = TF.filtered_act_plane(x, "silu")
    g = w.transpose(2, 3)
    assert not g.is_contiguous()
    before = kernels.LAUNCHES[f"filtered_act_plane_bwd:{level}"]
    (y.transpose(2, 3) * w).sum().backward()
    assert kernels.LAUNCHES[f"filtered_act_plane_bwd:{level}"] == before + 1
    x0 = x.detach()
    assert_level_close(x.grad, TF.filtered_act_plane_bwd_plain(
        x0, g, "silu", level), TF.filtered_act_plane_bwd_plain(
            x0, g, "silu", "highest"))


# K5b's level variants' outputs on inputs drawn with numpy from a seed of
# the case (torch's CUDA generator plays no part): the SHA-256 of dx's
# bytes, recorded on an H100 from K5b's first bf16 form (a 16×16 tile walk
# of five products through shared memory), which the persistent walk gives
# bit for bit. Shapes: 64 px (phased operators), 32, 8 and 4 px (resident),
# mixed sides.
K5B_LEVEL_SHAPES = ((2, 8, 64, 64), (1, 40, 32, 32), (1, 300, 4, 4),
                    (2, 5, 8, 8), (1, 7, 4, 64), (1, 4, 12, 20))
K5B_LEVEL_DIGESTS = {
    ('high', 'float32', (2, 8, 64, 64)):
        'b863d7f53e92410a5d30c8476322ff1c1a7110acff137a376ebf3722b8c4b862',
    ('high', 'float32', (1, 40, 32, 32)):
        'bf5464aa8e42d7a04f5d65e11db0853e232bc3cf8b49cb6bbefe046762dca9e4',
    ('high', 'float32', (1, 300, 4, 4)):
        '2e6f06d0286f13ab7f996ebea98d117c820d198231f739c8fa2e4753ea516675',
    ('high', 'float32', (2, 5, 8, 8)):
        '4c2d761713ad63ccc4733e34ca7eac1a53ff5163e9b1e073611738c387c25e03',
    ('high', 'float32', (1, 7, 4, 64)):
        '83d1184ff2465fa728b3ee7697a4b4f1435a6e1fc22cdb9878c3c1e3c14956ac',
    ('high', 'float32', (1, 4, 12, 20)):
        '2b444542ac62c5c696016634d8c45b344168b309c0f4b0c00c9ff2b36351f6db',
    ('high', 'bfloat16', (2, 8, 64, 64)):
        'c2ae41ef0f7815665ab54dd227efa1ddf7288a608b8577206fb475fdecfe2945',
    ('high', 'bfloat16', (1, 40, 32, 32)):
        'f2d5490d5523444e5366bcad121040bdeee30937040d0b7c3b3941e7e4cd239b',
    ('high', 'bfloat16', (1, 300, 4, 4)):
        'c29f3fc4c90c336811df40e21b52718921926e2bd91523369c75bf799515c3a7',
    ('high', 'bfloat16', (2, 5, 8, 8)):
        '51dc970142ebcf8efb2a81afcdb2c68cf5f0b8660839bb59ede6cd09491712f9',
    ('high', 'bfloat16', (1, 7, 4, 64)):
        '784ba3db837b07fb2789014acb65e4c6df64f9b0fc888abc718e9882713b3cec',
    ('high', 'bfloat16', (1, 4, 12, 20)):
        'aa5a57d64a0c4f3770c36be29ec8281c9c6f1c012ef2ba0e9def7eab67d3a688',
    ('default', 'float32', (2, 8, 64, 64)):
        '79efbcafdf3147373906d8ba7436e894cf843b473aff41172dcda0a152696c18',
    ('default', 'float32', (1, 40, 32, 32)):
        '509f67a20a13b37e55f64b8d67c603bfd90c14e1cafe95ad2efdedea551da1b9',
    ('default', 'float32', (1, 300, 4, 4)):
        '4964906169f2c0c0698d0e53bff2d7c41b4d0f9f274b3c2c3a286ca5e30cdc9b',
    ('default', 'float32', (2, 5, 8, 8)):
        '5ed375897ba13c5bd02230b784ae4e01690cba8e40b15002b0a114a156042bb8',
    ('default', 'float32', (1, 7, 4, 64)):
        '2bfffce17964cc859bb326ef9eff18ba40f5af04b99d435d7150739d5150c453',
    ('default', 'float32', (1, 4, 12, 20)):
        '84e9c669d7342eb2b762a776bd3dc6a29bae1b07f35c42f5ba89c618648e7386',
    ('default', 'bfloat16', (2, 8, 64, 64)):
        '8b28bf99dd93ebb68fb7e5ecfc35ca4ebd7d3789e71d1c59545653bbbc531f6e',
    ('default', 'bfloat16', (1, 40, 32, 32)):
        '3d29f4c206115001aa1388e1e4dc5716af471571253ae083c659049c4b5c24c3',
    ('default', 'bfloat16', (1, 300, 4, 4)):
        '2f9b9d9672239cafe72d4399679031da852802928829264fe613d4a80e051390',
    ('default', 'bfloat16', (2, 5, 8, 8)):
        'b6ee081adf3abb33d55ab291b8b9642239b22c287de22139f2db59a664fedd16',
    ('default', 'bfloat16', (1, 7, 4, 64)):
        '68ed2be149695b2e3b987fed6f1da669ba09f6b2a4ce983f6da28548274c47c2',
    ('default', 'bfloat16', (1, 4, 12, 20)):
        '1164328b96fddc5d22b1e707bc7a9cf11eb9cd901e9e4638b2494d3b4cb6ff06',
}


def k5b_level_digest(level, dtype, shape, device):
    """The SHA-256 of K5b's dx at ``level`` for a ``dtype`` ("float32" or
    "bfloat16") x and g drawn with numpy from a seed of the case."""
    from afldm_tpu_torch.ops import set_af_precision
    rng = np.random.default_rng(zlib.crc32(repr(("k5b", level, dtype,
                                                 shape)).encode()))
    x, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device).to(getattr(torch, dtype)) for _ in range(2))
    set_af_precision(level)
    try:
        dx = TF.filtered_act_plane_bwd(x, g, "silu")
        torch.cuda.synchronize()
    finally:
        set_af_precision("highest")
    return hashlib.sha256(dx.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K5B_LEVEL_SHAPES)
def test_plane_bwd_level_outputs_are_recorded(cuda, level, dtype, shape):
    """K5b at a level gives the recorded bits: a change of its sums' order
    cannot pass unseen."""
    assert k5b_level_digest(level, dtype, shape, cuda) == \
        K5B_LEVEL_DIGESTS[(level, dtype, shape)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 96, 96), (2, 3, 128, 128),
                                   (1, 2, 80, 80), (1, 3, 32, 128),
                                   (1, 1, 200, 104)])
def test_banded_level_variants_match_plain(cuda, level, shape):
    gen = _seeded(cuda, (level, shape))
    x, g = (torch.randn(shape, device=cuda, generator=gen) for _ in range(2))
    got = _launches(f"filtered_act_banded:{level}",
                    lambda: TF.filtered_act_banded(x, "silu"))
    assert_level_close(got, TF.filtered_act_banded_plain(x, "silu", level),
                       TF.filtered_act_banded_plain(x, "silu", "highest"))
    got = _launches(f"filtered_act_banded_bwd:{level}",
                    lambda: TF.filtered_act_banded_bwd(x, g, "silu"))
    assert_level_close(
        got, TF.filtered_act_banded_bwd_plain(x, g, "silu", level),
        TF.filtered_act_banded_bwd_plain(x, g, "silu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 3, 32, 128), (1, 1, 200, 104), (1, 1, 128, 32),
    # the down launch in 32-row strips at 'high' (its lo strip 1024 wide)
    (1, 1, 512, 512),
    # 2H and H not multiples of the strips (64), plane counts that fill
    # no wave of blocks
    (1, 7, 68, 92), (1, 133, 80, 80), (1, 1, 100, 100)])
def test_banded_level_fused_chain(cuda, level, shape):
    """K1's level chain, two launches a chunk (t and lo on chip, hi's
    split pieces in the scratch), against the plain version at the
    level."""
    gen = _seeded(cuda, (level, shape, "fused"))
    x = torch.randn(shape, device=cuda, generator=gen)
    got = _launches(f"filtered_act_banded:{level}",
                    lambda: TF.filtered_act_banded(x, "silu"))
    assert_level_close(got, TF.filtered_act_banded_plain(x, "silu", level),
                       TF.filtered_act_banded_plain(x, "silu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("side, planes, cap_planes", [
    (96, 5, 2), (128, 9, 4), (200, 3, 1)])
def test_banded_level_crosses_chunks(cuda, monkeypatch, level, side, planes,
                                     cap_planes):
    """Under a cap of a few planes' hi pieces K1's level chain runs several
    chunks on one scratch: each plane's result is the one-chunk run's, bit
    for bit, and the plain version's at the level."""
    gen = _seeded(cuda, (level, side, planes, "chunks"))
    x = torch.randn(1, planes, side, side, device=cuda, generator=gen)
    whole = _launches(f"filtered_act_banded:{level}",
                      lambda: TF.filtered_act_banded(x, "silu"))
    monkeypatch.setattr(TF, "BANDED_HI_BYTES",
                        TF.banded_mma_scratch_bytes(side, side, cap_planes,
                                                    level))
    assert len(TF.banded_mma_plan(side, side, planes, level,
                                  TF.BANDED_HI_BYTES)) > 1
    got = _launches(f"filtered_act_banded:{level}",
                    lambda: TF.filtered_act_banded(x, "silu"))
    assert torch.equal(got, whole)
    assert_level_close(got, TF.filtered_act_banded_plain(x, "silu", level),
                       TF.filtered_act_banded_plain(x, "silu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 96, 96), (1, 3, 32, 128),
                                   (1, 1, 200, 104)])
def test_banded_level_bf16_x_rounds_the_f32_chain(cuda, level, shape):
    """K1's level chain on a bf16 x (staged raw by 8-byte copies, widened
    as it is split; lo pieces zero) is the f32 x chain on the widened x,
    rounded once to bf16, bit for bit; that one is held to the plain
    version at the level."""
    gen = _seeded(cuda, (level, shape, "bf16_x"))
    x = torch.randn(shape, device=cuda, generator=gen).to(BF)
    got = _launches(f"filtered_act_banded:{level}/bf16",
                    lambda: TF.filtered_act_banded(x, "silu"))
    wide = _launches(f"filtered_act_banded:{level}",
                     lambda: TF.filtered_act_banded(x.float(), "silu"))
    assert got.dtype == BF and torch.equal(got, wide.to(BF))
    assert_level_close(wide,
                       TF.filtered_act_banded_plain(x.float(), "silu", level),
                       TF.filtered_act_banded_plain(x.float(), "silu",
                                                    "highest"))


@pytest.mark.cuda
def test_banded_level_channel_slice(cuda, level):
    """A slice of the channels runs K1's level chain on its contiguous
    copy."""
    gen = _seeded(cuda, (level, "banded_level_channel_slice"))
    x = torch.randn(2, 24, 96, 96, device=cuda, generator=gen)[:, 5:17]
    assert not x.is_contiguous()
    got = _launches(f"filtered_act_banded:{level}",
                    lambda: TF.filtered_act_banded(x, "silu"))
    assert_level_close(got, TF.filtered_act_banded_plain(x, "silu", level),
                       TF.filtered_act_banded_plain(x, "silu", "highest"))


@pytest.mark.cuda
def test_banded_level_applies_up_to_512_px(cuda, level):
    """Above LEVEL_MAX the f32 chain runs at every level, as the JAX
    package filters exactly (spectrally) there."""
    gen = _seeded(cuda, level)
    x = torch.randn(1, 1, 1024, 1024, device=cuda, generator=gen)
    got = _launches("filtered_act_banded",
                    lambda: TF.filtered_act_banded(x, "silu"))
    torch.testing.assert_close(
        got, TF.filtered_act_banded_plain(x, "silu", "highest"), atol=3e-5,
        rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 3, 32, 128), (1, 1, 200, 104), (1, 1, 128, 32),
    # the up launch in 32-row strips at 'high' (t's and v's strips 512
    # wide), the down launch too (its s strip 1024 wide)
    (1, 1, 512, 512),
    # 2H and H not multiples of the strips (64), plane counts that fill
    # no wave of blocks
    (1, 7, 68, 92), (1, 133, 80, 80), (1, 1, 100, 100)])
def test_banded_level_bwd_fused_chain(cuda, level, shape):
    """K2's level chain, two launches a chunk (t, v, pre and s on chip,
    m's split pieces in the scratch), against the plain version at the
    level."""
    gen = _seeded(cuda, (level, shape, "bwd_fused"))
    x, g = (torch.randn(shape, device=cuda, generator=gen) for _ in range(2))
    got = _launches(f"filtered_act_banded_bwd:{level}",
                    lambda: TF.filtered_act_banded_bwd(x, g, "silu"))
    assert_level_close(
        got, TF.filtered_act_banded_bwd_plain(x, g, "silu", level),
        TF.filtered_act_banded_bwd_plain(x, g, "silu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("side, planes, cap_planes", [
    (96, 5, 2), (128, 9, 4), (200, 3, 1)])
def test_banded_level_bwd_crosses_chunks(cuda, monkeypatch, level, side,
                                         planes, cap_planes):
    """Under a cap of a few planes' m pieces K2's level chain runs several
    chunks on one scratch: each plane's result is the one-chunk run's, bit
    for bit, and the plain version's at the level."""
    gen = _seeded(cuda, (level, side, planes, "bwd_chunks"))
    x, g = (torch.randn(1, planes, side, side, device=cuda, generator=gen)
            for _ in range(2))
    whole = _launches(f"filtered_act_banded_bwd:{level}",
                      lambda: TF.filtered_act_banded_bwd(x, g, "gelu"))
    monkeypatch.setattr(TF, "BANDED_HI_BYTES",
                        TF.banded_mma_scratch_bytes(side, side, cap_planes,
                                                    level))
    assert len(TF.banded_mma_plan(side, side, planes, level,
                                  TF.BANDED_HI_BYTES, True)) > 1
    got = _launches(f"filtered_act_banded_bwd:{level}",
                    lambda: TF.filtered_act_banded_bwd(x, g, "gelu"))
    assert torch.equal(got, whole)
    assert_level_close(
        got, TF.filtered_act_banded_bwd_plain(x, g, "gelu", level),
        TF.filtered_act_banded_bwd_plain(x, g, "gelu", "highest"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 96, 96), (1, 3, 32, 128),
                                   (1, 1, 200, 104), (1, 1, 512, 512)])
def test_banded_level_bwd_bf16_rounds_the_f32_chain(cuda, level, shape):
    """K2's level chain on a bf16 x and g (staged raw by 8-byte copies,
    widened as they are split; lo pieces zero) is the f32 chain on the
    widened inputs, dx rounded once to bf16, bit for bit."""
    gen = _seeded(cuda, (level, shape, "bwd_bf16"))
    x, g = (torch.randn(shape, device=cuda, generator=gen).to(BF)
            for _ in range(2))
    got = _launches(f"filtered_act_banded_bwd:{level}/bf16",
                    lambda: TF.filtered_act_banded_bwd(x, g, "silu"))
    wide = _launches(f"filtered_act_banded_bwd:{level}",
                     lambda: TF.filtered_act_banded_bwd(x.float(), g.float(),
                                                        "silu"))
    assert got.dtype == BF and torch.equal(got, wide.to(BF))


def _six_gemm_chain(x, g, act, level):
    """K2 at ``level`` as the six launches of the GEMM's bf16 variant that
    it replaced, in _bwd_spatial's order: t = U_h·x, pre = t·U_wᵀ, v =
    D_hᵀ·g, m = act′(pre) ⊙ (v·D_w) (the epilogue that reads C), s =
    U_hᵀ·m, dx = s·U_w; f32 intermediates, U_h, D_hᵀ and U_hᵀ from their
    k-major forms."""
    N, C, H, W = x.shape
    P = N * C
    uh, uwT, dh, _ = TF._kernel_ops(H, W, x.device)
    _, dw, uw, uhT = TF._kernel_bwd_ops(H, W, x.device)

    def gemm(a, b, kmajor=False, **kw):
        return TF.filtered_gemm(a, b, a_kmajor=kmajor, level=level, **kw)

    t = gemm(uhT[None].expand(P, -1, -1), x.reshape(P, H, W), True)
    pre = gemm(t.view(1, P * 2 * H, W), uwT[None])
    v = gemm(dh[None].expand(P, -1, -1), g.reshape(P, H, W), True)
    m = gemm(v.view(1, P * 2 * H, W), dw[None], act=act, grad_at=pre)
    s = gemm(uh[None].expand(P, -1, -1), m.view(P, 2 * H, 2 * W), True)
    return gemm(s.view(1, P * H, 2 * W), uw[None]).view(N, C, H, W)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 80, 80), (1, 3, 32, 128),
                                   (1, 7, 68, 92), (1, 1, 200, 104),
                                   (1, 1, 512, 512)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_banded_level_bwd_is_the_six_gemm_chain(cuda, level, shape, act):
    """The two fused launches sum every element as the six launches of
    ``filtered_gemm``'s bf16 variant they replaced (16-deep steps in
    ascending k, TwoSum at 'high', the small passes ah·bl then al·bh;
    each intermediate split as that chain splits it on load): dx equal
    bit for bit."""
    gen = _seeded(cuda, (level, shape, act, "six_gemm"))
    x, g = (torch.randn(shape, device=cuda, generator=gen) for _ in range(2))
    got = _launches(f"filtered_act_banded_bwd:{level}",
                    lambda: TF.filtered_act_banded_bwd(x, g, act))
    assert torch.equal(got, _six_gemm_chain(x, g, act, level))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("a_kmajor", [False, True])
@pytest.mark.parametrize("small", [False, True])
def test_gemm_level_variant_matches_plain(cuda, level, shape, a_kmajor,
                                          small):
    gen = _seeded(cuda, (level, shape, a_kmajor, small))
    batch, M, N, K = shape
    a = torch.randn((batch, K, M) if a_kmajor else (batch, M, K),
                    device=cuda, generator=gen)
    b = torch.randn(batch, K, N, device=cuda, generator=gen)
    pre = torch.randn(batch, M, N, device=cuda, generator=gen)
    got = _launches(f"filtered_gemm:{level}",
                    lambda: TF.filtered_gemm(a, b, "silu", a_kmajor, small))
    assert_level_close(
        got, TF.filtered_gemm_plain(a, b, "silu", a_kmajor, None, level),
        TF.filtered_gemm_plain(a, b, "silu", a_kmajor))
    got = _launches(f"filtered_gemm:{level}",
                    lambda: TF.filtered_gemm(a, b, "gelu", a_kmajor, small,
                                             grad_at=pre))
    assert_level_close(
        got, TF.filtered_gemm_plain(a, b, "gelu", a_kmajor, pre, level),
        TF.filtered_gemm_plain(a, b, "gelu", a_kmajor, pre))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (1, 4, 128, 128)])
def test_level_functions_keep_the_forward_level(cuda, shape):
    """The autograd Functions run the backward at the forward's level even
    when the level changes in between."""
    gen = _seeded(cuda, shape)
    from afldm_tpu_torch.ops import set_af_precision
    kind = "plane" if shape[-1] <= TF.PLANE_MAX else "banded"
    x = torch.randn(shape, device=cuda, requires_grad=True, generator=gen)
    try:
        set_af_precision("high")
        out = TF.filtered_act_fused(x, "silu")
        set_af_precision("highest")
        before = kernels.LAUNCHES[f"filtered_act_{kind}_bwd:high"]
        out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
    finally:
        set_af_precision("highest")
    assert kernels.LAUNCHES[f"filtered_act_{kind}_bwd:high"] == before + 1
    plain = (TF.filtered_act_plane_bwd_plain if kind == "plane"
             else TF.filtered_act_banded_bwd_plain)
    g = torch.ones_like(x)
    assert_level_close(x.grad, plain(x.detach(), g, "silu", "high"),
                       plain(x.detach(), g, "silu", "highest"))


# -- bfloat16 activations: K5, K1 (every level), K3 and K6 ------------------

# A filtered activation at bf16 agrees with its plain version (the same f32
# function between a bf16 load and a bf16 store) when no element is more
# than one bf16 ulp of itself off beyond the f32 kernel's atol (3e-5: an
# element that cancels to near zero carries f32 sum-order error) and at
# most 0.1 % of the elements, or 2 of a smaller tensor, differ (a 1-ulp
# flip on a rounding edge: one of 960 elements at (1, 4, 12, 20) on an
# H100); at 'default', where each f32
# intermediate is cut to its bf16 hi piece, as its f32 twin is held
# (assert_level_close on the bf16 outputs). Attention at bf16 agrees with its
# plain version (the online softmax of flash_fwd_plain and flash2_fwd_plain;
# the JAX kernels' roundings for the backward) when, over ATTN_DRAWS seeded
# draws of a case, the 90th percentile of the RMS of their difference is at
# most 0.1 of bf16's own error (plain at bf16 against the f32 plain on the
# same values) and no element of any draw is more than 4 bf16 ulps of the
# output's largest magnitude off. One draw at a time would not do: at
# (1, 2, 64, 200, 8) a single flipped rounding of one of 1024 outputs lifts
# K3/bf16's ratio past 0.1 on 7 of 200 draws on an H100 (p90 0.037), so one
# fixed draw would only say whether it happened to land there.
BF = torch.bfloat16


def _bf16_ulps(got, want, atol):
    got, want = got.double(), want.double()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    d = ((got - want).abs() - atol).clamp(min=0)
    return torch.where(d > 0, d / torch.ldexp(torch.ones_like(d), e - 8),
                       torch.zeros_like(d))


def assert_bf16_close(got, want, exact, level, atol=3e-5):
    """``exact``: the plain version at 'highest' on the same bf16 x."""
    assert got.dtype == want.dtype == BF
    if level == "default":
        assert_level_close(got.float(), want.float(), exact.float())
        return
    assert float(_bf16_ulps(got, want, atol).max()) <= 1
    assert int((got != want).sum()) <= max(2, 1e-3 * got.numel())


@pytest.fixture(params=["highest", "high", "default"])
def any_level(request):
    from afldm_tpu_torch.ops import set_af_precision
    set_af_precision(request.param)
    yield request.param
    set_af_precision("highest")


def _bf16_key(name, level):
    return name + ("" if level == "highest" else f":{level}") + "/bf16"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 32), (2, 64, 4, 4), (1, 8, 64, 64), (1, 4, 12, 20),
    (3, 5, 8, 8), (1, 7, 4, 64), (1, 192, 32, 32), (16, 96, 16, 16)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plane_bf16_variant_matches_plain(cuda, any_level, shape, act):
    gen = _seeded(cuda, (any_level, shape, act))
    x = torch.randn(shape, device=cuda, generator=gen).to(BF)
    got = _launches(_bf16_key("filtered_act_plane", any_level),
                    lambda: TF.filtered_act_plane(x, act))
    assert_bf16_close(got, TF.filtered_act_plane_plain(x, act, any_level),
                      TF.filtered_act_plane_plain(x, act, "highest"),
                      any_level)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 96, 96), (2, 3, 128, 128),
                                   (1, 2, 80, 80), (1, 3, 32, 128),
                                   (1, 1, 200, 104)])
def test_banded_bf16_variant_matches_plain(cuda, any_level, shape):
    gen = _seeded(cuda, (any_level, shape))
    x = torch.randn(shape, device=cuda, generator=gen).to(BF)
    got = _launches(_bf16_key("filtered_act_banded", any_level),
                    lambda: TF.filtered_act_banded(x, "silu"))
    assert_bf16_close(got, TF.filtered_act_banded_plain(x, "silu",
                                                        any_level),
                      TF.filtered_act_banded_plain(x, "silu", "highest"),
                      any_level)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 32), (2, 64, 4, 4), (1, 8, 64, 64), (1, 4, 12, 20),
    (3, 5, 8, 8), (1, 7, 4, 64), (1, 192, 32, 32)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plane_bwd_bf16_variant_matches_plain(cuda, any_level, shape, act):
    """K5b at bf16: bf16(vjp(f32(x), f32(g))), to the forward's criteria at
    the backward's atol (1e-4)."""
    gen = _seeded(cuda, (any_level, shape, act))
    x, g = (torch.randn(shape, device=cuda,
                        generator=gen).to(BF) for _ in range(2))
    got = _launches(_bf16_key("filtered_act_plane_bwd", any_level),
                    lambda: TF.filtered_act_plane_bwd(x, g, act))
    assert_bf16_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, act, any_level),
        TF.filtered_act_plane_bwd_plain(x, g, act, "highest"), any_level,
        atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 96, 96), (2, 3, 128, 128),
                                   (1, 2, 80, 80), (1, 3, 32, 128),
                                   (1, 1, 200, 104)])
def test_banded_bwd_bf16_variant_matches_plain(cuda, any_level, shape):
    gen = _seeded(cuda, (any_level, shape))
    x, g = (torch.randn(shape, device=cuda,
                        generator=gen).to(BF) for _ in range(2))
    got = _launches(_bf16_key("filtered_act_banded_bwd", any_level),
                    lambda: TF.filtered_act_banded_bwd(x, g, "silu"))
    assert_bf16_close(
        got, TF.filtered_act_banded_bwd_plain(x, g, "silu", any_level),
        TF.filtered_act_banded_bwd_plain(x, g, "silu", "highest"), any_level,
        atol=1e-4)


@pytest.mark.cuda
def test_bf16_filtered_backward_launches_its_kernel(cuda):
    """Through the autograd Functions, a bf16 x and its cotangent (strided:
    a transposed view) run the bf16 backward kernels and give a bf16
    gradient."""
    gen = _seeded(cuda, "bf16_filtered_backward_launches_its_kernel")
    for shape, kind in (((1, 2, 8, 8), "plane"), ((1, 2, 96, 96),
                                                 "banded")):
        x = torch.randn(shape, device=cuda,
                        generator=gen).to(BF).requires_grad_()
        out = TF.filtered_act_fused(x, "silu")
        g = torch.randn(shape[::-1], device=cuda,
                        generator=gen).to(BF).permute(3, 2, 1, 0)
        _launches(f"filtered_act_{kind}_bwd/bf16",
                  lambda: out.backward(g))
        assert x.grad.dtype == BF
        plain = getattr(TF, f"filtered_act_{kind}_bwd_plain")
        assert_bf16_close(x.grad, plain(x.detach(), g, "silu"),
                          plain(x.detach(), g, "silu"), "highest",
                          atol=1e-4)


def _seeded(cuda, case):
    """A generator on the card seeded from the case's parameters, so that a
    ``-k`` subset draws what the whole run draws."""
    return torch.Generator(cuda).manual_seed(zlib.crc32(repr(case).encode()))


# seeded draws a bf16 attention case
ATTN_DRAWS = 32


def _attn_bwd_bf16_inputs(cuda, g, B, H, Lq, Lk, D, nkv):
    q = torch.randn(B, H, Lq, D, device=cuda, generator=g).to(BF)
    k, v = (torch.randn(nkv, H, Lk, D, device=cuda, generator=g).to(BF)
            .expand(B, -1, -1, -1) for _ in range(2))
    do = torch.randn(B, H, Lq, D, device=cuda, generator=g).to(BF)
    out, lse = TA._attention_plain(q, k, v)
    return q, k, v, out, lse, do


# the bf16 tile loop's head dims (DP 32 ... 256: D below, at and between
# them), ragged lengths, 77 text tokens, K/V expanded from one image
BF16_BWD_SHAPES = [  # (B, H, Lq, Lk, D, K/V batch)
    (2, 8, 1024, 1024, 24, 1), (2, 2, 4, 4, 24, 2), (2, 3, 100, 77, 33, 1),
    (1, 2, 64, 200, 8, 1), (2, 2, 130, 130, 80, 2), (1, 2, 256, 256, 40, 1),
    (1, 1, 70, 64, 256, 1), (2, 2, 64, 64, 160, 2), (1, 8, 4096, 77, 40, 1),
    (1, 2, 129, 65, 128, 1), (2, 2, 37, 50, 64, 2), (2, 2, 65, 129, 48, 1),
    # dkv's query walk split over 4 blocks (ragged Lq, two heads: at one
    # head dk and dv have 3080 elements, and the parent kernel's own p90
    # reads 0.098-0.100 there), and the 128-row walked tiles with Lq and Lk
    # not multiples of 128
    (1, 2, 1000, 77, 40, 1), (2, 2, 300, 300, 40, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_BWD_SHAPES)
def test_flash_bwd_bf16_matches_plain(cuda, shape):
    """K4a and K4b at bf16 against their plain versions (the JAX kernels'
    roundings), to the forward's criteria over ATTN_DRAWS seeded draws:
    the RMS ratio's p90 within 0.1 of bf16's own error, every max within 4
    ulps of the output's scale; dq, dk and dv each."""
    g = _seeded(cuda, shape)
    draws = ([], [], [])
    for _ in range(ATTN_DRAWS):
        q, k, v, out, lse, do = _attn_bwd_bf16_inputs(cuda, g, *shape)
        delta = TA._delta(do, out)
        dq = _launches("flash_bwd_dq/bf16",
                       lambda: TA.flash_bwd_dq(q, k, v, do, lse, delta))
        dk, dv = _launches("flash_bwd_dkv/bf16",
                           lambda: TA.flash_bwd_dkv(q, k, v, do, lse, delta))
        want = TA._attention_bwd_plain(q, k, v, out, lse, do)
        want32 = TA._attention_bwd_plain(q.float(), k.float(), v.float(),
                                         out.float(), lse, do.float())
        for d, got, ref, ref32 in zip(draws, (dq, dk, dv), want, want32):
            assert got.shape == ref.shape
            d.append((got, ref, ref32))
    for d in draws:
        assert_attn_bf16_close(d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 4096, 77, 40, 1),
                                   (1, 2, 1000, 77, 40, 1),
                                   (2, 2, 300, 300, 40, 1)])
def test_flash_bwd_bf16_is_deterministic(cuda, shape):
    """Two calls of K4a and K4b at bf16 on the same inputs give the same
    bits (no atomics; a split query walk's partials summed in split order):
    one launch of each a call, and of the split K4b's reduction exactly
    where ``flash_bwd_dkv_splits`` splits (the first two shapes)."""
    B, H, Lq, Lk, D, _ = shape
    gen = _seeded(cuda, shape)
    q, k, v, out, lse, do = _attn_bwd_bf16_inputs(cuda, gen, *shape)
    delta = TA._delta(do, out)
    splits = TA.flash_bwd_dkv_splits(B * H, Lq, Lk, D)
    assert (splits > 1) == (Lk == 77)
    calls = []
    for _ in range(2):
        before = kernels.LAUNCHES["flash_bwd_dkv_reduce"]
        dq = _launches("flash_bwd_dq/bf16",
                       lambda: TA.flash_bwd_dq(q, k, v, do, lse, delta))
        dk, dv = _launches("flash_bwd_dkv/bf16",
                           lambda: TA.flash_bwd_dkv(q, k, v, do, lse, delta))
        assert kernels.LAUNCHES["flash_bwd_dkv_reduce"] == before + (
            splits > 1)
        assert dk.shape == k.shape and dv.shape == v.shape
        calls.append((dq, dk, dv))
    for a, b in zip(*calls):
        assert a.dtype == BF and torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_dkv_reduce_matches_plain(cuda):
    """The split K4b's reduction against its plain version, bit for bit
    (the same f32 sums in split order, one rounding): partials whose
    element count is a multiple of 4 (16-byte loads) and one that is not
    (the scalar path), one split and 16."""
    gen = _seeded(cuda, "flash_bwd_dkv_reduce")
    for shape in [(16, 2, 1, 8, 77, 40), (3, 2, 1, 1, 77, 33),
                  (1, 2, 2, 3, 5, 7)]:
        ws = torch.randn(shape, device=cuda, generator=gen)
        got = _launches("flash_bwd_dkv_reduce",
                        lambda: TA.flash_bwd_dkv_reduce(ws))
        assert got.dtype == BF and got.shape == shape[1:]
        assert torch.equal(got, TA._dkv_reduce_plain(ws))


@pytest.mark.cuda
def test_bf16_attention_backward_launches_its_kernels(cuda):
    """sdpa and sdpa2 at bf16 through autograd: K4a and K4b at bf16 (sdpa2:
    once per K/V set), bf16 gradients, K/V expanded from one image summed
    by autograd."""
    gen = _seeded(cuda, "bf16_attention_backward_launches_its_kernels")
    q = torch.randn(3, 2, 64, 24, device=cuda,
                    generator=gen).to(BF).requires_grad_()
    kv = [torch.randn(1, 2, 64, 24, device=cuda,
                      generator=gen).to(BF).requires_grad_()
          for _ in range(4)]
    for fn, n in ((lambda: TA.sdpa(q, kv[0].expand(3, -1, -1, -1),
                                   kv[1].expand(3, -1, -1, -1)), 1),
                  (lambda: TA.sdpa2(q, *(t.expand(3, -1, -1, -1)
                                         for t in kv), 0.3), 2)):
        out = fn()
        before = {k: kernels.LAUNCHES[k]
                  for k in ("flash_bwd_dq/bf16", "flash_bwd_dkv/bf16",
                            "flash_bwd_dq", "flash_bwd_dkv")}
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flash_bwd_dq/bf16"] == \
            before["flash_bwd_dq/bf16"] + n
        assert kernels.LAUNCHES["flash_bwd_dkv/bf16"] == \
            before["flash_bwd_dkv/bf16"] + n
        assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"]
        assert q.grad.dtype == BF and kv[0].grad.shape == (1, 2, 64, 24)
        assert all(torch.isfinite(t.grad.float()).all() for t in (q, kv[0]))


def assert_attn_bf16_close(draws):
    """``draws``: (kernel, plain, the f32 plain) of each draw of a case."""
    ratios = []
    for got, want, want32 in draws:
        assert got.dtype == want.dtype == BF
        d = (got.float() - want.float())
        ratios.append(_rms(d) / _rms(want.float() - want32.float()))
        _, e = torch.frexp(want.float().abs().max())
        assert float(d.abs().max()) <= 4 * 2.0 ** (int(e) - 8)
    p90 = float(torch.tensor(ratios).quantile(0.9))
    assert p90 <= 0.1, (p90, max(ratios))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,L,Lk,d,n_kv", [
    (2, 8, 1024, 1024, 24, 1), (2, 2, 4, 4, 24, 2), (2, 3, 100, 77, 33, 1),
    (1, 2, 64, 200, 8, 1), (2, 2, 130, 130, 80, 2), (1, 2, 256, 256, 40, 1),
    (1, 1, 70, 64, 256, 1), (2, 2, 64, 64, 160, 2),
    # K/V expanded from one image (stride 0) over ragged key tiles; all 64
    # keys in one 64-key tile (with_fwd_cfg)
    (3, 2, 256, 200, 40, 1), (2, 2, 77, 300, 160, 1), (2, 2, 100, 64, 40, 1)])
def test_flash_bf16_matches_plain(cuda, n, h, L, Lk, d, n_kv):
    """K3/bf16 against ``flash_fwd_plain`` (the online softmax at the
    kernel's key tile) on ATTN_DRAWS seeded draws: out to the criteria
    above, every lse within 1e-5."""
    g = _seeded(cuda, (n, h, L, Lk, d, n_kv))
    draws = []
    for _ in range(ATTN_DRAWS):
        q = torch.randn(n, h, L, d, device=cuda, generator=g).to(BF)
        k, v = (torch.randn(n_kv, h, Lk, d, device=cuda, generator=g).to(BF)
                .expand(n, -1, -1, -1) for _ in range(2))
        out, lse = _launches("flash_fwd/bf16", lambda: TA.flash_fwd(q, k, v))
        want, want_lse = TA.flash_fwd_plain(q, k, v)
        assert lse.dtype == torch.float32
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
        draws.append((out, want, TA._attention_plain(
            q.float(), k.float(), v.float())[0]))
    assert_attn_bf16_close(draws)


@pytest.mark.cuda
def test_flash_bf16_kernels_refuse_a_non_positive_scale(cuda):
    """The bf16 kernels take the row max over the raw scores, which needs a
    positive scale: the wrappers raise before a launch."""
    gen = _seeded(cuda, "flash_bf16_kernels_refuse_a_non_positive_scale")
    q, k, v = (torch.randn(1, 2, 64, 24, device=cuda, generator=gen).to(BF)
               for _ in range(3))
    with pytest.raises(ValueError, match="positive scale"):
        TA.flash_fwd(q, k, v, -0.2)
    with pytest.raises(ValueError, match="positive scale"):
        TA.flash2_fwd(q, k, v, k, v, 0.5, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 24, 40, 80, 128, 160, 256])
@pytest.mark.parametrize("lens,kv_batch", [((64, 64), 2), ((128, 256), 1),
                                           ((1024, 1024), 2)])
def test_flash_probe_bf16_kernels_match_plain(cuda, D, lens, kv_batch):
    """P1 and P2 at bf16 against their plain bf16 versions: the RMS of the
    difference at most 0.1 of bf16's own error (the plain bf16 version
    against the plain version in f32 on the same values), K3/bf16's limit.
    K/V expanded from one image when kv_batch is 1 (stride 0)."""
    gen = _seeded(cuda, (D, lens, kv_batch))
    from afldm_tpu_torch.ops import flash_probes as P
    q, k, v = (t.to(BF) for t in _probe_inputs(cuda, gen, 2, 3, *lens, D,
                                                 kv_batch))
    for name in ("flash_probe_dots", "flash_probe_stream"):
        plain = getattr(P, f"{name}_plain")
        got = _launches(f"{name}/bf16", lambda: getattr(P, name)(q, k, v))
        assert got.dtype == BF and got.shape == q.shape
        want = plain(q, k, v)
        gap = _rms(want.float() - plain(q.float(), k.float(), v.float()))
        assert _rms(got.float() - want.float()) <= 0.1 * gap, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sliced", "misaligned", "expanded"])
def test_flash_probes_bf16_scalar_and_strided_staging(cuda, kind):
    """P1 and P2 at bf16 through the scalar copy and through stride 0, to
    the criterion above."""
    gen = _seeded(cuda, kind)
    from afldm_tpu_torch.ops import flash_probes as P

    def view():  # (2, 2, 128, 40) bf16 laid out as ``kind``
        if kind == "sliced":  # row stride 43, not a multiple of 8
            return torch.randn(2, 2, 128, 43, device=cuda,
                               generator=gen).to(BF)[..., :40]
        if kind == "expanded":
            return (torch.randn(1, 2, 128, 40, device=cuda,
                                generator=gen).to(BF)
                    .expand(2, -1, -1, -1))
        flat = torch.randn(2 * 2 * 128 * 40 + 1, device=cuda,
                           generator=gen).to(BF)
        t = flat[1:].view(2, 2, 128, 40)  # 2 bytes past 16
        assert t.data_ptr() % 16 == 2
        return t
    q, k, v = (view() for _ in range(3))
    for name in ("flash_probe_dots", "flash_probe_stream"):
        plain = getattr(P, f"{name}_plain")
        got = _launches(f"{name}/bf16", lambda: getattr(P, name)(q, k, v))
        want = plain(q, k, v)
        gap = _rms(want.float() - plain(q.float(), k.float(), v.float()))
        assert _rms(got.float() - want.float()) <= 0.1 * gap, name


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["per frame", 0.0, 0.3, 1.0])
@pytest.mark.parametrize("n,h,L,d,n_kv", [
    (17, 8, 1024, 24, 1), (3, 32, 4, 24, 1), (2, 2, 100, 40, 1),
    (2, 2, 300, 160, 2), (3, 2, 200, 80, 3)])
def test_flash2_bf16_matches_plain(cuda, n, h, L, d, n_kv, alpha):
    """K6/bf16 against ``flash2_fwd_plain`` (two online states, one
    rounding after the blend) on ATTN_DRAWS seeded draws, one alpha per
    frame or a scalar; K/V expanded from one image (stride 0) where n_kv
    is 1."""
    g = _seeded(cuda, (n, h, L, d, n_kv, alpha))
    a = (torch.linspace(0, 1, n, device=cuda)[:, None, None]
         if alpha == "per frame" else alpha)
    draws = []
    for _ in range(ATTN_DRAWS):
        q = torch.randn(n, h, L, d, device=cuda, generator=g).to(BF)
        kv = [torch.randn(n_kv, h, L, d, device=cuda, generator=g).to(BF)
              .expand(n, -1, -1, -1) for _ in range(4)]
        got = _launches("flash2_fwd/bf16", lambda: TA.flash2_fwd(q, *kv, a))
        draws.append((got, TA.flash2_fwd_plain(q, *kv, a),
                      TA.sdpa2_eager(q.float(), *(t.float() for t in kv), a)))
    assert_attn_bf16_close(draws)
