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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32, 32), (2, 64, 4, 4),
                                   (1, 4, 64, 64), (1, 4, 12, 20),
                                   (3, 5, 8, 8), (2, 6, 16, 16)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "mish",
                                 "leaky_relu", "tanh"])
def test_plane_bwd_kernel_matches_plain(cuda, shape, act):
    x = torch.randn(shape, device=cuda)
    g = torch.randn(shape, device=cuda)
    got = _launches("filtered_act_plane_bwd",
                    lambda: TF.filtered_act_plane_bwd(x, g, act))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, act), atol=1e-4,
        rtol=1e-4)


@pytest.mark.cuda
def test_plane_function_backward_launches_kernel(cuda):
    """autograd through the dispatcher reaches the plane backward kernel at
    plane sizes and the banded one (K2) at 96-512 px."""
    x = torch.randn(2, 8, 16, 16, device=cuda, requires_grad=True)
    g = torch.randn(2, 8, 16, 16, device=cuda)
    y = TF.filtered_act_fused(x, "silu")
    _launches("filtered_act_plane_bwd", lambda: y.backward(g))
    torch.testing.assert_close(
        x.grad, TF.filtered_act_plane_bwd_plain(x.detach(), g, "silu"),
        atol=1e-4, rtol=1e-4)
    xb = torch.randn(1, 2, 128, 128, device=cuda, requires_grad=True)
    gb = torch.randn(1, 2, 128, 128, device=cuda)
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
    """K2 with its accumulator in shared memory (up to 128x128) and in the
    block's dx plane (above), bands of 32, 16 and 8 rows."""
    x = torch.randn(shape, device=cuda)
    g = torch.randn(shape, device=cuda)
    got = _launches("filtered_act_banded_bwd",
                    lambda: TF.filtered_act_banded_bwd(x, g, act))
    torch.testing.assert_close(
        got, TF.filtered_act_plane_bwd_plain(x, g, act), atol=1e-4,
        rtol=1e-4)


def _attn_inputs(cuda, B, H, Lq, Lk, D, kv_batch):
    q = torch.randn(B, H, Lq, D, device=cuda)
    k, v = (torch.randn(kv_batch, H, Lk, D, device=cuda)
            .expand(B, -1, -1, -1) for _ in range(2))
    out, lse = TA.flash_fwd(q, k, v)
    do = torch.randn(B, H, Lq, D, device=cuda)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (B, H, Lq, Lk, D, K/V batch)
    (2, 3, 64, 64, 24, 2), (1, 2, 37, 50, 24, 1), (2, 1, 4, 4, 24, 2),
    (2, 4, 16, 16, 24, 1), (1, 1, 130, 70, 8, 1), (1, 2, 65, 129, 100, 1),
    (1, 1, 64, 64, 256, 1), (2, 2, 1024, 1024, 24, 1)])
def test_flash_bwd_kernels_match_plain(cuda, shape):
    B, H, Lq, Lk, D, nkv = shape
    q, k, v, out, lse, do = _attn_inputs(cuda, B, H, Lq, Lk, D, nkv)
    delta = TA._delta(do, out)
    dq = _launches("flash_bwd_dq",
                   lambda: TA.flash_bwd_dq(q, k, v, do, lse, delta))
    dk, dv = _launches("flash_bwd_dkv",
                       lambda: TA.flash_bwd_dkv(q, k, v, do, lse, delta))
    want = TA._attention_bwd_plain(q, k, v, out, lse, do)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_function_expanded_kv_and_strided_do(cuda):
    """Through autograd: q a transposed view, K/V expanded from one image
    (stride 0) whose gradients sum over the batch, dO strided (it arrives
    through the head transpose)."""
    q0 = torch.randn(4, 64, 2, 24, device=cuda, requires_grad=True)
    k0 = torch.randn(1, 2, 64, 24, device=cuda, requires_grad=True)
    v0 = torch.randn(1, 2, 64, 24, device=cuda, requires_grad=True)
    g = torch.randn(4, 64, 2, 24, device=cuda)

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
