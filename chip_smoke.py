#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``afldm_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # 50 DDIM steps, 16 shifts, 4 + 8 steps
    python3 chip_smoke.py --steps 10 --train_steps 3 --vae_steps 8 \
        --interp_steps 10 --sd_frames 5 --sd_steps 4 --video_frames 2 \
        --video_steps 4 --normal_shifts 4 --trainer_steps 2 \
        --eq_samples 2 --eq_steps 4

Phases, each of which fails the run:
1. build every CUDA kernel from ``afldm_tpu_torch/kernels/csrc`` (nvcc, one
   process per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (and the banded pair at sizes outside the old
   96-512 px window: 80 px, 32x128 and 1024 px planes; the flash backward
   at the SD UNet's head dims 40, 80 and 160, and at its cross-attention
   over 77 text tokens), and time kernel, plain
   version, the library call where one exists, and the bound (the larger
   of FLOPs / 67 TFLOP/s f32 and bytes / 3.35 TB/s); the flash backward's
   and the banded backward's sums are logged over their first three
   shapes and over all, the plane kernel's over its first five and over
   all, the plane backward's over its first two and over all, both with
   their launch plans (planes a block, micro-tiles, threads and shared
   bytes a block) at each shape, and the banded forward's and
   backward's chunk plans (chunks, planes a chunk, the block tile of each
   of their four and six GEMM launches);
3. run the tiny pipeline on the card and on the CPU with the same weights
   and compare (the end-to-end reference check of serving);
4. the serving path at full width (256.4M-parameter UNet, AF-VAE at
   256 px, random weights from seed 0): ``shift_equivariance_eval`` with
   16 shifts in one LOAD pass, with every launch counter set to 0 just
   before and read just after; every kernel of that path must have launched
   and all PSNRs must be finite;
5. one step of the tiny LDM trainer on the card and on the CPU with the
   same weights and draws: loss and every gradient compared (the
   end-to-end reference check of training);
6. the training path at full width: ``configs/ldm/train_unet_ffhq.json`` as
   it stands (batch 16, 256 px, gradient checkpointing, EMA, eps-MSE +
   CFA shift loss), synthetic data, random weights from seed 0, counters
   set to 0 just before the steps and read just after; every loss must be
   finite, the parameters must have moved and all six kernels launched;
7. one step of a tiny AF-VAE trainer (128 px, so that its top level takes
   the banded kernels) with a discriminator, on the card and on the CPU
   with the same weights, images and draws: the generator's losses and
   every VAE gradient, then the discriminator's loss and every
   discriminator gradient, compared as in 5;
8. the AF-VAE training path at full width:
   ``configs/vae/train_afvae_imagenet.json`` as it stands (the AF-VAE of
   ``model_afvae.json`` at 256 px, batch 4, shift loss, no GAN, gradient
   accumulation 2), synthetic data, random weights from seed 0,
   ``--vae_steps`` micro-steps with the counters set to 0 just before and
   read just after; every loss must be finite, every VAE parameter must
   have moved and the filtered-activation kernels (K1 and K2, each a
   chain of the tiled GEMM at the 128 px level, K5, K5b) must have
   launched;
9. a tiny FFHQ interp denoise (two DDIM inversions, two STORE passes, one
   interp pass of 3 frames with one alpha each) on the card and on the CPU
   with the same weights and latents: latents compared;
10. the FFHQ interp path at full width (``configs/ldm/model_unet.json``,
    the AF-VAE at 256 px, random weights from seed 0): invert two
    latents, STORE both, interp-denoise 17 frames with ``--interp_steps``
    (default 20) DDIM steps and decode them, counters set to 0 just before
    and read just after; K6, K3 and K5 must have launched and every output
    must be finite;
11. the tiny SD image interpolation (64 px, 3 frames, 4 steps) on the card
    and on the CPU with the same weights, flows and draws: frames compared;
12. the SD image interpolation at full width
    (``UNet2DConditionConfig(alias_free=True)``: SD-1.5 widths, 64x64
    latents; the AF-VAE of ``model_afvae.json`` at 512 px), random weights
    from seed 0, the Lucas-Kanade flow of the CLI's synthetic pair, counters
    set to 0 just before and read just after: ``--sd_frames`` frames
    (default 17) with ``--sd_steps`` DDIM steps (default 10, not the CLI's
    50, to keep this script within a few minutes; the 50-step run is the
    CLI's, ``python -m afldm_tpu_torch.scripts.image_interpolation``);
    K5, K1 and K3 must have launched and every frame must be finite;
13. the flash sweep (``scripts.bench_flash_sweep.main`` at its defaults,
    ``--sweep_iters`` chained calls): K3 and K6 at the flagship shapes and
    the attribution probes P1 and P2, counters set to 0 just before and
    read just after; every row finite, all four kernels launched;
14. the headline (``scripts.bench.measure``): the full-width FFHQ UNet's
    50-step DDIM denoise at batch 1, best of 3, steps/s printed, counters
    set to 0 just before and read just after; K5 and K3 launched;
15. a tiny ``SamplerService`` on the card and on the CPU with the same
    weights and seeds (``_draw`` latents): images compared;
16. the full-width service (the FFHQ pipeline): 4 concurrent single-image
    requests at ``--serve_steps`` DDIM steps (default 20), counters set to
    0 just before and read just after; the requests must share passes
    (fewer batches than requests), every image must be finite and K5, K1
    and K3 must have launched; each request's latency printed;
17. the tiny latent-I2SB SR protocol (``scripts.shift_ldm_sr --tiny``) on
    the card and on the CPU with the same weights: PSNRs compared;
18. the SR protocol at full width (``configs/ldm/model_unet.json``, the
    AF-VAE at 256 px, the I2SB scheduler of ``configs/sr``): degrade the
    synthetic input 4x, encode, ``shift_equivariance_eval`` with
    ``--sr_steps`` (default 20) and 16 shifts, counters set to 0 just
    before and read just after; K5, K1 and K3 launched, all PSNRs finite;
19. the tiny video editing of the CLI (64 px, 2 frames, 2 DDIM steps at
    strength 1) on the card and on the CPU with the same weights, noise
    and stub prompt embeddings (distinct for the prompt and the negative
    prompt, so that CFG acts), as SDEdit with ``guidance_rescale`` 0.7 and
    as DDIM inversion: frames compared;
20. video editing at full width, as ``scripts.video_editing`` builds it
    (SD-1.5 widths, 64x64 latents, the AF-VAE at 512 px, SD 1.5's DDIM,
    random weights from seed 0): ``--video_frames`` synthetic frames
    (default 8, the CLI's) edited by SDEdit at strength 0.7 with
    ``--video_steps`` DDIM steps (default 10, so 7 denoise steps) and
    guidance 7.5: the STORE pass of frame 0, the LOAD pass of all frames
    at CFG batch 2N, the decode; counters set to 0 just before and read
    just after; K5, K1 and K3 launched, every frame finite;
21. the tiny normal estimation of the CLI (64 px, 2 shifts) on the card and
    on the CPU with the same weights, the ControlNet's zero-started convs
    drawn non-zero: YOSO, and 2 DDIM steps with guidance 2.0 and guess
    mode; normals and PSNRs compared;
22. normal estimation at full width, as ``scripts.shift_normal_estimation``
    builds it (the SD UNet and the latent ControlNet of
    ``ControlNetConfig.from_unet_config``, the AF-VAE at 512 px, random
    weights from seed 0, the ControlNet's convs started at zero): YOSO over
    1 + ``--normal_shifts`` (default 16) shifted latents in one batch,
    counters set to 0 just before and read just after; K5, K1 and K3
    launched, all normals and PSNRs finite;
23. two steps of the tiny I2SB (bridge noise, CFA), SD text (a tiny
    random CLIP, prompt dropout 0.5) and normal-ControlNet trainers (64 px,
    batch 2) on the card and on the CPU with the same weights, images and
    draws: each step's losses and every gradient of the trained modules,
    compared as in 5;
24. ViT-L/14's CLIP text transformer from seed 0 on the card and on the
    CPU: hidden states within 1e-4 of their scale;
25. the tiny SD text trainer's ``save_pipeline``, ``load_sd_components``
    and one YOSO normal estimation on the card: the weights come back bit
    for bit and the normals agree with the in-memory modules' within
    1e-5;
26. the three trainers at full width, ``--trainer_steps`` steps each
    (default 3), counters set to 0 just before and read just after: I2SB
    as ``configs/sr/train_i2sb_imagenet.json`` stands (the FFHQ UNet,
    batch 16 at 256 px, CFA shift loss; synthetic data, random weights);
    SD text and the normal ControlNet at the JAX defaults (SD-1.5 widths,
    512 px, batch 1; one host draw of the UNet and the AF-VAE shared by
    both; SD text with ViT-L/14's random CLIP, the ControlNet of
    ``ControlNetConfig.from_unet_config``): every loss finite, every
    trained tensor with a non-zero gradient moved, K5, K1, K3, K5b, K4a
    and K4b launched, and in the SD trainers K4b over the 77 text tokens;
27. the shift toolkit on a 256 px image on the card and on the CPU: the
    upfirdn2d family, the lanczos, fourier and fourier_crop shifts, the
    fractional rotation and pseudo-rotation, ``forward_flow_warp``,
    ``flow_warp_with_occ_bg`` and ``ImageDownsampler("bilinear")``; max
    |d| of each within its limit, masks equal;
28. the StyleGAN-3 EQ metrics at full width, as
    ``scripts.eval_equivariance`` runs them (the FFHQ UNet and AF-VAE at
    256 px, random weights from seed 0): ``--eq_samples`` samples (default
    4) of ``--eq_steps`` DDIM steps (default 10), each a STORE generation
    and two translated LOAD generations, counters set to 0 just before
    and read just after; EQ-T and EQ-T_frac finite, K5, K1 and K3
    launched;
29. the shift protocol on that pipeline, 4 shifts at 10 steps, batched
    (one LOAD pass) and with ``batch_shifts=False`` (one pass a shift) from
    the same latent, counters set to 0 just before the pair and read just
    after: per-shift PSNRs within 0.01 dB of each other, K5, K1 and K3
    launched;
30. the bf16 tensor-core variants of K5, K1, K5b and K2 at the reduced
    precision levels 'high' and 'default', at every shape of their
    KERNELS rows up to 512 px (above it the f32 kernels run at every
    level), against their plain versions at the same level on the card:
    RMS(kernel - plain) at most LEVEL_RMS_RATIO of the level's own RMS
    error (plain at the level against plain at 'highest'), max |kernel -
    plain| at most the level's own max error; each timed beside its
    plain version and its bound (1 or 3 passes at the bf16 dense tensor
    peak, or the bytes), each variant at 'high' also beside its TwoSum
    floor (``twosum_floor_ms``) and K5b:default beside its byte floor
    (``byte_floor_ms``), each shape's launch plan logged (K5's and K5b's
    persistent grid, blocks an SM, planes an iteration and shared bytes),
    a row of its own in the kernels line; and the
    plain resamplers (``upsample_rfft`` / ``downsample_rfft``, whose
    products split with ``torch.matmul`` at a reduced level) timed at each
    level at the AF-VAE's shapes;
31. ``scripts.eval_af_precision`` at full width (the FFHQ UNet and AF-VAE
    at 256 px, random weights from seed 0): ``--afp_steps`` DDIM steps
    (default 20) and ``--afp_shifts`` shifts (default 4) at 'highest',
    'high' and 'default', each on a fresh pipeline with the counters set to
    0 just before and read just after: wall, peak memory, per-shift PSNRs
    and the dB deltas logged (random weights: not gated), PSNRs finite,
    and at each level K5 and K1 launched in that level's variant;
32. the AF-VAE trainer of ``configs/vae/train_afvae_imagenet.json`` from
    one start at 'highest', 'high' and 'default', ``--afp_vae_steps``
    micro-steps each (default 4), counters set to 0 just before and read
    just after: losses finite, their relative gaps to 'highest' logged,
    and at each reduced level all four of its variants (K5, K1, K5b, K2)
    launched;
33. the bfloat16-activation variants of K5 and K1 (at 'highest', 'high'
    and 'default'), K3 and K6, at every shape of their KERNELS rows
    (reduced levels up to 512 px), against their plain versions on the
    card: K5 and K1 no element more than one bf16 ulp of itself off
    beyond the f32 kernel's atol, at most 0.1 % of the elements
    different; K3 and K6 (the TPU kernels' online softmax, their plain
    versions ``flash_fwd_plain`` and ``flash2_fwd_plain`` at the kernels'
    key tile) the RMS of (kernel - plain) at most 0.1 of the RMS of (plain
    - the f32 plain on the same values), no element more than 4 bf16 ulps
    of the output's largest magnitude off, K3's lse within 1e-5 (and
    1e-5 of itself); each timed
    beside its plain version, its f32 kernel on the same values, the
    library call at bf16 (K3: scaled_dot_product_attention; K6: two of
    them and the blend) and its bound, a row of its own in the kernels
    line; and so the backward variants for bf16 training: K5b and K2 on
    bf16 x and g at every level (K5b's seven shapes, K2's five, the
    reduced levels up to 512 px) to K5's and K1's criteria at the
    backward's atol, K4a and K4b on bf16 q, k, v and dO at their twelve
    shapes (Lk = 77 and K/V expanded from one image among them) to K3's,
    K4b's library call SDPA's backward at bf16 (its time includes the
    reduction where its query walk splits); and the split K4b's reduction
    (``flash_bwd_dkv_reduce``) at the f32 partials of the shapes where it
    splits, bit-identical to its plain version (the same f32 sums in the
    same order), a row of its own;
34. the tiny pipeline at bf16 on the card and on the CPU (4 steps, 4
    shifts): images within BF16_TINY_RATIO of the CPU's own bf16 - f32
    RMS error, PSNRs within BF16_TINY_DPSNR dB; then the FFHQ shift
    protocol at bf16 and full width through ``scripts.shift_ldm_ffhq
    --bf16`` (16 shifts, ``--steps``, the latent of phase 4), again with
    ``set_af_bf16_split(True)``, and with ``--af_precision high`` and
    ``default`` (the
    levels' bf16 variants), counters set to 0 just before each and read
    just after: PSNRs finite, their difference from phase 4's logged,
    wall and peak memory logged, and the filtered activations' launches
    (K5 and K1 in the run's bf16 variant) equal to the count reckoned from
    the configs, K3's bf16 variant launched;
35. the tiny FFHQ interp at bf16 on the card and on the CPU (3 frames, 4
    steps), as in 34; then the FFHQ interp of phase 10 on a bf16 pipeline
    at ``--bf16_interp_steps`` (default 10), counters set to 0 just before
    and read just after: images finite, K5/bf16 and K1/bf16 as reckoned,
    K3/bf16 and K6/bf16 launched;
36. one step of the tiny LDM (64 px), AF-VAE (128 px, with the
    discriminator) and I2SB, SD text and normal-ControlNet trainers at
    ``mixed_precision="bf16"`` on the card and on the CPU with the same
    weights, images and draws, and at f32 on the CPU: the losses and the
    trained gradients within BF16_TINY_RATIO of the CPU's own bf16 - f32
    gap (over all tensors; each tensor within twice that), a loss's gap
    floored at the spread of its CPU bf16 value over the CPU's thread
    counts, the bf16 backward kernels launched and no f32 one; the
    AF-VAE's two gradient norms that form its GAN weight ``d_weight``
    (``adaptive_norms``) each held apart to the same criterion as a loss,
    at its own floor NORM_FLOOR (``--control`` runs this phase alone with
    a fault planted, which it must fail);
37. the five trainers at bf16 and full width, beside their f32 runs of
    phases 6, 8 and 26: the JAX package's flagship LDM run
    (``configs/ldm/train_unet_ffhq.json`` at ``mixed_precision="bf16"``:
    batch 16 at 256 px, gradient checkpointing, shift loss, CFA, EMA),
    the AF-VAE trainer, and I2SB, SD text and the normal ControlNet as in
    26, as many steps as their f32 runs, counters set to 0 just before
    each and read just after: losses finite, the parameters moved as in
    the f32 runs, the bf16 backward launches (K5b, K2, K4a, K4b) equal to
    the count reckoned from the configs, no f32 backward kernel launched;
    the median step and the peak memory logged beside the f32 run's, and
    their ratios;
38. the attribution probes P1 and P2 at bf16 at their KERNELS shapes
    against their plain bf16 versions on the card: the RMS of (kernel -
    plain) at most BF16_FLASH_RATIO of the RMS of (plain - the f32 plain on
    the same values), the largest difference in bf16 ulps logged; each
    timed beside its plain version, its f32 kernel on the same values, the
    library call (P1: two bf16 matmuls; P2: none) and its bound, a row of
    its own in the kernels line; then the flash sweep at bf16
    (``scripts.bench_flash_sweep --dtype bf16`` at its full shapes),
    counters set to 0 just before and read just after: every row finite,
    K3, K6, P1 and P2 launched in their bf16 variants;
39. the bench scripts ``bench_attention``, ``bench_filtered_act``,
    ``bench_sdpa2``, ``bench_flash_bwd_sweep``, ``bench_train``,
    ``roofline_denoise``, ``bench_interp_denoise``, ``bench_pipelines``
    and ``run_all_benchmarks`` through their ``main(argv)`` at a small
    configuration (BENCH_SCRIPTS), counters set to 0 just before each and
    read just after: every number each returns finite, the kernels it
    times launched.

The second-to-last line is the kernels JSON (``launches``: the sum over the
full-width runs of phases 4, 6, 8, 10, 12, 13, 14, 16, 18, 20, 22, 26, 28,
29, 31, 32, 34, 35, 37 and 38's sweep), the last the device JSON. Exits
non-zero without a GPU or without the package beside it.
"""

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 without tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3

# the K4 pair's shapes (images, heads, L, D, K/V images). The first three
# are the kernel table's yardstick (``base_shapes``: their sums are logged
# apart, to compare with commits that timed only them): the training
# step's pass 1 (K/V per image) at 32 px and 2 px (pass 2, K/V from the
# stored maps of the same batch, has the same shapes) and one case with
# K/V expanded from one image (stride 0)
FLASH_BWD_SHAPES = [
    (16, 8, 1024, 24, 16), (16, 32, 4, 24, 16), (16, 8, 1024, 24, 1),
    # the training step's other attention levels, run every step: 16 px
    # and 8 px with 16 heads, 4 px with 32
    (16, 16, 256, 24, 16), (16, 16, 64, 24, 16), (16, 32, 16, 24, 16),
    # one shape at each larger DP, the SD UNet's head dims 40, 80 and 160
    # at its 64, 32 and 16 px levels (batch 2)
    (2, 8, 4096, 40, 2), (2, 8, 1024, 80, 2), (2, 8, 256, 160, 2),
    # the SD trainers' cross-attention over 77 text tokens at those levels
    # (batch 1; the sixth element is Lk)
    (1, 8, 4096, 40, 1, 77), (1, 8, 1024, 80, 1, 77), (1, 8, 256, 160, 1, 77)]

KERNELS = {
    "filtered_act_plane": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:175",
        # the FFHQ UNet at 32 and 4 px, the AF-VAE's 64 px level, the SD
        # UNet's interp pass at 64 and 8 px (``base_shapes``: their sums
        # are logged apart, to compare with commits that timed only them)
        shapes=[(16, 192, 32, 32), (16, 1536, 4, 4), (16, 512, 64, 64),
                (17, 320, 64, 64), (17, 1280, 8, 8),
                # the FFHQ UNet's 16 px level in the protocol's batch of 16
                # shifts
                (16, 384, 16, 16),
                # the headline's batch-1 32 px level: 192 planes, a grid
                # short of a wave if planes were packed
                (1, 192, 32, 32)],
        base_shapes=5),
    "filtered_act_banded": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:228",
        # the AF-VAE at 256 px (128 px level) and at 512 px (256 px level);
        # the window beyond 96-512 px: an AF-VAE at 320 px (80 px level), a
        # mixed 32x128 plane, a 1024 px plane
        shapes=[(16, 256, 128, 128), (16, 512, 128, 128),
                (2, 256, 256, 256), (4, 256, 80, 80), (1, 64, 32, 128),
                (1, 16, 1024, 1024)]),
    "flash_fwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="afldm_tpu/ops/attention.py:59",
        # (images, heads, L, D, K/V images[, Lk]): the FFHQ LOAD pass at
        # 32 px and 2 px; the SD interp pass's self-attention at 64, 32 and
        # 16 px and its cross-attention over 77 text tokens at 64 px
        shapes=[(16, 8, 1024, 24, 1), (16, 32, 4, 24, 1),
                (17, 8, 4096, 40, 1), (17, 8, 1024, 80, 1),
                (17, 8, 256, 160, 1), (17, 8, 4096, 40, 1, 77)]),
    "filtered_act_plane_bwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:328",
        # the LDM training step's 32 px and 4 px levels (``base_shapes``:
        # their sums are logged apart, to compare with commits that timed
        # only them); the AF-VAE training step's at batch 4: the 64 px
        # level's 512- and 256-channel planes, the 32 px level's; the SD
        # trainers' UNet at batch 1: its 64 px and 8 px levels
        shapes=[(16, 192, 32, 32), (16, 1536, 4, 4), (4, 512, 64, 64),
                (4, 256, 64, 64), (4, 512, 32, 32), (1, 320, 64, 64),
                (1, 1280, 8, 8)],
        base_shapes=2),
    "flash_bwd_dq": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="afldm_tpu/ops/attention.py:142",
        shapes=FLASH_BWD_SHAPES, base_shapes=3),
    "flash_bwd_dkv": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="afldm_tpu/ops/attention.py:168",
        shapes=FLASH_BWD_SHAPES, base_shapes=3),
    "filtered_act_banded_bwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/filtered_act.cu",
        replaces="afldm_tpu/ops/pallas_kernels.py:261",
        # the AF-VAE's 128 px level at batch 4: the encoder's first resnet
        # (128 channels), the 256-channel resnets, the decoder's first
        # resnet after the 512-channel upsampler (``base_shapes``: their
        # sums are the kernel table's yardstick, logged apart); an AF-VAE at
        # 320 px (80 px level, outside the old 96-512 px window); a 1024 px
        # plane, which the band walk before the GEMM chain ran one block a
        # plane
        shapes=[(4, 128, 128, 128), (4, 256, 128, 128), (4, 512, 128, 128),
                (4, 256, 80, 80), (1, 16, 1024, 1024)],
        base_shapes=3),
    "flash2_fwd": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash2_fwd.cu",
        replaces="afldm_tpu/ops/attention.py:302",
        # the FFHQ interp pass of 17 frames at 32 px and 2 px, both K/V sets
        # expanded from one stored map (stride 0), one alpha per frame
        shapes=[(17, 8, 1024, 24, 1), (17, 32, 4, 24, 1)]),
    "flash_probe_dots": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_probe.cu",
        replaces="scripts/bench_flash_sweep.py:129",
        # the sweep's probe shape, and the FFHQ UNet's top attention at
        # batch 16; K/V per image
        shapes=[(8, 8, 4096, 80, 8), (16, 8, 1024, 24, 16)]),
    "flash_probe_stream": dict(
        route="cuda", source="afldm_tpu_torch/kernels/csrc/flash_probe.cu",
        replaces="scripts/bench_flash_sweep.py:147",
        shapes=[(8, 8, 4096, 80, 8), (16, 8, 1024, 24, 16)]),
}
# a kernel agrees with its plain version when |got - want| <= ATOL + RTOL|want|
# (f32 sums in another order: ~1e-6 relative; the backwards chain six
# products or sum over up to 1024 rows)
TOL = {"filtered_act_plane": (3e-5, 1e-4), "filtered_act_banded": (3e-5, 1e-4),
       "flash_fwd": (2e-5, 1e-4), "filtered_act_plane_bwd": (1e-4, 1e-4),
       "flash_bwd_dq": (1e-4, 1e-4), "flash_bwd_dkv": (1e-4, 1e-4),
       "filtered_act_banded_bwd": (1e-4, 1e-4), "flash2_fwd": (2e-5, 1e-4)}
# the probes agree when max |got - want| <= REL_TOL * max |want|: nothing
# normalises P1's values, which grow as sqrt(L·D); P2 adds Lk/64 tiles into
# one accumulator where its plain version multiplies q once
REL_TOL = {"flash_probe_dots": 2e-5, "flash_probe_stream": 1e-5}
# card vs CPU for one tiny training step: the loss within LOSS_RTOL of the
# CPU's; each gradient within GRAD_RTOL of its tensor's max abs, with that
# scale floored at GRAD_FLOOR of the largest gradient: the attention's
# to_k bias has a gradient of zero in exact arithmetic (softmax ignores a
# shift of every key), so both devices compute rounding noise there
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-4
# the discriminator's floor: the biases of its convs that an instance norm
# follows also have a gradient of zero in exact arithmetic (the norm
# removes each channel's mean)
DISC_GRAD_FLOOR = 1e-3


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def filter_pair_flops(h, w):
    """FLOPs of one separable 2× filter pair on an h×w plane, an upsample
    (h×w to 2h×2w) or a decimation back, in its cheaper order: H side first
    costs 4h²w + 8hw², W side first 8h²w + 4hw² (12S³ either way square)."""
    return min(4 * h * h * w + 8 * h * w * w, 8 * h * h * w + 4 * h * w * w)


def filtered_act_work(shape):
    """FLOPs of the forward per plane, its upsample and its decimation each
    in the cheaper order (2·filter_pair_flops, = 24S³ square), and bytes: x
    read once, out written once, the four operators read once."""
    n, c, h, w = shape
    flops = n * c * 2 * filter_pair_flops(h, w)
    nbytes = 4 * (2 * n * c * h * w + 4 * h * h + 4 * w * w)
    return flops, nbytes


def _flash_dims(shape):
    """(images, heads, Lq, Lk, D, K/V images) of a flash shape tuple
    (images, heads, L, D, K/V images[, Lk]); Lk defaults to L."""
    n, heads, L, d, n_kv = shape[:5]
    return n, heads, L, (shape[5] if len(shape) > 5 else L), d, n_kv


def flash_work(shape):
    """FLOPs of q·kᵀ and p·v (4·B·Lq·Lk·D, D unpadded); bytes: q, the
    unique K/V rows, out and lse, each once."""
    n, heads, Lq, Lk, d, n_kv = _flash_dims(shape)
    flops = 4 * n * heads * Lq * Lk * d
    nbytes = 4 * (2 * n * heads * Lq * d + 2 * n_kv * heads * Lk * d
                  + n * heads * Lq)
    return flops, nbytes


def flash2_work(shape):
    """FLOPs of both attentions (8·B·L²·D, D unpadded; the blend is
    negligible); bytes: q, the unique rows of the four K/V tensors, alpha
    and out, each once."""
    n, heads, L, _, d, n_kv = _flash_dims(shape)
    flops = 8 * n * heads * L * L * d
    nbytes = 4 * (2 * n * heads * L * d + 4 * n_kv * heads * L * d + n)
    return flops, nbytes


def probe_work(name, shape):
    """P1: q·kᵀ and s·v (4·B·L²·D, D unpadded); P2: the column sums of k
    and v and three adds per output (2·B·L·D + 3·B·L·D). Bytes: q, the
    unique K/V rows and out, each once."""
    n, heads, L, _, d, n_kv = _flash_dims(shape)
    nbytes = 4 * (2 * n * heads * L * d + 2 * n_kv * heads * L * d)
    if name == "flash_probe_dots":
        return 4 * n * heads * L * L * d, nbytes
    return 5 * n * heads * L * d, nbytes


def filtered_act_bwd_work(shape):
    """FLOPs of the VJP's three filter pairs per plane (the pre-activation
    U_h·x·U_wᵀ, D_hᵀ·g·D_w and U_hᵀ·m·U_w), each in the cheaper order
    (3·filter_pair_flops, = 36S³ square), and bytes: x and g read once, dx
    written once, the six operators read once."""
    n, c, h, w = shape
    flops = n * c * 3 * filter_pair_flops(h, w)
    nbytes = 4 * (3 * n * c * h * w + 6 * h * h + 6 * w * w)
    return flops, nbytes


def flash_bwd_work(name, shape):
    """dq: q·kᵀ, dO·vᵀ and ds·k (6·B·Lq·Lk·D); dkv adds dsᵀ·q and pᵀ·dO in
    place of ds·k (8·B·Lq·Lk·D). Bytes: q, dO, lse, delta and the unique
    K/V rows read once; dq, or dk and dv (dense per image), written
    once."""
    n, heads, Lq, Lk, d, n_kv = _flash_dims(shape)
    rows = n * heads * Lq
    reads = 2 * rows * d + 2 * rows + 2 * n_kv * heads * Lk * d
    if name == "flash_bwd_dq":
        return 6 * rows * Lk * d, 4 * (reads + rows * d)
    return 8 * rows * Lk * d, 4 * (reads + 2 * n * heads * Lk * d)


def _case(torch, name, shape, dev, g):
    """Inputs at ``shape`` and, for ``name``: the kernel's call, its plain
    version, the library call (or None) and the work."""
    import torch.nn.functional as F
    from afldm_tpu_torch.ops import attention as A
    from afldm_tpu_torch.ops import filtered_act as FA
    if name.startswith("filtered_act"):
        x = torch.randn(shape, device=dev, generator=g)
        fn = getattr(FA, name)
        if name.endswith("_bwd"):
            gr = torch.randn(shape, device=dev, generator=g)
            return (lambda: fn(x, gr, "silu"),
                    lambda: FA.filtered_act_plane_bwd_plain(x, gr, "silu"),
                    None, filtered_act_bwd_work(shape))
        return (lambda: fn(x, "silu"),
                lambda: FA.filtered_act_plain(x, "silu"), None,
                filtered_act_work(shape))
    n, heads, L, Lk, d, n_kv = _flash_dims(shape)
    q = torch.randn(n, heads, L, d, device=dev, generator=g)
    k, v = (torch.randn(n_kv, heads, Lk, d, device=dev,
                        generator=g).expand(n, -1, -1, -1)
            for _ in range(2))
    if name.startswith("flash_probe"):
        from afldm_tpu_torch.ops import flash_probes as P
        library = None
        if name == "flash_probe_dots":
            def library():  # the yardstick, in the probe's order
                return torch.matmul(torch.matmul(q, k.transpose(-1, -2)), v)
        return (lambda: getattr(P, name)(q, k, v),
                lambda: getattr(P, f"{name}_plain")(q, k, v), library,
                probe_work(name, shape))
    if name == "flash2_fwd":
        k1, v1 = (torch.randn(n_kv, heads, Lk, d, device=dev,
                              generator=g).expand(n, -1, -1, -1)
                  for _ in range(2))
        alpha = torch.linspace(0, 1, n, device=dev)[:, None, None]
        a4 = alpha[:, None]

        def library():  # the yardstick: two SDPA calls and the blend
            return ((1 - a4) * F.scaled_dot_product_attention(q, k, v)
                    + a4 * F.scaled_dot_product_attention(q, k1, v1))
        return (lambda: A.flash2_fwd(q, k, v, k1, v1, alpha),
                lambda: A.sdpa2_eager(q, k, v, k1, v1, alpha),
                library, flash2_work(shape))
    if name == "flash_fwd":
        return (lambda: A.flash_fwd(q, k, v),
                lambda: A._attention_plain(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v),
                flash_work(shape))
    out, lse = A.flash_fwd(q, k, v)
    do = torch.randn(n, heads, L, d, device=dev, generator=g)
    delta = A._delta(do, out)
    scale = 1.0 / d ** 0.5
    if name == "flash_bwd_dq":
        return (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta),
                lambda: A._bwd_dq_plain(q, k, v, do, lse, delta, scale),
                None, flash_bwd_work(name, shape))
    # the library yardstick of the K4 pair: autograd through SDPA, the
    # forward excluded
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl)
    return (lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: A._bwd_dkv_plain(q, k, v, do, lse, delta, scale),
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                        retain_graph=True),
            flash_bwd_work(name, shape))


def check_kernels(torch, report):
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    split = {k: {"operations": 0.0, "bytes": 0.0} for k in KERNELS}
    for name, spec in KERNELS.items():
        atol, rtol = TOL.get(name, (None, None))
        row = report[name]
        base = spec.get("base_shapes")
        for n_shape, shape in enumerate(spec["shapes"]):
            if n_shape == base:
                log_sums(name, row, f"the first {base} shapes")
            run, plain, library, work = _case(torch, name, shape, dev, g)
            got, want = run(), plain()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            if name in REL_TOL:
                scale = max(float(b.abs().max()) for b in want)
                good = err <= REL_TOL[name] * scale
                tol = f"limit {REL_TOL[name]} x max |want| {scale:.4g}"
            else:
                good = all(torch.allclose(a, b, atol=atol, rtol=rtol)
                           for a, b in zip(got, want))
                tol = f"atol {atol}, rtol {rtol}"
            del got, want
            t = time_ms(run)
            tp = time_ms(plain)
            tl = None if library is None else time_ms(library)
            b, by = bound_ms(*work)
            log(f"check {name} {shape}: max_abs_err {err:.3e} "
                f"({tol}) {'ok' if good else 'FAIL'}; "
                f"kernel {t:.4f} ms, plain {tp:.4f} ms, "
                f"library {'n/a' if tl is None else f'{tl:.4f} ms'}, "
                f"bound {b:.4f} ms ({by}-bound, {work[0] / 1e9:.3f} GFLOP, "
                f"{work[1] / 1e6:.3f} MB){launch_plan(name, shape)}")
            ok &= bool(good)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += t
            row["plain_ms"] += tp
            row["bound_ms"] += b
            split[name][by] += b
            if tl is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + tl
            del run, plain, library
            torch.cuda.empty_cache()
        # the row's bound is a sum over shapes: name what bounds most of it
        row["bound_by"] = max(split[name], key=split[name].get)
        if base is not None:
            log_sums(name, row, f"all {len(spec['shapes'])} shapes")
    return ok


def launch_plan(name, shape):
    """The launch plan at ``shape`` as a log suffix: the plane kernels'
    (planes a block, each product's micro-tile, four for K5 and six for
    K5b, threads and shared bytes a block) and the banded chains' (chunks,
    planes a chunk, each product's block tile, four for K1 and six for K2,
    scratch bytes); '' for the other kernels."""
    banded = ("filtered_act_banded", "filtered_act_banded_bwd")
    planes = ("filtered_act_plane", "filtered_act_plane_bwd")
    if name not in (*planes, *banded):
        return ""
    from afldm_tpu_torch.ops import filtered_act as FA
    n, c, h, w = shape
    if name in banded:
        products = (FA.banded_products if name == "filtered_act_banded"
                    else FA.banded_bwd_products)
        plan = FA.banded_plan(h, w, n * c, FA.BANDED_SCRATCH_BYTES,
                              products)
        sizes = sorted({ch.planes for ch in plan}, reverse=True)
        tiles = "; ".join(
            f"{ch.planes} planes: " + " ".join(str(t) for t in ch.tiles)
            for ch in {ch.planes: ch for ch in plan}.values())
        return (f"; plan {len(plan)} chunks of "
                f"{'/'.join(str(p) for p in sizes)} planes, tiles ({tiles}), "
                f"scratch {FA.banded_scratch_bytes(h, w, sizes[0])} B "
                f"(cap {FA.BANDED_SCRATCH_BYTES} B)")
    plan = (FA.plane_plan if name == "filtered_act_plane"
            else FA.plane_bwd_plan)(h, w, n * c)
    tiles = " ".join(f"{r}x{c}" for r, c in plan.tiles)
    return (f"; plan P {plan.planes_per_block}, tiles {tiles}, "
            f"{plan.threads} threads, smem {plan.smem_bytes} B")


def ptxas_lines(build_log):
    """(kernel, line) for each register or spill line of a build's
    ``-Xptxas -v`` output, the kernel's name demangled by ``c++filt``
    where the machine has it, without its arguments."""
    names, rows = [], []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            names.append(m.group(1))
        elif names and ("Used" in line or "spill" in line):
            rows.append((len(names) - 1, line.strip()))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines() or names
    except OSError:
        pass
    short = [n.replace("(anonymous namespace)::", "").removeprefix("void ")
             .rsplit("(", 1)[0] for n in names]
    return [(short[i], line) for i, line in rows]


def log_sums(name, row, over):
    lib = row["library_ms"]
    log(f"sum {name} over {over}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
        f"{row['bound_ms']:.4f} ms")


# -- phase 30: the reduced precision levels' bf16 variants -----------------

LEVELS = ("high", "default")
# the filtered activation's kernels with a bf16 variant a level, and the
# functions that name each: (kernel call, plain version, work)
LEVEL_KERNELS = ("filtered_act_plane", "filtered_act_banded",
                 "filtered_act_plane_bwd", "filtered_act_banded_bwd")
# a variant agrees with its plain version at its level when the RMS of
# their difference is at most this share of the level's own RMS error, and
# their max difference at most the level's own max error: the tensor core
# sums in another order than the plain version's exactly rounded sums, and
# a last-bit change of an f32 intermediate moves its bf16 split by one bf16
# ulp of lo ('high') or hi ('default') at a few elements, so the max is
# bounded loosely and the RMS tightly
LEVEL_RMS_RATIO = 0.25
LEVEL_PASSES = {"high": 3, "default": 1}
# the sources of the level variants: K5's and K5b's persistent walks, K1's
# and K2's two fused launches (their f32 kernels are filtered_act.cu's)
LEVEL_SOURCES = {
    "filtered_act_plane": "afldm_tpu_torch/kernels/csrc/filtered_plane_mma.cu",
    "filtered_act_plane_bwd":
        "afldm_tpu_torch/kernels/csrc/filtered_plane_mma.cu",
    "filtered_act_banded": "afldm_tpu_torch/kernels/csrc/filtered_banded_mma.cu",
    "filtered_act_banded_bwd":
        "afldm_tpu_torch/kernels/csrc/filtered_banded_mma.cu"}


def level_bound_ms(flops, nbytes, level):
    """The bound of a bf16 variant: its products' FLOPs times the level's
    passes at the bf16 dense tensor peak, or its bytes over HBM."""
    t_ops = LEVEL_PASSES[level] * flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def twosum_floor_ms(shape, name="filtered_act_plane"):
    """The TwoSum floor of K5:high (``name`` filtered_act_plane), K5b:high
    (filtered_act_plane_bwd), K1:high (filtered_act_banded) or K2:high
    (filtered_act_banded_bwd) at ``shape``: the TwoSum after every 16-deep
    step of its products (filtered_mma.cuh::add_two_sum, 7 FP32
    instructions an element a step, over the products as the kernel pads
    them to 16), at the FP32 instruction rate (PEAK_F32_FLOPS / 2: an FMA
    is two FLOPs). Each chain takes t = U_h·x (2H × W, depth H) and hi =
    t·U_wᵀ (2H × 2W, depth W) (K5b and K2 also v = D_hᵀ·g and ds = v·D_w,
    of the same shapes); K5 then t₂ = hi·D_wᵀ (2H × W, depth 2W) and
    D_h·t₂ (depth 2H), K5b s = m·U_w and dx = U_hᵀ·s of K5's shapes, K1
    lo = D_h·hi (H × 2W, depth 2H) and lo·D_wᵀ (depth 2W), K2 s = U_hᵀ·m
    and dx = s·U_w of K1's shapes."""
    n, c, h, w = shape
    p16 = [-(-s // 16) * 16 for s in (h, w, 2 * h, 2 * w)]
    h16, w16, h2, w2 = p16
    plane = name in ("filtered_act_plane", "filtered_act_plane_bwd")
    down = (h2 * w16 * w2 + h16 * w16 * h2 if plane
            else h16 * w2 * h2 + h16 * w16 * w2)
    up = (h2 * w16 * h16 + h2 * w2 * w16) * (
        2 if name.endswith("_bwd") else 1)
    steps = (up + down) // 16
    return 1e3 * 7 * steps * n * c / (PEAK_F32_FLOPS / 2)


def byte_floor_ms(shape):
    """The byte floor of K5b:default at ``shape``: x and g read and dx
    written once, f32, over the card's memory rate (the operators, read
    once a block from L2, left out)."""
    n, c, h, w = shape
    return 1e3 * 12 * n * c * h * w / PEAK_BYTES


def _level_case(torch, name, shape, dev, g):
    """(kernel call, plain version at a level, work) of a level row."""
    from afldm_tpu_torch.ops import filtered_act as FA
    x = torch.randn(shape, device=dev, generator=g)
    fn = getattr(FA, name)
    plain = getattr(FA, f"{name}_plain")
    if name.endswith("_bwd"):
        gr = torch.randn(shape, device=dev, generator=g)
        return (lambda: fn(x, gr, "silu"),
                lambda level: plain(x, gr, "silu", level),
                filtered_act_bwd_work(shape))
    return (lambda: fn(x, "silu"), lambda level: plain(x, "silu", level),
            filtered_act_work(shape))


def level_launch_plan(name, shape, level="high"):
    """The bf16 variant's launch plan at ``shape`` and ``level`` (an f32
    x) as a log suffix: K5's persistent grid, blocks an SM, planes an
    iteration and shared bytes; K5b's the same and whether its operators
    are resident or staged a phase at a time;
    K1's and K2's chunks, planes a chunk, the strip rows of their up and
    down launches (their blocks and shared bytes) and the hi (K2: m)
    pieces' scratch bytes."""
    from afldm_tpu_torch.ops import filtered_act as FA
    n, c, h, w = shape
    if name == "filtered_act_plane":
        plan = FA.plane_mma_plan(h, w, n * c, level)
        return (f"; plan grid {plan.grid} ({plan.per_sm} an SM), P "
                f"{plan.planes} an iteration, smem {plan.smem_bytes} B")
    if name == "filtered_act_plane_bwd":
        plan = FA.plane_mma_bwd_plan(h, w, n * c, level)
        return (f"; plan grid {plan.grid} ({plan.per_sm} an SM), P "
                f"{plan.planes} an iteration, operators "
                f"{'resident' if plan.resident else 'phased'}, smem "
                f"{plan.smem_bytes} B")
    bwd = name == "filtered_act_banded_bwd"
    plan = FA.banded_mma_plan(h, w, n * c, level, FA.BANDED_HI_BYTES, bwd)
    up, down = plan[0].tiles
    per = max(ch.planes for ch in plan)
    up_smem = FA.banded_mma_smem_bytes(w, level, up, False,
                                       strips=2 if bwd else 1)
    return (f"; plan {len(plan)} chunks of <= {per} planes, up "
            f"{-(-2 * h // up)} strips of {up} rows a plane ({up_smem} B), "
            f"down {-(-h // down)} of {down} "
            f"({FA.banded_mma_smem_bytes(w, level, down, True)} B), "
            f"{'m' if bwd else 'hi'} scratch "
            f"{FA.banded_mma_scratch_bytes(h, w, per, level)} B "
            f"(cap {FA.BANDED_HI_BYTES} B)")


# the plain resamplers at the AF-VAE's shapes: its decoder's three
# upsamplers in the serving protocol (batch 9: the base and 8 shifts) and
# its encoder's first downsampler in the VAE trainer (batch 4)
RESAMPLER_SHAPES = (("up", (9, 512, 32, 32)), ("up", (9, 512, 64, 64)),
                    ("up", (9, 256, 128, 128)), ("down", (4, 128, 256, 256)))


def time_resamplers(torch):
    """The plain resamplers at each level: time and the RMS of the change
    from 'highest' over the output's RMS (logged, not gated)."""
    from afldm_tpu_torch.ops import ideal_lpf as L
    g = torch.Generator("cuda").manual_seed(0)
    for op, shape in RESAMPLER_SHAPES:
        x = torch.randn(shape, device="cuda", generator=g)
        fn = L.upsample_rfft if op == "up" else L.downsample_rfft
        times, outs = {}, {}
        try:
            with torch.inference_mode():
                for level in ("highest", *LEVELS):
                    L.set_af_precision(level)
                    outs[level] = fn(x, 2)
                    times[level] = time_ms(lambda: fn(x, 2))
        finally:
            L.set_af_precision("highest")
        scale = float(outs["highest"].double().pow(2).mean().sqrt())
        rel = {lv: float((outs[lv] - outs["highest"]).double().pow(2).mean()
                         .sqrt()) / scale for lv in LEVELS}
        log(f"resampler {op} {shape}: " + ", ".join(
            f"{lv} {times[lv]:.4f} ms" for lv in times) + "; RMS change "
            "from highest / output RMS: " + ", ".join(
                f"{lv} {rel[lv]:.3e}" for lv in LEVELS))
        del x, outs
        torch.cuda.empty_cache()


def check_level_kernels(torch, report, names=LEVEL_KERNELS):
    """Phase 30: each bf16 variant at each level against its plain version
    at that level, timed; fills the level rows of ``report``."""
    from afldm_tpu_torch.ops import filtered_act as FA
    from afldm_tpu_torch.ops import set_af_precision
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    for name in names:
        for level in LEVELS:
            row = report[f"{name}:{level}"]
            split = {"operations": 0.0, "bytes": 0.0}
            for shape in KERNELS[name]["shapes"]:
                if max(shape[-2:]) > FA.LEVEL_MAX:
                    log(f"check {name}:{level} {shape}: n/a, above "
                        f"{FA.LEVEL_MAX} px the f32 kernel runs at every "
                        "level")
                    continue
                run, plain, work = _level_case(torch, name, shape, dev, g)
                try:
                    set_af_precision(level)
                    got, want = run(), plain(level)
                    exact = plain("highest")
                    own = want - exact
                    own_rms = float(own.double().pow(2).mean().sqrt())
                    own_max = float(own.abs().max())
                    del own, exact
                    d = got - want
                    err_rms = float(d.double().pow(2).mean().sqrt())
                    err = float(d.abs().max())
                    del d, got, want
                    ratio = err_rms / own_rms if own_rms else float("inf")
                    good = ratio <= LEVEL_RMS_RATIO and err <= own_max
                    t = time_ms(run)
                    tp = time_ms(lambda: plain(level))
                finally:
                    set_af_precision("highest")
                b, by = level_bound_ms(*work, level)
                floor = (f", TwoSum floor "
                         f"{twosum_floor_ms(shape, name):.4f} ms"
                         if level == "high" else
                         f", byte floor {byte_floor_ms(shape):.4f} ms"
                         if name == "filtered_act_plane_bwd" else "")
                log(f"check {name}:{level} {shape}: RMS ratio {ratio:.4f} "
                    f"(limit {LEVEL_RMS_RATIO}; RMS err {err_rms:.3e}, "
                    f"level's own RMS {own_rms:.3e}), max_abs_err {err:.3e} "
                    f"(limit: the level's own max {own_max:.3e}) "
                    f"{'ok' if good else 'FAIL'}; kernel {t:.4f} ms, plain "
                    f"{tp:.4f} ms, bound {b:.4f} ms ({by}-bound, "
                    f"{LEVEL_PASSES[level]} x {work[0] / 1e9:.3f} GFLOP, "
                    f"{work[1] / 1e6:.3f} MB){floor}"
                    f"{level_launch_plan(name, shape, level)}")
                ok &= bool(good)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["rms_ratio"] = max(row["rms_ratio"], ratio)
                row["ms"] += t
                row["plain_ms"] += tp
                row["bound_ms"] += b
                split[by] += b
                del run, plain
                torch.cuda.empty_cache()
            row["bound_by"] = max(split, key=split.get)
            log_sums(f"{name}:{level}", row, "its shapes")
    return ok


def check_tiny_reference(torch):
    """The tiny pipeline with the same weights on the card (kernels) and on
    the CPU (plain versions): per-shift PSNR within 0.05 dB and images
    within 1e-3 of their scale (f32 rounding compounds over 6 UNet passes
    and 3 decodes; cuDNN picks other summation orders than the CPU)."""
    import numpy as np
    from afldm_tpu_torch.pipelines import (init_random_pipeline,
                                           shift_equivariance_eval)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    cfgs = load_configs(tiny=True)
    lat = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = init_random_pipeline(*cfgs, seed=0, device=dev)
        res[dev] = shift_equivariance_eval(pipe, init_latent=lat,
                                           num_inference_steps=4,
                                           num_shift_steps=4)
    d_psnr = float(np.abs(res["cuda"].psnrs - res["cpu"].psnrs).max())
    scale = float(np.abs(res["cpu"].outputs).max())
    d_img = float(np.abs(res["cuda"].outputs - res["cpu"].outputs).max())
    ok = (np.isfinite(res["cuda"].psnrs).all() and d_psnr <= 0.05
          and d_img <= 1e-3 * scale)
    log(f"tiny reference (card vs CPU, 4 steps, 4 shifts): max |dPSNR| "
        f"{d_psnr:.2e} dB (limit 0.05), max |d image| {d_img:.2e} "
        f"(limit {1e-3 * scale:.2e}) {'ok' if ok else 'FAIL'}")
    return ok


# the kernels each full-width path must launch
SERVING_KERNELS = ("filtered_act_plane", "filtered_act_banded", "flash_fwd")
TRAINING_KERNELS = ("filtered_act_plane", "filtered_act_banded", "flash_fwd",
                    "filtered_act_plane_bwd", "flash_bwd_dq", "flash_bwd_dkv")
VAE_TRAINING_KERNELS = ("filtered_act_plane", "filtered_act_banded",
                        "filtered_act_plane_bwd", "filtered_act_banded_bwd")


def run_main_path(torch, steps):
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import (init_random_pipeline,
                                           shift_equivariance_eval)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    t0 = time.perf_counter()
    pipe = init_random_pipeline(*load_configs(), seed=0, device="cuda")
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"main path: full-width pipeline built in "
        f"{time.perf_counter() - t0:.1f} s (UNet {n_params / 1e6:.1f}M "
        f"params, VAE at {pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio} px)")
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = shift_equivariance_eval(pipe, generator=gen,
                                  num_inference_steps=steps,
                                  num_shift_steps=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    log(f"main path: shift_equivariance_eval {steps} steps x 16 shifts in "
        f"{wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main path PSNRs (dB): " + " ".join(f"{p:.3f}" for p in res.psnrs))
    log(f"main path launches: {json.dumps(counts)}")
    ok = (res.psnrs.shape == (16,) and bool(np.isfinite(res.psnrs).all())
          and res.outputs.shape == (16, 256, 256, 3)
          and bool(np.isfinite(res.outputs).all()))
    if not ok:
        log("main path: FAIL (non-finite or misshapen results)")
    missing = [k for k in SERVING_KERNELS if counts[k] == 0]
    if missing:
        log(f"main path: FAIL, never launched: {missing}")
    return ok and not missing, counts, res.psnrs


def _tiny_trainer(device, mixed_precision=None):
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    ucfg, vcfg, scfg = load_configs(tiny=True)
    base = T.BaseTrainingConfig(resolution=64, train_batch_size=2, seed=0,
                                gradient_checkpointing=True,
                                mixed_precision=mixed_precision)
    cfg = T.LDMTrainingConfig(af_models=True, use_shift_loss=True,
                              use_cross_attn=True, use_ema=True)
    tr = T.create_trainer("ldm", base, cfg, device=device)
    tr.init_modules(vae_config=vcfg, unet_config=ucfg, scheduler_config=scfg)
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    return tr


def _grads_close(got: dict, want: dict, floor: float = GRAD_FLOOR):
    """(worst error over tensors in units of the tensor's scale, its name):
    the scale is the tensor's max abs, floored at ``floor`` of the largest
    gradient of all."""
    largest = max(float(g.abs().max()) for g in want.values())
    worst, worst_name = 0.0, None
    for n, g in want.items():
        scale = max(float(g.abs().max()), floor * largest)
        r = float((got[n] - g).abs().max()) / scale
        if r > worst:
            worst, worst_name = r, n
    return worst, worst_name


def check_tiny_training(torch):
    """One step of the tiny LDM trainer (64 px, batch 2) with the same
    weights, images and draws on the card (kernels) and on the CPU (plain
    versions): the loss and every UNet gradient, within LOSS_RTOL and
    GRAD_RTOL."""
    import numpy as np
    from afldm_tpu_torch import train as T
    images = next(T.epoch_batches(T.SyntheticDataset(resolution=64,
                                                     length=2), 2))["input"]
    res = {}
    for dev in ("cuda", "cpu"):
        tr = _tiny_trainer(dev)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
        loss, logs = tr.loss_fn(x.to(dev), tr.draw(0, 2))
        loss.backward()
        res[dev] = ({k: float(v) for k, v in logs.items()},
                    {n: p.grad.detach().cpu()
                     for n, p in tr.unet.named_parameters()})
    (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
    d_loss = max(abs(lc[k] - lp[k]) / abs(lp[k]) for k in lp)
    worst, worst_name = _grads_close(gc, gp)
    ok = (all(np.isfinite(v) for v in lc.values()) and d_loss <= LOSS_RTOL
          and worst <= GRAD_RTOL)
    log(f"tiny training reference (card vs CPU, one step): losses "
        f"{json.dumps(lc)}; max loss rel err {d_loss:.2e} (limit "
        f"{LOSS_RTOL}), max grad err {worst:.2e} of its tensor's scale at "
        f"{worst_name} (limit {GRAD_RTOL}) {'ok' if ok else 'FAIL'}")
    return ok


def run_training(torch, n_steps, mixed_precision=None, stats=None):
    """The full-width LDM trainer of configs/ldm/train_unet_ffhq.json as it
    stands (``profile_main_path.ffhq_trainer``: the VAE from
    configs/vae/model_afvae.json, since vae_path holds no checkpoint;
    SyntheticDataset, since train_data_dir is absent; random weights); at
    ``mixed_precision`` "bf16" the JAX package's flagship LDM run, its
    backward launches held to the count reckoned from the configs.
    ``stats`` (a dict) gets the median step and the peak memory."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.profile_main_path import ffhq_trainer
    t0 = time.perf_counter()
    tr, ds = ffhq_trainer(device="cuda", seed=0,
                          mixed_precision=mixed_precision)
    base, cfg = tr.base_cfg, tr.cfg
    p0 = [p.detach().clone() for p in tr.unet.parameters()]
    batches = T.epoch_batches(ds, base.train_batch_size, seed=0)
    tag = "bf16 training" if mixed_precision == "bf16" else "training"
    log(f"{tag}: full-width LDM trainer built in "
        f"{time.perf_counter() - t0:.1f} s (UNet "
        f"{sum(p.numel() for p in p0) / 1e6:.1f}M params, batch "
        f"{base.train_batch_size}, {base.resolution} px, gradient "
        f"checkpointing {base.gradient_checkpointing} "
        f"({base.remat_policy}), EMA {cfg.use_ema}, shift loss "
        f"{cfg.use_shift_loss}, CFA {cfg.use_cross_attn}, mixed precision "
        f"{base.mixed_precision})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for step in range(n_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        logs = tr.training_step(step, batch)  # floats: synchronises
        times.append(time.perf_counter() - t0)
        losses.append(logs)
        log(f"{tag} step {step}: {time.perf_counter() - t0:.3f} s "
            f"{json.dumps(logs)} (lr of the next update {tr.opt.lr:.3g})")
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = times[1:] or times
    med = float(np.median(steady))
    log(f"{tag}: median step {med:.3f} s over steps 1..{n_steps - 1} "
        f"({base.train_batch_size / med:.2f} images/s), first step "
        f"{times[0]:.3f} s, peak device memory {peak:.2f} GiB")
    log(f"{tag} launches: {json.dumps(counts)}")
    if stats is not None:
        stats.update(median_s=med, peak_gib=peak)
    moved = sum(not torch.equal(a, p)
                for a, p in zip(p0, tr.unet.parameters()))
    finite = all(np.isfinite(v) for d in losses for v in d.values())
    log(f"{tag}: {moved} of {len(p0)} parameter tensors moved; losses "
        f"finite: {finite}")
    if mixed_precision == "bf16":
        missing = _bf16_launches_as_reckoned(
            tag, tr, "ldm", counts, n_steps, BF16_TRAINING_KERNELS)
    else:
        missing = _missing(tag, counts, TRAINING_KERNELS)
    ok = finite and moved == len(p0) and not missing
    if not ok:
        log(f"{tag}: FAIL")
    return ok, counts


# the tiny AF-VAE of the card-vs-CPU step: every level filtered, so the
# 128 px level takes K1/K2 and the 64 and 32 px levels K5/K5b
TINY_VAE = dict(block_out_channels=[16, 16, 16], layers_per_block=1,
                latent_channels=4, norm_num_groups=8, sample_size=128,
                alias_free=True, down_filtered_act=[True, True, True],
                up_filtered_act=[True, True, True], up_rescale=[True, True])


def _tiny_vae_trainer(device, mixed_precision=None):
    from afldm_tpu_torch import train as T
    base = T.BaseTrainingConfig(resolution=128, train_batch_size=2, seed=0,
                                mixed_precision=mixed_precision)
    cfg = T.VAETrainingConfig(use_shift_loss=True, use_disc=True,
                              use_ema=True)
    tr = T.create_trainer("vae", base, cfg, device=device)
    tr.init_modules(vae_config=TINY_VAE,
                    disc_config={"depth": 3, "hidden_channels": 32})
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    return tr


def check_tiny_vae_training(torch):
    """One generator step (MSE + perceptual + KL + shift + adaptive-weight
    GAN term) and one discriminator step of the tiny AF-VAE trainer (128
    px, batch 2) with the same weights, images and draws on the card
    (kernels) and on the CPU (plain versions): the losses within LOSS_RTOL
    and every VAE, then every discriminator, gradient within GRAD_RTOL
    (the discriminator's scales floored at DISC_GRAD_FLOOR)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    images = next(T.epoch_batches(T.SyntheticDataset(resolution=128,
                                                     length=2), 2))["input"]
    res = {}
    for dev in ("cuda", "cpu"):
        tr = _tiny_vae_trainer(dev)
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(dev)
        draws = tr.draw(0, 2)
        if dev == "cuda":
            kernels.reset_launch_counts()
        logs = tr.generator_backward(x, draws)
        logs.update(tr.disc_backward(x, draws))
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = dict(kernels.LAUNCHES)
        res[dev] = ({k: float(v) for k, v in logs.items()},
                    {n: p.grad.detach().cpu()
                     for n, p in tr.vae.named_parameters()},
                    {n: p.grad.detach().cpu()
                     for n, p in tr.disc.named_parameters()})
    (lc, gc, dc), (lp, gp, dp) = res["cuda"], res["cpu"]
    # relative to the loss, floored at 1e-2: the GAN term is a mean of
    # logits of either sign and may sit near 0
    d_loss = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-2) for k in lp)
    worst_g, name_g = _grads_close(gc, gp)
    worst_d, name_d = _grads_close(dc, dp, DISC_GRAD_FLOOR)
    missing = [k for k in VAE_TRAINING_KERNELS if launched[k] == 0]
    ok = (all(np.isfinite(v) for v in lc.values()) and d_loss <= LOSS_RTOL
          and worst_g <= GRAD_RTOL and worst_d <= GRAD_RTOL and not missing)
    log(f"tiny VAE training reference (card vs CPU, one generator and one "
        f"discriminator step): losses {json.dumps(lc)}; max loss rel err "
        f"{d_loss:.2e} (limit {LOSS_RTOL}), max VAE grad err {worst_g:.2e} "
        f"of its tensor's scale at {name_g}, max discriminator grad err "
        f"{worst_d:.2e} at {name_d} (limit {GRAD_RTOL}); launches "
        f"{json.dumps(launched)} {'ok' if ok else 'FAIL'}")
    return ok


def run_vae_training(torch, n_steps, mixed_precision=None, stats=None):
    """The full-width AF-VAE trainer of configs/vae/train_afvae_imagenet.json
    as it stands (``profile_main_path.afvae_trainer``: SyntheticDataset,
    since train_data_dir is absent; random weights), at ``mixed_precision``
    as ``run_training`` takes it."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.profile_main_path import afvae_trainer
    t0 = time.perf_counter()
    tr, ds = afvae_trainer(device="cuda", seed=0,
                           mixed_precision=mixed_precision)
    base, cfg = tr.base_cfg, tr.cfg
    p0 = [p.detach().clone() for p in tr.vae.parameters()]
    batches = T.epoch_batches(ds, base.train_batch_size, seed=0)
    tag = ("bf16 VAE training" if mixed_precision == "bf16"
           else "VAE training")
    log(f"{tag}: full-width AF-VAE trainer built in "
        f"{time.perf_counter() - t0:.1f} s (VAE "
        f"{sum(p.numel() for p in p0) / 1e6:.1f}M params, batch "
        f"{base.train_batch_size}, {base.resolution} px, gradient "
        f"accumulation {cfg.gradient_accumulation_steps}, gradient "
        f"checkpointing {base.gradient_checkpointing}, shift loss "
        f"{cfg.use_shift_loss}, GAN {cfg.use_disc}, EMA {cfg.use_ema}, "
        f"lr {cfg.learning_rate} with {cfg.lr_warmup_steps} warmup updates, "
        f"mixed precision {base.mixed_precision})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for step in range(n_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        logs = tr.training_step(step, batch)  # floats: synchronises
        times.append(time.perf_counter() - t0)
        losses.append(logs)
        note = ""
        if tr.opt.micro_step == 0:  # an update was applied
            moved = sum(not torch.equal(a, p)
                        for a, p in zip(p0, tr.vae.parameters()))
            note = f"; {moved} of {len(p0)} tensors moved so far"
        log(f"{tag} micro-step {step}: {times[-1]:.3f} s "
            f"{json.dumps(logs)}{note}")
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(times[1:] or times))
    log(f"{tag}: median micro-step {med:.3f} s over micro-steps "
        f"1..{n_steps - 1} ({base.train_batch_size / med:.2f} images/s), "
        f"first {times[0]:.3f} s, peak device memory {peak:.2f} GiB")
    log(f"{tag} launches: {json.dumps(counts)}")
    if stats is not None:
        stats.update(median_s=med, peak_gib=peak)
    moved = sum(not torch.equal(a, p)
                for a, p in zip(p0, tr.vae.parameters()))
    finite = all(np.isfinite(v) for d in losses for v in d.values())
    log(f"{tag}: {moved} of {len(p0)} parameter tensors moved after "
        f"{n_steps // cfg.gradient_accumulation_steps} updates; losses "
        f"finite: {finite}")
    if mixed_precision == "bf16":
        missing = _bf16_launches_as_reckoned(
            tag, tr, "vae", counts, n_steps, BF16_VAE_TRAINING_KERNELS)
    else:
        missing = _missing(tag, counts, VAE_TRAINING_KERNELS)
    ok = finite and moved == len(p0) and not missing
    if not ok:
        log(f"{tag}: FAIL")
    return ok, counts


# the kernels each full-width interpolation path must launch
FFHQ_INTERP_KERNELS = ("filtered_act_plane", "flash_fwd", "flash2_fwd")
SD_INTERP_KERNELS = ("filtered_act_plane", "filtered_act_banded",
                     "flash_fwd")
# the kernels every tiny SD-family card-vs-CPU check must launch (the tiny
# AF-VAE at 64 px has no level above 64 px, so no K1)
TINY_SD_KERNELS = ("filtered_act_plane", "flash_fwd")


def _ffhq_interp(torch, pipe, ends, n_frames, steps):
    """The FFHQ interp path through ``LDMPipeline``: DDIM-invert the two
    endpoint latents, STORE each, then one interp denoise of ``n_frames``
    frames (alphas evenly from 0 to 1, start noise slerped between the two
    inversions) and their decode. Returns (latents, images)."""
    from afldm_tpu_torch.pipelines import slerp
    dev = pipe.device
    inv = [pipe.ddim_inversion(e.to(dev), steps)[0] for e in ends]
    kv = [pipe.denoise(i, steps, collect_kv=True)[1] for i in inv]
    a = torch.linspace(0, 1, n_frames, device=dev)
    noises = slerp(inv[0].expand(n_frames, -1, -1, -1),
                   inv[1].expand(n_frames, -1, -1, -1), a)
    lat, _ = pipe.denoise(noises, steps, kv_traj=kv[0], kv_traj2=kv[1],
                          alpha=a[:, None, None])
    return lat, pipe.decode(lat)


def check_tiny_interp(torch):
    """The tiny FFHQ interp (3 frames, 4 steps) with the same weights and
    latents on the card (K6, K3, K5) and on the CPU (plain versions): the
    latents within 1e-3 of their scale (f32 rounding compounds over 4
    inversion, 8 STORE and 4 interp UNet passes; cuDNN sums in other
    orders than the CPU)."""
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    cfgs = load_configs(tiny=True)
    ends = torch.randn(2, 1, 4, 8, 8,
                       generator=torch.Generator().manual_seed(3))
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = init_random_pipeline(*cfgs, seed=0, device=dev)
        kernels.reset_launch_counts()
        lat, img = _ffhq_interp(torch, pipe, ends, 3, 4)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = dict(kernels.LAUNCHES)
        res[dev] = lat.cpu(), img.cpu()
    (lc, ic), (lp, ip) = res["cuda"], res["cpu"]
    d_lat = float((lc - lp).abs().max())
    d_img = float((ic - ip).abs().max())
    lim_lat = 1e-3 * float(lp.abs().max())
    lim_img = 1e-3 * float(ip.abs().max())
    ok = (bool(torch.isfinite(lc).all()) and d_lat <= lim_lat
          and d_img <= lim_img and launched["flash2_fwd"] > 0)
    log(f"tiny FFHQ interp reference (card vs CPU, 3 frames, 4 steps): max "
        f"|d latent| {d_lat:.2e} (limit {lim_lat:.2e}), max |d image| "
        f"{d_img:.2e} (limit {lim_img:.2e}); launches "
        f"{json.dumps(launched)} {'ok' if ok else 'FAIL'}")
    return ok


def run_ffhq_interp(torch, steps, n_frames=17):
    """The FFHQ interp path at full width: the serving path's pipeline
    (``configs/ldm/model_unet.json``, AF-VAE at 256 px, random weights from
    seed 0), two endpoint latents from a seeded generator."""
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    pipe = init_random_pipeline(*load_configs(), seed=0, device="cuda")
    ends = torch.randn(2, 1, 4, 32, 32, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lat, img = _ffhq_interp(torch, pipe, ends, n_frames, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    finite = bool(torch.isfinite(lat).all() and torch.isfinite(img).all())
    log(f"FFHQ interp: 2 inversions + 2 STORE passes + interp of "
        f"{n_frames} frames, {steps} steps each, and the decode in "
        f"{wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; images "
        f"{tuple(img.shape)} finite: {finite}")
    log(f"FFHQ interp launches: {json.dumps(counts)}")
    missing = [k for k in FFHQ_INTERP_KERNELS if counts[k] == 0]
    if missing:
        log(f"FFHQ interp: FAIL, never launched: {missing}")
    ok = finite and img.shape == (n_frames, 3, 256, 256) and not missing
    if not ok:
        log("FFHQ interp: FAIL")
    return ok, counts


def check_tiny_sd_interp(torch):
    """The tiny SD image interpolation of the CLI (64 px, 3 frames, 4
    steps) with the same weights, flows and draws on the card and on the
    CPU: frames on [0, 1] within 1e-3 (rounding compounds over 2
    encodes, 16 UNet passes and the decode)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import (init_random_interp_pipeline,
                                           interp_draws)
    from afldm_tpu_torch.scripts.image_interpolation import (image_pair,
                                                              load_configs)
    from afldm_tpu_torch.shift.simple_flow import predict_flow
    img0, img1 = image_pair(64)
    flows = predict_flow(img0, img1)
    draws = interp_draws(torch.Generator().manual_seed(1), (1, 4, 8, 8), 3)
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = init_random_interp_pipeline(*load_configs(tiny=True), seed=0,
                                           device=dev)
        kernels.reset_launch_counts()
        res[dev] = pipe(img0, img1, num_frames=3, num_inference_steps=4,
                        draws=draws, flows=flows)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = dict(kernels.LAUNCHES)
    d = float(np.abs(res["cuda"] - res["cpu"]).max())
    ok = (res["cuda"].shape == (3, 64, 64, 3)
          and bool(np.isfinite(res["cuda"]).all()) and d <= 1e-3
          and launched["flash_fwd"] > 0)
    log(f"tiny SD interpolation reference (card vs CPU, 3 frames, 4 "
        f"steps): max |d frame| {d:.2e} on [0, 1] (limit 1e-3); launches "
        f"{json.dumps(launched)} {'ok' if ok else 'FAIL'}")
    return ok


def run_sd_interp(torch, n_frames, steps):
    """The SD image interpolation at full width, as the CLI builds it
    (``init_random_interp_pipeline`` on its configs, random weights from
    seed 0, its synthetic 512 px pair and Lucas-Kanade flow, draws from a
    seeded generator)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_interp_pipeline
    from afldm_tpu_torch.scripts.image_interpolation import (image_pair,
                                                              load_configs)
    from afldm_tpu_torch.shift.simple_flow import predict_flow
    t0 = time.perf_counter()
    pipe = init_random_interp_pipeline(*load_configs(), seed=0,
                                       device="cuda")
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"SD interpolation: full-width pipeline built in "
        f"{time.perf_counter() - t0:.1f} s (UNet {n_params / 1e6:.1f}M "
        f"params, VAE at {res} px)")
    img0, img1 = (t.cuda() for t in image_pair(res))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    flows = predict_flow(img0, img1)
    frames = pipe(img0, img1, num_frames=n_frames, num_inference_steps=steps,
                  generator=torch.Generator().manual_seed(1), flows=flows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    finite = bool(np.isfinite(frames).all())
    log(f"SD interpolation: flow + {n_frames} frames, {steps} steps at "
        f"{res} px in {wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; frames "
        f"{frames.shape} finite: {finite}")
    log(f"SD interpolation launches: {json.dumps(counts)}")
    missing = [k for k in SD_INTERP_KERNELS if counts[k] == 0]
    if missing:
        log(f"SD interpolation: FAIL, never launched: {missing}")
    ok = finite and frames.shape == (n_frames, res, res, 3) and not missing
    if not ok:
        log("SD interpolation: FAIL")
    return ok, counts


SWEEP_KERNELS = ("flash_fwd", "flash2_fwd", "flash_probe_dots",
                 "flash_probe_stream")
HEADLINE_KERNELS = ("filtered_act_plane", "flash_fwd")
SWEEP_ITERS = 3  # chained calls per timing (the script's default is 20)


def _missing(what, counts, needed):
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        log(f"{what}: FAIL, never launched: {missing}")
    return missing


def run_sweep(torch, dtype="f32"):
    """The port's flash sweep at its default shapes and ``dtype``: K3 at
    (8, 8, 4096, 80), K6 at (17, 8, 4096, 80), P1 and P2 at K3's shape;
    at bf16 their bf16 variants."""
    import math
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.scripts import bench_flash_sweep
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = bench_flash_sweep.main(["--iters", str(SWEEP_ITERS), "--dtype",
                                   dtype])
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    finite = all(math.isfinite(v) for r in rows for v in r.values()
                 if isinstance(v, float))
    what = "flash sweep" + ("" if dtype == "f32" else f" at {dtype}")
    log(f"{what}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s "
        f"wall, all finite: {finite}; rows {json.dumps(rows)}; launches "
        f"{json.dumps(counts)}")
    needed = (SWEEP_KERNELS if dtype == "f32"
              else tuple(f"{k}/bf16" for k in SWEEP_KERNELS))
    missing = _missing(what, counts, needed)
    return finite and len(rows) == 3 and not missing, counts


def run_headline(torch):
    """``scripts.bench.measure``: the full-width FFHQ UNet's 50-step DDIM
    denoise at batch 1, one warm-up and the best of 3."""
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.scripts import bench
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sps = bench.measure(device="cuda")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"headline: af_unet_denoise_steps_per_s_ffhq256 = {sps:.3f} steps/s "
        f"(50-step DDIM denoise, batch 1, best of 3); launches "
        f"{json.dumps(counts)}")
    missing = _missing("headline", counts, HEADLINE_KERNELS)
    return sps > 0 and not missing, counts


def check_tiny_service(torch):
    """The tiny sampler service of ``scripts.serve_ldm --tiny`` on the card
    and on the CPU with the same weights and seeds (``_draw`` latents come
    from a CPU generator): images within 1e-3 of their scale (rounding
    compounds over 4 UNet passes and the decode)."""
    import numpy as np
    from afldm_tpu_torch.scripts import serve_ldm
    from afldm_tpu_torch.serve import SamplerService
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = serve_ldm.build_pipeline(serve_ldm.parse_args(
            ["--tiny", "--device", dev]))
        svc = SamplerService(pipe, batch_window_ms=1.0)
        try:
            res[dev] = np.concatenate([svc.sample(1, 4, seed=s)["images"]
                                       for s in (3, 4)])
        finally:
            svc.close()
    d = float(np.abs(res["cuda"] - res["cpu"]).max())
    lim = 1e-3 * float(np.abs(res["cpu"]).max())
    ok = bool(np.isfinite(res["cuda"]).all()) and d <= lim
    log(f"tiny service reference (card vs CPU, 2 requests, 4 steps): max "
        f"|d image| {d:.2e} (limit {lim:.2e}) {'ok' if ok else 'FAIL'}")
    return ok


def run_service(torch, steps, n_requests=4):
    """The sampler service on the full-width FFHQ pipeline (random weights
    from seed 0): ``n_requests`` concurrent single-image requests."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    from afldm_tpu_torch.serve import SamplerService
    pipe = init_random_pipeline(*load_configs(), seed=0, device="cuda")
    svc = SamplerService(pipe, batch_window_ms=50.0, max_batch=8)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_requests) as ex:
            outs = list(ex.map(lambda s: svc.sample(1, steps, seed=s),
                               range(n_requests)))
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        stats = json.loads(json.dumps(svc.stats))
    finally:
        svc.close()
    finite = all(o["images"].shape == (1, 256, 256, 3)
                 and bool(np.isfinite(o["images"]).all()) for o in outs)
    log(f"service: {n_requests} concurrent requests, {steps} steps each, in "
        f"{wall:.2f} s wall; latencies (s) "
        + " ".join(f"{o['latency_s']:.3f}" for o in outs)
        + f"; stats {json.dumps(stats)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; images "
        f"finite: {finite}")
    log(f"service launches: {json.dumps(counts)}")
    batched = stats["batches"] < stats["requests"] == n_requests
    if not batched:
        log("service: FAIL, the requests were not batched")
    missing = _missing("service", counts, SERVING_KERNELS)
    return finite and batched and not missing, counts


def check_tiny_sr(torch):
    """The tiny SR protocol of ``scripts.shift_ldm_sr --tiny`` (4 steps, 4
    shifts) on the card and on the CPU with the same weights: PSNRs within
    0.05 dB and images within 1e-3 of their scale."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.scripts import shift_ldm_sr
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = shift_ldm_sr.build_pipeline(tiny=True, device=dev)
        kernels.reset_launch_counts()
        res[dev] = shift_ldm_sr.run(pipe, 4, 4)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = dict(kernels.LAUNCHES)
    d_psnr = float(np.abs(res["cuda"].psnrs - res["cpu"].psnrs).max())
    d_img = float(np.abs(res["cuda"].outputs - res["cpu"].outputs).max())
    lim = 1e-3 * float(np.abs(res["cpu"].outputs).max())
    ok = (bool(np.isfinite(res["cuda"].psnrs).all()) and d_psnr <= 0.05
          and d_img <= lim and launched["flash_fwd"] > 0)
    log(f"tiny SR reference (card vs CPU, 4 steps, 4 shifts): max |dPSNR| "
        f"{d_psnr:.2e} dB (limit 0.05), max |d image| {d_img:.2e} (limit "
        f"{lim:.2e}); launches {json.dumps(launched)} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def run_sr(torch, steps):
    """``scripts.shift_ldm_sr`` at full width: the FFHQ UNet and the AF-VAE
    at 256 px (random weights from seed 0), the I2SB scheduler, 16
    shifts."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.scripts import shift_ldm_sr
    pipe = shift_ldm_sr.build_pipeline(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = shift_ldm_sr.run(pipe, steps, 16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    log(f"SR protocol: degrade + encode + I2SB {steps} steps (final skipped) "
        f"x 16 shifts in {wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("SR protocol PSNRs (dB): " + " ".join(f"{p:.3f}" for p in res.psnrs))
    log(f"SR protocol launches: {json.dumps(counts)}")
    ok = (res.psnrs.shape == (16,) and bool(np.isfinite(res.psnrs).all())
          and res.outputs.shape == (16, 256, 256, 3))
    if not ok:
        log("SR protocol: FAIL (non-finite or misshapen results)")
    missing = _missing("SR protocol", counts, SERVING_KERNELS)
    return ok and not missing, counts


def _tiny_pair(what, res, limits):
    """Logs and checks one card-vs-CPU comparison of a tiny SD-family
    run: ``res`` maps each device to (output on [0, 1], PSNRs or None),
    the card's launches under "launched"; ``limits`` = (output, PSNR)."""
    import numpy as np
    (got, got_p), (want, want_p) = res["cuda"], res["cpu"]
    d = float(np.abs(got - want).max())
    d_p = 0.0 if got_p is None else float(np.abs(got_p - want_p).max())
    launched = res["launched"]
    ok = (got.shape == want.shape and bool(np.isfinite(got).all())
          and (got_p is None or bool(np.isfinite(got_p).all()))
          and d <= limits[0] and d_p <= limits[1]
          and all(launched[k] > 0 for k in TINY_SD_KERNELS))
    psnr = ("" if got_p is None else
            f", max |dPSNR| {d_p:.2e} dB (limit {limits[1]})")
    log(f"{what} (card vs CPU): max |d| {d:.2e} on [0, 1] (limit "
        f"{limits[0]}){psnr}; launches {json.dumps(launched)} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


class _StubTextEncoder:
    """``encode([prompt]) -> (1, 77, dim)``: a fixed draw per prompt, on
    the CPU; the tiny video check's pipelines hold one so that the
    [uncond, cond] halves of their CFG batches differ."""

    def __init__(self, torch, prompts, dim, seed=11):
        gen = torch.Generator().manual_seed(seed)
        self.table = {p: torch.randn((1, 77, dim), generator=gen)
                      for p in prompts}

    def encode(self, prompts):
        (prompt,) = prompts
        return self.table[prompt]


def check_tiny_video_editing(torch):
    """The tiny video editing of the CLI (64 px, 2 frames of its synthetic
    pattern, 2 DDIM steps at strength 1) with the same weights, prompt
    embeddings (a stub text encoder's draws, distinct for the prompt, the
    negative prompt and the empty inversion prompt) and SDEdit noise on
    the card and on the CPU, as SDEdit with guidance_rescale 0.7 and as
    DDIM inversion: frames on [0, 1] within 1e-3, after checking that the
    card's unconditional and conditional noise predictions differ."""
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_video_editing_pipeline
    from afldm_tpu_torch.scripts.video_editing import load_configs, load_frames
    frames = load_frames(None, 64, 2)
    noise = torch.randn((2, 4, 8, 8),
                        generator=torch.Generator().manual_seed(1))
    prompts = ("a red car", "blurry")
    pipes = {dev: init_random_video_editing_pipeline(
        *load_configs(tiny=True), seed=0, device=dev)
        for dev in ("cuda", "cpu")}
    encoder = _StubTextEncoder(torch, prompts + ("",),
                               pipes["cpu"].unet.config.cross_attention_dim)
    for pipe in pipes.values():
        pipe.text_encoder = encoder
    card = pipes["cuda"]
    with torch.inference_mode():
        x = noise[0:1].cuda()
        eps, _ = card.unet(torch.cat([x, x]), 999,
                           torch.cat(card.encode_prompt(*prompts)))
    halves = float((eps[1] - eps[0]).abs().max())
    ok = halves > 0.1
    log(f"tiny video editing: max |eps_cond - eps_uncond| {halves:.3f} "
        f"(must exceed 0.1) {'ok' if ok else 'FAIL'}")
    for mode, kw in (("SDEdit, guidance_rescale 0.7",
                      dict(guidance_rescale=0.7, noise=noise)),
                     ("inversion", dict(use_inversion=True))):
        res = {}
        for dev, pipe in pipes.items():
            kernels.reset_launch_counts()
            res[dev] = (pipe(frames, *prompts, strength=1.0,
                             num_inference_steps=2, **kw), None)
            if dev == "cuda":
                torch.cuda.synchronize()
                res["launched"] = dict(kernels.LAUNCHES)
        ok &= _tiny_pair(f"tiny video editing ({mode}, 2 frames, 2 steps)",
                         res, (1e-3, 0.0))
    return ok


def run_video_editing(torch, n_frames, steps):
    """Video editing at full width, as the CLI builds it
    (``init_random_video_editing_pipeline`` on its configs, random weights
    from seed 0, its synthetic frames at 512 px, SDEdit at strength 0.7
    with guidance 7.5 and noise from a seeded generator)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_video_editing_pipeline
    from afldm_tpu_torch.scripts.video_editing import load_configs, load_frames
    t0 = time.perf_counter()
    pipe = init_random_video_editing_pipeline(*load_configs(), seed=0,
                                              device="cuda")
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    log(f"video editing: full-width pipeline built in "
        f"{time.perf_counter() - t0:.1f} s (VAE at {res} px)")
    frames = load_frames(None, res, n_frames).cuda()
    n_denoise = len(pipe.get_timesteps(steps, 0.7))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(frames, "a video", strength=0.7, num_inference_steps=steps,
               guidance_scale=7.5, generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    finite = bool(np.isfinite(out).all())
    log(f"video editing: {n_frames} frames, SDEdit {n_denoise} of {steps} "
        f"steps (STORE of frame 0 at CFG batch 2, LOAD of all at CFG batch "
        f"{2 * n_frames}) at {res} px in {wall:.2f} s wall; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"frames {out.shape} finite: {finite}")
    log(f"video editing launches: {json.dumps(counts)}")
    missing = _missing("video editing", counts, SD_INTERP_KERNELS)
    ok = finite and out.shape == (n_frames, res, res, 3) and not missing
    if not ok:
        log("video editing: FAIL")
    return ok, counts


def check_tiny_normal(torch):
    """The tiny normal estimation of the CLI (64 px, 2 shifts) with the
    same weights on the card and on the CPU, ``conv_in2`` and the residual
    convs drawn non-zero so that the residual path counts: YOSO, and 2 DDIM
    steps from the same noise with guidance 2.0 and guess mode; normals on
    [0, 1] within 1e-3 and PSNRs within 0.05 dB."""
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_normal_pipeline
    from afldm_tpu_torch.scripts.shift_normal_estimation import (
        load_configs, synthetic_image)
    image = synthetic_image(64)
    noise = torch.randn((1, 4, 8, 8),
                        generator=torch.Generator().manual_seed(2))
    pipes = {dev: init_random_normal_pipeline(
        *load_configs(tiny=True), seed=0, device=dev, zero_controls=False)
        for dev in ("cuda", "cpu")}
    ok = True
    for mode, kw in (("YOSO", {}),
                     ("2 steps, guidance 2.0, guess mode",
                      dict(is_yoso=False, num_inference_steps=2,
                           guidance_scale=2.0, guess_mode=True,
                           noise=noise))):
        res = {}
        for dev, pipe in pipes.items():
            kernels.reset_launch_counts()
            r = pipe(image, num_shift_steps=2, **kw)
            res[dev] = (r.normals / 2 + 0.5, r.psnrs)
            if dev == "cuda":
                torch.cuda.synchronize()
                res["launched"] = dict(kernels.LAUNCHES)
        ok &= _tiny_pair(f"tiny normal estimation ({mode}, 2 shifts)",
                         res, (1e-3, 0.05))
    return ok


def run_normal_estimation(torch, n_shifts):
    """Normal estimation at full width, as the CLI builds it
    (``init_random_normal_pipeline`` on its configs: the ControlNet of
    ``ControlNetConfig.from_unet_config`` with its zero-started convs,
    random weights from seed 0, the synthetic 512 px image): YOSO over the
    base and ``n_shifts`` shifted latents in one batch."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_normal_pipeline
    from afldm_tpu_torch.scripts.shift_normal_estimation import (
        load_configs, synthetic_image)
    t0 = time.perf_counter()
    pipe = init_random_normal_pipeline(*load_configs(), seed=0, device="cuda")
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    n_params = sum(p.numel() for p in pipe.controlnet.parameters())
    log(f"normal estimation: full-width pipeline built in "
        f"{time.perf_counter() - t0:.1f} s (ControlNet {n_params / 1e6:.1f}M "
        f"params, VAE at {res} px)")
    image = synthetic_image(res).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(image, num_shift_steps=n_shifts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    finite = (bool(np.isfinite(out.psnrs).all())
              and bool(np.isfinite(out.normals).all()))
    log(f"normal estimation: YOSO over 1 + {n_shifts} shifted latents at "
        f"{res} px in {wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; finite: "
        f"{finite}")
    log("normal estimation PSNRs (dB): "
        + " ".join(f"{p:.3f}" for p in out.psnrs)
        + f"; mean {out.mean_psnr:.3f}")
    log(f"normal estimation launches: {json.dumps(counts)}")
    missing = _missing("normal estimation", counts, SD_INTERP_KERNELS)
    ok = (finite and out.psnrs.shape == (n_shifts,)
          and out.normals.shape == (1 + n_shifts, res, res, 3)
          and not missing)
    if not ok:
        log("normal estimation: FAIL")
    return ok, counts


# the kernels the tiny trainers of phase 23 launch (their AF-VAE has no
# level above 64 px, so neither K1 nor K2)
TINY_TRAINING_KERNELS = ("filtered_act_plane", "flash_fwd",
                         "filtered_act_plane_bwd", "flash_bwd_dq",
                         "flash_bwd_dkv")
NEW_TRAINERS = ("i2sb", "sd_text", "norm_controlnet")
# the tiny SD text trainer's CLIP: the width of the tiny SD UNet's text
# embeddings, ViT-L/14's vocabulary and 77 positions
TINY_CLIP = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                 num_attention_heads=2)


def _tiny_new_trainer(torch, name, device, mixed_precision=None):
    """The tiny trainer ``name`` at 64 px, batch 2, weights from seed 0:
    I2SB on the tiny FFHQ UNet and AF-VAE of the protocol CLI (bridge
    noise on, CFA); the SD trainers on the tiny SD UNet and AF-VAE of the
    SD CLIs, SD text with a tiny random CLIP and prompt dropout 0.5."""
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.models.text_encoder import (CLIPTextConfig,
                                                     TextEncoder)
    from afldm_tpu_torch.scripts import image_interpolation, shift_ldm_ffhq
    base = T.BaseTrainingConfig(resolution=64, train_batch_size=2, seed=0,
                                prompt_dropout=0.5,
                                mixed_precision=mixed_precision)
    if name == "i2sb":
        ucfg, vcfg, _ = shift_ldm_ffhq.load_configs(tiny=True)
        sched = json.loads((REPO / "configs" / "sr" /
                            "i2sb_scheduler.json").read_text())
        tr = T.create_trainer(name, base, T.I2SBLDMTrainingConfig(
            is_ode=False, use_cfa=True, use_ema=True), device=device)
        tr.init_modules(vae_config=vcfg, unet_config=ucfg,
                        scheduler_config=sched)
    else:
        ucfg, vcfg, _ = image_interpolation.load_configs(tiny=True)
        if name == "sd_text":
            tr = T.create_trainer(name, base, T.SDTextTrainingConfig(),
                                  device=device)
            tr.init_modules(vae_config=vcfg, unet_config=ucfg,
                            text_encoder=TextEncoder(
                                seed=0, device=device,
                                config=CLIPTextConfig(**TINY_CLIP)))
        else:
            tr = T.create_trainer(name, base, T.NormControlNetConfig(),
                                  device=device)
            tr.init_modules(vae_config=vcfg, unet_config=ucfg)
    tr.init_optimizers(100)
    tr.prepare_modules(seed=0)
    return tr


def _trainer_loss(torch, tr, name, step, batch):
    """(loss, logs) of trainer ``name``'s step with its own draws, as its
    ``training_step`` computes them."""
    draws = tr.draw(step, len(batch["input"]))

    def nchw(a):
        return torch.as_tensor(a).permute(0, 3, 1, 2).contiguous().to(
            tr.device)
    if name == "norm_controlnet":
        return tr.loss_fn(nchw(batch["input"]), nchw(batch["normal"]),
                          tr.prompt_embeds(len(batch["input"])), draws)
    if name == "sd_text":
        ehs = tr.text_encoder.encode(tr.prompts(step, batch)).to(tr.device)
        return tr.loss_fn(nchw(batch["input"]), draws, (ehs,))
    return tr.loss_fn(nchw(batch["input"]), draws)


def _trainer_modules(tr):
    mods = {"unet": tr.unet}
    if hasattr(tr, "controlnet"):
        mods["controlnet"] = tr.controlnet
    return mods


def _trainer_update(tr):
    """The optimizer step(s) and EMA of ``training_step``."""
    tr.opt.step()
    if hasattr(tr, "cn_opt"):
        tr.cn_opt.step()
    if getattr(tr, "ema", None) is not None:
        tr.ema.update(tr.unet.parameters())
    tr.step += 1


def check_tiny_new_trainers(torch):
    """Two steps of the tiny I2SB, SD text (prompt dropout 0.5) and
    normal-ControlNet trainers (64 px, batch 2) from the same weights,
    images and draws on the card (kernels) and on the CPU (plain
    versions): each step's losses within LOSS_RTOL and every gradient of
    the trained modules within GRAD_RTOL of its scale, taken before that
    step's update; the card must launch the tiny trainers' kernels."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    batch = next(T.epoch_batches(T.SyntheticDataset(resolution=64,
                                                    length=2), 2))
    batch["caption"] = np.array(["a red car", "a blue bird"])
    batch["normal"] = batch["input"][:, ::-1].copy()
    ok = True
    for name in NEW_TRAINERS:
        res = {}
        for dev in ("cuda", "cpu"):
            tr = _tiny_new_trainer(torch, name, dev)
            if dev == "cuda":
                kernels.reset_launch_counts()
            steps = []
            for step in range(2):
                loss, logs = _trainer_loss(torch, tr, name, step, batch)
                loss.backward()
                # copies: the optimizer clips the gradients in place
                grads = {f"{m}.{n}": p.grad.detach().cpu().clone()
                         for m, mod in _trainer_modules(tr).items()
                         for n, p in mod.named_parameters()
                         if p.grad is not None}
                steps.append(({k: float(v) for k, v in logs.items()},
                              grads))
                _trainer_update(tr)
            if dev == "cuda":
                torch.cuda.synchronize()
                launched = dict(kernels.LAUNCHES)
            res[dev] = steps
        for step in range(2):
            (lc, gc), (lp, gp) = res["cuda"][step], res["cpu"][step]
            d_loss = max(abs(lc[k] - lp[k]) / abs(lp[k]) for k in lp)
            worst, worst_name = _grads_close(gc, gp)
            good = (all(np.isfinite(v) for v in lc.values())
                    and set(gc) == set(gp) and d_loss <= LOSS_RTOL
                    and worst <= GRAD_RTOL)
            log(f"tiny {name} training reference (card vs CPU, step "
                f"{step}): losses {json.dumps(lc)}; max loss rel err "
                f"{d_loss:.2e} (limit {LOSS_RTOL}), max grad err "
                f"{worst:.2e} of its tensor's scale at {worst_name} (limit "
                f"{GRAD_RTOL}) over {len(gp)} tensors "
                f"{'ok' if good else 'FAIL'}")
            ok &= good
        missing = _missing(f"tiny {name} training", launched,
                           TINY_TRAINING_KERNELS)
        log(f"tiny {name} training launches (card, two steps): "
            f"{json.dumps(launched)}")
        ok &= not missing
    return ok


def check_text_encoder(torch):
    """ViT-L/14's text transformer with weights from seed 0 on the card and
    on the CPU, over two prompts of the hash tokenizer: hidden states
    within 1e-4 of their scale (12 layers of f32 products summed in other
    orders)."""
    from afldm_tpu_torch.models.text_encoder import TextEncoder
    prompts = ["a photo of an astronaut riding a horse", ""]
    out = {dev: TextEncoder(seed=0, device=dev).encode(prompts).cpu()
           for dev in ("cuda", "cpu")}
    d = float((out["cuda"] - out["cpu"]).abs().max())
    lim = 1e-4 * float(out["cpu"].abs().max())
    ok = (out["cuda"].shape == (2, 77, 768)
          and bool(torch.isfinite(out["cuda"]).all()) and d <= lim)
    log(f"text encoder (ViT-L/14, 123.1M params, card vs CPU, 2 prompts): "
        f"max |d| {d:.2e} (limit {lim:.2e}) {'ok' if ok else 'FAIL'}")
    return ok


def _watch_cross_attention_bwd():
    """Counts the K4b launches whose K/V has 77 rows (the text tokens) until
    the returned ``stop`` is called."""
    from afldm_tpu_torch.ops import attention as A
    orig, seen = A.flash_bwd_dkv, []

    def watched(q, k, *args, **kwargs):
        seen.append(k.shape[-2])
        return orig(q, k, *args, **kwargs)
    A.flash_bwd_dkv = watched

    def stop():
        A.flash_bwd_dkv = orig
        return sum(1 for n in seen if n == 77)
    return stop


def _sd_states(torch):
    """One host draw (seed 0) of the SD-1.5-width alias-free UNet and of the
    AF-VAE of ``model_afvae.json``, shared by the two SD trainers."""
    from afldm_tpu_torch.models import (AutoencoderKL, AutoencoderKLConfig,
                                        UNet2DConditionConfig,
                                        UNet2DConditionModel)
    from afldm_tpu_torch.pipelines.loading import init_random_weights
    vcfg = json.loads((REPO / "configs" / "vae" /
                       "model_afvae.json").read_text())
    gen = torch.Generator().manual_seed(0)
    vae = AutoencoderKL(AutoencoderKLConfig.from_diffusers(vcfg))
    unet = UNet2DConditionModel(UNet2DConditionConfig(alias_free=True))
    for m in (vae, unet):
        init_random_weights(m, gen)
    return vcfg, vae.state_dict(), unet.state_dict()


def _full_trainer(torch, name, sd, mixed_precision=None):
    """The full-width trainer ``name`` on the card with its dataset: I2SB
    as ``configs/sr/train_i2sb_imagenet.json`` stands
    (``profile_main_path.i2sb_trainer``); SD text and the normal ControlNet
    at the JAX defaults (512 px, batch 1, SD-1.5 widths, the shared UNet
    and VAE states of ``sd``; SD text with ViT-L/14's random CLIP, the
    ControlNet of ``ControlNetConfig.from_unet_config`` from seed 0)."""
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.scripts.profile_main_path import i2sb_trainer
    if name == "i2sb":
        return i2sb_trainer(device="cuda", seed=0,
                            mixed_precision=mixed_precision)
    vcfg, vae_state, unet_state = sd
    base = T.BaseTrainingConfig(seed=0, mixed_precision=mixed_precision)
    cfg = (T.SDTextTrainingConfig() if name == "sd_text"
           else T.NormControlNetConfig())
    tr = T.create_trainer(name, base, cfg, device="cuda")
    tr.init_modules(vae_config=vcfg)
    ds = T.make_dataset(base)
    tr.init_optimizers(len(ds) // base.train_batch_size * base.num_epochs)
    tr.prepare_modules(seed=0, unet_state=unet_state, vae_state=vae_state)
    return tr, ds


def run_new_trainer(torch, name, n_steps, sd=None, mixed_precision=None,
                    stats=None):
    """``n_steps`` steps of the full-width trainer ``name``, the counters
    set to 0 just before and read just after: the median step over steps
    1.., the peak memory, the launches (those of K4b over 77 text tokens
    apart); every loss finite, every trained tensor that had a non-zero
    gradient moved (at least 80 % had one), the six training kernels
    launched (and K4b at Lk = 77 in the SD trainers); at
    ``mixed_precision`` "bf16" their bf16 variants, the backward ones as
    reckoned, no f32 backward kernel, and in the SD trainers the split
    K4b's reduction (their cross-attention at 64 px splits)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    t0 = time.perf_counter()
    tr, ds = _full_trainer(torch, name, sd, mixed_precision)
    if mixed_precision == "bf16":
        name_tag = f"bf16 {name}"
    else:
        name_tag = name
    base = tr.base_cfg
    trained = [p for m in _trainer_modules(tr).values()
               for p in m.parameters() if p.requires_grad]
    p0 = [p.detach().clone() for p in trained]
    # which trained tensors ever had a non-zero gradient: one that never
    # had (the queries of a cross-attention over equal keys) need not move
    touched = [torch.zeros((), dtype=torch.bool, device="cuda")
               for _ in trained]

    def mark(i):
        def hook(p):
            touched[i] |= (p.grad != 0).any()
        return hook
    handles = [p.register_post_accumulate_grad_hook(mark(i))
               for i, p in enumerate(trained)]
    sizes = {k: sum(p.numel() for p in m.parameters()) / 1e6
             for k, m in _trainer_modules(tr).items()}
    log(f"{name_tag} training: full-width trainer built in "
        f"{time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f}M params" for k, v in sizes.items())
        + f", {sum(p.numel() for p in trained) / 1e6:.1f}M trained, batch "
        f"{base.train_batch_size}, {base.resolution} px)")
    batches = T.epoch_batches(ds, base.train_batch_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stop = _watch_cross_attention_bwd()
    times, losses = [], []
    try:
        for step in range(n_steps):
            batch = next(batches)
            batch["normal"] = batch["input"][:, ::-1].copy()
            t0 = time.perf_counter()
            logs = tr.training_step(step, batch)  # floats: synchronises
            times.append(time.perf_counter() - t0)
            losses.append(logs)
            log(f"{name_tag} training step {step}: {times[-1]:.3f} s "
                f"{json.dumps(logs)}")
    finally:
        cross = stop()
        for h in handles:
            h.remove()
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(times[1:] or times))
    moved = [not torch.equal(a, p) for a, p in zip(p0, trained)]
    graded = [bool(t) for t in touched]
    stuck = sum(g and not m for g, m in zip(graded, moved))
    finite = all(np.isfinite(v) for d in losses for v in d.values())
    log(f"{name_tag} training: median step {med:.3f} s over steps "
        f"1..{n_steps - 1} ({base.train_batch_size / med:.2f} images/s), "
        f"first step {times[0]:.3f} s, peak device memory {peak:.2f} GiB; "
        f"{sum(moved)} of {len(p0)} trained tensors moved, "
        f"{sum(graded)} had a non-zero gradient, {stuck} of those did not "
        f"move; losses finite: {finite}; K4b launches over 77 text tokens: "
        f"{cross}")
    log(f"{name_tag} training launches: {json.dumps(counts)}")
    if stats is not None:
        stats.update(median_s=med, peak_gib=peak)
    if mixed_precision == "bf16":
        missing = _bf16_launches_as_reckoned(
            f"{name_tag} training", tr, name, counts, n_steps,
            BF16_TRAINING_KERNELS)
    else:
        missing = _missing(f"{name_tag} training", counts, TRAINING_KERNELS)
    ok = (finite and stuck == 0 and sum(graded) >= 0.8 * len(p0)
          and not missing)
    if name != "i2sb" and cross == 0:
        log(f"{name_tag} training: FAIL, no K4b launch over the text tokens")
        ok = False
    if (mixed_precision == "bf16" and name != "i2sb"
            and not counts[REDUCE_ROW]):
        log(f"{name_tag} training: FAIL, the split K4b over the text tokens "
            "never launched its reduction")
        ok = False
    if not ok:
        log(f"{name_tag} training: FAIL")
    return ok, counts


def check_sd_round_trip(torch):
    """The tiny SD text trainer's ``save_pipeline`` after one step on the
    card, then ``load_sd_components``: every UNet and VAE tensor comes back
    bit for bit, and one YOSO normal estimation (2 shifts, a ControlNet
    from seed 0 with its zero-started convs drawn too) through the loaded
    modules gives the in-memory modules' normals within 1e-5 on [-1, 1]
    (the card repeats a pass within ~1e-6: cuDNN may pick other
    algorithms)."""
    import shutil
    import numpy as np
    from afldm_tpu_torch.models import ControlNetConfig, ControlNetModel
    from afldm_tpu_torch.pipelines import (NormControlPipeline,
                                           load_sd_components)
    from afldm_tpu_torch.pipelines.loading import init_random_weights
    from afldm_tpu_torch.schedulers import DDIMScheduler
    from afldm_tpu_torch.scripts.shift_normal_estimation import (
        NORMAL_DDIM, synthetic_image)
    tr = _tiny_new_trainer(torch, "sd_text", "cuda")
    tr.training_step(0, {"input": np.zeros((2, 64, 64, 3), np.float32)})
    out = REPO / "results" / "chip_smoke_sd_pipeline"
    shutil.rmtree(out, ignore_errors=True)
    try:
        tr.save_pipeline(str(out))
        parts = load_sd_components(str(out), device="cuda")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    same = all(torch.equal(v, mod.state_dict()[k])
               for name, mod in (("unet", tr.unet), ("vae", tr.vae))
               for k, v in parts[name].state_dict().items())
    cn = ControlNetModel(ControlNetConfig.from_unet_config(tr.unet_config))
    init_random_weights(cn, torch.Generator().manual_seed(0))
    cn = cn.cuda().eval()
    image = synthetic_image(64)
    normals = [NormControlPipeline(vae, unet, cn,
                                   DDIMScheduler.from_config(NORMAL_DDIM))(
        image, num_shift_steps=2).normals
        for vae, unet in ((tr.vae, tr.unet), (tr.vae, tr.unet),
                          (parts["vae"], parts["unet"]))]
    again = float(np.abs(normals[0] - normals[1]).max())
    d = float(np.abs(normals[0] - normals[2]).max())
    ok = same and d <= 1e-5 and bool(np.isfinite(normals[2]).all())
    log(f"SD pipeline round trip (save_pipeline, load_sd_components, YOSO "
        f"on the card): weights bit for bit: {same}; max |d normals| "
        f"{d:.2e} (limit 1e-5; the in-memory pass repeated: {again:.2e}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# card vs CPU for the shift toolkit at 256 px: f32 sums in another order
# (cuDNN's convolutions, cuFFT, atomic scatter-adds); the 47x47 rotation
# filter sums the most terms
SHIFT_OPS_ATOL = 1e-4
SHIFT_MASK_FLIPS = 1e-4


def _shift_ops(torch, x, flow, mask, bg):
    """name -> output of each toolkit op on ``x`` (1, 3, 256, 256) and the
    flow, mask and background of the warps."""
    from afldm_tpu_torch.ops import (conv2d_resample, downsample2d,
                                     filter2d, setup_filter, upfirdn2d,
                                     upsample2d)
    from afldm_tpu_torch.shift import equivariance as E
    from afldm_tpu_torch.shift import flow as FL
    from afldm_tpu_torch.shift.shifters import ImageDownsampler, ImageShifter
    f4 = setup_filter([1, 3, 3, 1])
    f8 = setup_filter([1, 2, 3, 4, 4, 3, 2, 1])
    w = torch.linspace(-1, 1, 8 * 3 * 9, device=x.device).reshape(8, 3, 3, 3)
    out = {
        "upfirdn2d": upfirdn2d(x, f4, up=2, padding=(2, 1, 2, 1)),
        "filter2d (8 taps, separable)": filter2d(x, f8),
        "upsample2d": upsample2d(x, f4),
        "downsample2d": downsample2d(x, f8),
        "conv2d_resample (up 2)": conv2d_resample(x, w, f4, up=2, padding=1),
    }
    for mode in ("lanczos", "fourier", "fourier_crop"):
        warped, m = ImageShifter(mode).shift(x, 3.37, -5.81)
        out[f"{mode} shift"] = warped
        out[f"{mode} shift mask"] = m
    for name, fn in (("fractional rotation", E.apply_fractional_rotation),
                     ("pseudo-rotation", E.apply_fractional_pseudo_rotation)):
        y, m = fn(x, 0.4)
        out[name] = y
        out[f"{name} mask"] = m
    splat, occ = FL.forward_flow_warp(x, flow)
    out["forward_flow_warp"] = splat
    out["forward_flow_warp occlusion"] = occ
    out["flow_warp_with_occ_bg"] = FL.flow_warp_with_occ_bg(
        x, flow, mask, False, background=bg)
    out["ImageDownsampler bilinear"] = ImageDownsampler(
        2, "bilinear").downsample(x)
    return out


def check_shift_ops(torch):
    """The shift toolkit on one 256 px image on the card and on the CPU:
    each op's max |d| within SHIFT_OPS_ATOL, each mask equal."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand((1, 3, 256, 256), generator=g) * 2 - 1
    flow = torch.randn((1, 2, 256, 256), generator=g) * 2
    mask = (torch.rand((1, 1, 256, 256), generator=g) > 0.2).float()
    bg = torch.rand((1, 3, 1, 1), generator=g) * 2 - 1
    cpu = _shift_ops(torch, x, flow, mask, bg)
    card = _shift_ops(torch, *(t.cuda() for t in (x, flow, mask, bg)))
    ok = True
    for name, want in cpu.items():
        got = card[name].cpu()
        if got.shape != want.shape:
            log(f"shift toolkit {name}: FAIL, shape {tuple(got.shape)} on "
                f"the card, {tuple(want.shape)} on the CPU")
            ok = False
            continue
        d = float((got - want).abs().max())
        if "mask" in name or "occlusion" in name:
            # a nearest sample or a weight sum exactly at a rounding tie
            # may flip one element
            n = int((got != want).sum())
            good = n <= SHIFT_MASK_FLIPS * want.numel()
            what = (f"{n} of {want.numel()} elements differ (limit "
                    f"{SHIFT_MASK_FLIPS:g} of them)")
        else:
            good = d <= SHIFT_OPS_ATOL and bool(torch.isfinite(got).all())
            what = f"max |d| {d:.3e} (limit {SHIFT_OPS_ATOL})"
        ok &= good
        log(f"shift toolkit {name} {tuple(got.shape)} (card vs CPU): {what} "
            f"{'ok' if good else 'FAIL'}")
    return ok


def run_equivariance(torch, n_samples, steps):
    """``scripts.eval_equivariance`` at full width: EQ-T and EQ-T_frac over
    ``n_samples`` samples of ``steps`` DDIM steps. Returns (ok, counts,
    the pipeline for phase 29)."""
    import math
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.scripts import eval_equivariance
    t0 = time.perf_counter()
    pipe = eval_equivariance.build_pipeline(device="cuda")
    log(f"EQ metrics: full-width pipeline built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eq_t, eq_t_frac = eval_equivariance.run(pipe, n_samples, 1, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    res = pipe.unet.config.sample_size * pipe.vae.config.downsample_ratio
    finite = math.isfinite(eq_t) and math.isfinite(eq_t_frac)
    log(f"EQ metrics: {n_samples} samples x 3 generations of {steps} steps "
        f"at {res} px in {wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; EQ-T "
        f"{eq_t:.3f} dB, EQ-T_frac {eq_t_frac:.3f} dB (random weights); "
        f"finite: {finite}")
    log(f"EQ metrics launches: {json.dumps(counts)}")
    missing = _missing("EQ metrics", counts, SERVING_KERNELS)
    ok = finite and not missing
    if not ok:
        log("EQ metrics: FAIL")
    return ok, counts, pipe


def run_sequential_protocol(torch, pipe, n_shifts=4, steps=10):
    """The shift protocol on ``pipe`` batched and with
    ``batch_shifts=False`` from one latent: per-shift PSNRs within 0.01
    dB."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import shift_equivariance_eval
    cfg = pipe.unet.config
    lat = torch.randn((1, cfg.in_channels, cfg.sample_size, cfg.sample_size),
                      generator=torch.Generator().manual_seed(5)
                      ).to(pipe.device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls, res = [], []
    for batch_shifts in (True, False):
        t0 = time.perf_counter()
        res.append(shift_equivariance_eval(
            pipe, init_latent=lat, num_inference_steps=steps,
            num_shift_steps=n_shifts, batch_shifts=batch_shifts))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = dict(kernels.LAUNCHES)
    d = float(np.abs(res[0].psnrs - res[1].psnrs).max())
    finite = bool(np.isfinite(res[1].psnrs).all())
    log(f"sequential protocol: {n_shifts} shifts at {steps} steps, batched "
        f"{walls[0]:.2f} s, one pass a shift {walls[1]:.2f} s wall; PSNRs "
        f"(dB) batched " + " ".join(f"{p:.3f}" for p in res[0].psnrs)
        + ", sequential " + " ".join(f"{p:.3f}" for p in res[1].psnrs)
        + f"; max |dPSNR| {d:.2e} dB (limit 0.01)")
    log(f"sequential protocol launches: {json.dumps(counts)}")
    missing = _missing("sequential protocol", counts, SERVING_KERNELS)
    ok = finite and d <= 0.01 and not missing
    if not ok:
        log("sequential protocol: FAIL")
    return ok, counts


def _level_suffix(level):
    return "" if level == "highest" else f":{level}"


def run_af_precision_eval(torch, steps, shifts):
    """Phase 31: ``scripts.eval_af_precision`` at full width, each level on
    a fresh pipeline. Returns (ok, [counts of each level's run])."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.scripts import eval_af_precision as E
    ok, psnrs, runs = True, {}, []
    for level in ("highest", "high", "default"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = E.eval_level(level, eval_steps=steps, shift_steps=shifts,
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        runs.append(counts)
        psnrs[level] = res.psnrs
        sfx = _level_suffix(level)
        need = [f"filtered_act_plane{sfx}", f"filtered_act_banded{sfx}"]
        finite = bool(np.isfinite(res.psnrs).all())
        log(f"af_precision eval {level}: {shifts} shifts at {steps} steps in "
            f"{wall:.2f} s wall (pipeline build included); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"PSNRs (dB) " + " ".join(f"{p:.4f}" for p in res.psnrs)
            + f"; launches " + ", ".join(f"{k} {counts[k]}" for k in need)
            + f"; finite: {finite}")
        missing = [k for k in need if counts[k] == 0]
        if missing:
            log(f"af_precision eval {level}: FAIL, never launched: {missing}")
        ok &= finite and not missing
    rows = E.summarize(psnrs, steps, shifts)
    log("af_precision eval (random weights, deltas not gated): "
        + json.dumps({k: v for k, v in rows.items()
                      if not isinstance(v, dict)}))
    if not ok:
        log("af_precision eval: FAIL")
    return ok, runs


def run_vae_training_level(torch, n_steps):
    """Phase 32: the full-width AF-VAE trainer from one start at 'highest',
    'high' and 'default'. Returns (ok, [counts of each run])."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    from afldm_tpu_torch.ops import set_af_precision
    from afldm_tpu_torch.scripts.profile_main_path import afvae_trainer
    losses, runs, ok = {}, [], True
    for level in ("highest", *LEVELS):
        try:
            tr, ds = afvae_trainer(device="cuda", seed=0, af_precision=level)
            batches = T.epoch_batches(ds, tr.base_cfg.train_batch_size,
                                      seed=0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            losses[level] = [tr.training_step(step, next(batches))
                             for step in range(n_steps)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
        finally:
            set_af_precision("highest")
        runs.append(counts)
        sfx = _level_suffix(level)
        need = [f"{k}{sfx}" for k in LEVEL_KERNELS]
        log(f"VAE training at {level}: {n_steps} micro-steps in {wall:.2f} s "
            f"wall; losses " + json.dumps(losses[level]) + "; launches "
            + ", ".join(f"{k} {counts[k]}" for k in need))
        missing = [k for k in need if counts[k] == 0]
        if missing:
            log(f"VAE training at {level}: FAIL, never launched: {missing}")
        finite = all(np.isfinite(v) for d in losses[level]
                     for v in d.values())
        ok &= finite and not missing
        del tr, ds, batches
        torch.cuda.empty_cache()
    for level in LEVELS:
        gaps = {k: max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-30)
                       for a, b in zip(losses["highest"], losses[level]))
                for k in losses["highest"][0]}
        log(f"VAE training {level} vs highest, max relative loss gap over "
            "the micro-steps (logged, not gated): " + json.dumps(gaps))
    if not ok:
        log("VAE training at the levels: FAIL")
    return ok, runs


# -- phases 33-35: bfloat16 activations on the serving path ----------------

# the bf16-activation variants: (row, the KERNELS row whose shapes it takes,
# its level or None for the flash kernels)
BF16_ROWS = (("filtered_act_plane/bf16", "filtered_act_plane", "highest"),
             ("filtered_act_plane:high/bf16", "filtered_act_plane", "high"),
             ("filtered_act_plane:default/bf16", "filtered_act_plane",
              "default"),
             ("filtered_act_banded/bf16", "filtered_act_banded", "highest"),
             ("filtered_act_banded:high/bf16", "filtered_act_banded",
              "high"),
             ("filtered_act_banded:default/bf16", "filtered_act_banded",
              "default"),
             ("flash_fwd/bf16", "flash_fwd", None),
             ("flash2_fwd/bf16", "flash2_fwd", None),
             # the backward kernels for bf16 x, g and q, k, v, dO (bf16
             # training)
             ("filtered_act_plane_bwd/bf16", "filtered_act_plane_bwd",
              "highest"),
             ("filtered_act_plane_bwd:high/bf16", "filtered_act_plane_bwd",
              "high"),
             ("filtered_act_plane_bwd:default/bf16",
              "filtered_act_plane_bwd", "default"),
             ("filtered_act_banded_bwd/bf16", "filtered_act_banded_bwd",
              "highest"),
             ("filtered_act_banded_bwd:high/bf16", "filtered_act_banded_bwd",
              "high"),
             ("filtered_act_banded_bwd:default/bf16",
              "filtered_act_banded_bwd", "default"),
             ("flash_bwd_dq/bf16", "flash_bwd_dq", None),
             ("flash_bwd_dkv/bf16", "flash_bwd_dkv", None))
# the filtered activations at bf16 agree with their plain version (the
# same f32 function between a bf16 load and a bf16 store) when no element
# is more than one bf16 ulp off and at most this share of them differ:
# the f32 sums run in another order and a sum on a rounding edge may round
# the other way. An element that cancels to near zero carries the f32
# kernel's own absolute error (TOL's atol) besides, as many of its ulps.
# At 'default' every f32 intermediate is cut to its bf16 hi piece, so a
# last-bit difference in one moves the next product by a bf16 ulp of the
# intermediate: those variants are held as phase 30 holds their f32
# twins, RMS(kernel - plain) at most LEVEL_RMS_RATIO of the level's own
# RMS error (plain at 'default' against plain at 'highest', both bf16) and
# max at most the level's own max (on an H100 up to 406 ulps of a
# near-zero element, 0.09 % of them differing)
BF16_ULP_SHARE = 1e-3
# the flash kernels at bf16 agree with their plain version (the online
# softmax of the TPU kernels at the kernels' key tile, ``flash_fwd_plain``
# and ``flash2_fwd_plain``) when RMS(kernel - plain) is at most this share
# of RMS(plain - the f32 plain on the same bf16 inputs), bf16's own error,
# and no element is more than BF16_FLASH_ULPS bf16 ulps of the output's
# largest magnitude off: the tensor cores sum the products in another order
# than the plain version, and ex2.approx is not torch.exp, so p and the
# output land on the other side of a rounding edge now and then; an output
# is an average, and an element near zero carries the absolute error of its
# row's rounded weights. K3's lse within BF16_LSE_TOL (absolute, and as a
# share of |lse|, as the card tests hold it)
BF16_FLASH_RATIO = 0.1
BF16_FLASH_ULPS = 4
BF16_LSE_TOL = 1e-5


def bf16_ulps(torch, a, b, atol=0.0):
    """|a - b| beyond ``atol`` in bf16 ulps of the larger of |a| and |b|,
    elementwise (float64; 0 where both are 0): the ulp of a bf16 value v
    with |v| = m·2^e, 0.5 <= m < 1, is 2^(e - 8)."""
    a, b = a.double(), b.double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    d = ((a - b).abs() - atol).clamp(min=0)
    return torch.where(d > 0, d / ulp, torch.zeros_like(d))


def _bf16_case(torch, row, base, shape, dev, g):
    """(kernel call, plain version, reference, f32 kernel, library call or
    None, work (FLOPs, bytes at bf16), lse pair or None) of a bf16 row at
    ``shape``; the reference is the plain version at 'highest' on the same
    bf16 x (the filtered activations) or the f32 plain on the same values
    (the flash kernels); the lse pair (K3) returns the kernel's and the
    plain version's lse."""
    import torch.nn.functional as F
    from afldm_tpu_torch.ops import attention as A
    from afldm_tpu_torch.ops import filtered_act as FA
    bf = torch.bfloat16
    if base.endswith("_bwd") or base.startswith("flash_bwd"):
        return _bf16_bwd_case(torch, row, base, shape, dev, g)
    if base.startswith("filtered_act"):
        level = dict((r, lv) for r, _, lv in BF16_ROWS)[row]
        x = torch.randn(shape, device=dev, generator=g).to(bf)
        xf = x.float()
        fn = getattr(FA, base)
        plain = getattr(FA, f"{base}_plain")
        flops, nbytes = filtered_act_work(shape)
        n, c, h, w = shape
        # x and out at 2 bytes, the four operators at 4
        nbytes = 2 * 2 * n * c * h * w + 4 * (4 * h * h + 4 * w * w)
        return (lambda: fn(x, "silu"), lambda: plain(x, "silu", level),
                lambda: plain(x, "silu", "highest"), lambda: fn(xf, "silu"),
                None, (flops, nbytes), None)
    n, heads, L, Lk, d, n_kv = _flash_dims(shape)
    q = torch.randn(n, heads, L, d, device=dev, generator=g).to(bf)
    kv = [torch.randn(n_kv, heads, Lk, d, device=dev, generator=g).to(bf)
          .expand(n, -1, -1, -1)
          for _ in range(2 if base == "flash_fwd" else 4)]
    f32 = [t.float() for t in (q, *kv)]
    flops, nbytes = (flash_work if base == "flash_fwd" else flash2_work)(
        shape)
    if base == "flash_fwd":
        # q, the K/V rows, out at 2 bytes, lse at 4
        nbytes = (2 * (2 * n * heads * L * d + 2 * n_kv * heads * Lk * d)
                  + 4 * n * heads * L)
        return (lambda: A.flash_fwd(q, *kv)[0],
                lambda: A.flash_fwd_plain(q, *kv)[0],
                lambda: A._attention_plain(*f32)[0],
                lambda: A.flash_fwd(*f32)[0],
                lambda: F.scaled_dot_product_attention(q, *kv),
                (flops, nbytes),
                lambda: (A.flash_fwd(q, *kv)[1],
                         A.flash_fwd_plain(q, *kv)[1]))
    alpha = torch.linspace(0, 1, n, device=dev)[:, None, None]
    a4 = alpha[:, None]
    nbytes = 2 * (2 * n * heads * L * d + 4 * n_kv * heads * L * d) + 4 * n

    def library():  # two SDPA calls at bf16 and the blend in f32
        o0 = F.scaled_dot_product_attention(q, kv[0], kv[1]).float()
        o1 = F.scaled_dot_product_attention(q, kv[2], kv[3]).float()
        return ((1 - a4) * o0 + a4 * o1).to(bf)
    return (lambda: A.flash2_fwd(q, *kv, alpha),
            lambda: A.flash2_fwd_plain(q, *kv, alpha),
            lambda: A.sdpa2_eager(*f32, alpha),
            lambda: A.flash2_fwd(*f32, alpha), library, (flops, nbytes),
            None)


def _bf16_bwd_case(torch, row, base, shape, dev, g):
    """``_bf16_case`` for the backward rows: K5b and K2 on bf16 x and g
    (the reference: the plain version at 'highest' on the same values),
    K4a and K4b on bf16 q, k, v, dO with the plain forward's out and lse
    (the reference: the f32 plain on the same values; K4b's library call
    autograd through SDPA at bf16, the forward excluded). K4b's results
    are (dk, dv)."""
    import torch.nn.functional as F
    from afldm_tpu_torch.ops import attention as A
    from afldm_tpu_torch.ops import filtered_act as FA
    bf = torch.bfloat16
    if base.startswith("filtered_act"):
        level = dict((r, lv) for r, _, lv in BF16_ROWS)[row]
        x, gr = (torch.randn(shape, device=dev, generator=g).to(bf)
                 for _ in range(2))
        xf, gf = x.float(), gr.float()
        fn, plain = getattr(FA, base), getattr(FA, f"{base}_plain")
        flops, _ = filtered_act_bwd_work(shape)
        n, c, h, w = shape
        # x, g and dx at 2 bytes, the six operators at 4
        nbytes = 3 * 2 * n * c * h * w + 4 * (6 * h * h + 6 * w * w)
        return (lambda: fn(x, gr, "silu"),
                lambda: plain(x, gr, "silu", level),
                lambda: plain(x, gr, "silu", "highest"),
                lambda: fn(xf, gf, "silu"), None, (flops, nbytes), None)
    n, heads, L, Lk, d, n_kv = _flash_dims(shape)
    q, do = (torch.randn(n, heads, L, d, device=dev, generator=g).to(bf)
             for _ in range(2))
    k, v = (torch.randn(n_kv, heads, Lk, d, device=dev, generator=g).to(bf)
            .expand(n, -1, -1, -1) for _ in range(2))
    out, lse = A._attention_plain(q, k, v)
    delta = A._delta(do, out)
    f32 = [t.float() for t in (q, k, v, do)]
    scale = 1.0 / d ** 0.5
    flops, _ = flash_bwd_work(base, shape)
    rows = n * heads * L
    # q, dO and the unique K/V rows at 2 bytes, lse and delta at 4; dq, or
    # dk and dv dense per image, at 2
    reads = 2 * (2 * rows * d + 2 * n_kv * heads * Lk * d) + 4 * 2 * rows
    if base == "flash_bwd_dq":
        return (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta),
                lambda: A._bwd_dq_plain(q, k, v, do, lse, delta, scale),
                lambda: A._bwd_dq_plain(*f32, lse, delta, scale),
                lambda: A.flash_bwd_dq(*f32, lse, delta), None,
                (flops, reads + 2 * rows * d), None)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl)
    return (lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: A._bwd_dkv_plain(q, k, v, do, lse, delta, scale),
            lambda: A._bwd_dkv_plain(*f32, lse, delta, scale),
            lambda: A.flash_bwd_dkv(*f32, lse, delta),
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                        retain_graph=True),
            (flops, reads + 2 * 2 * n * heads * Lk * d), None)


def _flat(torch, t):
    """A result as one flat tensor (K4b's (dk, dv) concatenated)."""
    if isinstance(t, tuple):
        return torch.cat([x.flatten() for x in t])
    return t


def bf16_bound_ms(flops, nbytes, level):
    """The bound of a bf16-activation variant: its products' FLOPs at the
    f32 rate ('highest': f32 products), at the bf16 dense tensor rate times
    the level's passes, or (the flash kernels, level None) once at the bf16
    rate; or its bytes over HBM."""
    if level == "highest":
        t_ops = flops / PEAK_F32_FLOPS
    else:
        t_ops = LEVEL_PASSES.get(level, 1) * flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_bf16_kernels(torch, report):
    """Phase 33: every bf16-activation variant at every shape of its
    KERNELS row against its plain version on the card, timed beside its
    plain version, its f32 kernel on the same values in float32 and the
    library call; fills the bf16 rows of ``report``."""
    from afldm_tpu_torch.ops import filtered_act as FA
    from afldm_tpu_torch.ops import set_af_precision
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    for row_name, base, level in BF16_ROWS:
        row = report[row_name]
        split = {"operations": 0.0, "bytes": 0.0}
        for shape in KERNELS[base]["shapes"]:
            if (level not in (None, "highest")
                    and max(shape[-2:]) > FA.LEVEL_MAX):
                log(f"check {row_name} {shape}: n/a, above {FA.LEVEL_MAX} "
                    "px the f32 products run at every level")
                continue
            run, plain, plain32, run32, library, work, lse_pair = \
                _bf16_case(torch, row_name, base, shape, dev, g)
            try:
                set_af_precision(level or "highest")
                got, want = _flat(torch, run()), _flat(torch, plain())
                assert got.dtype == want.dtype == torch.bfloat16
                ulps = bf16_ulps(torch, got, want, TOL[base][0])
                max_ulps = float(ulps.max())
                differ = float((got != want).double().mean())
                d = (got.float() - want.float())
                err = float(d.abs().max())
                if level is None:
                    _, e = torch.frexp(want.float().abs().max())
                    max_ulps = float(d.abs().max()) / 2.0 ** (int(e) - 8)
                    gap = want.float() - _flat(torch, plain32()).float()
                    gap_rms = float(gap.double().pow(2).mean().sqrt())
                    rms = float(d.double().pow(2).mean().sqrt())
                    ratio = rms / gap_rms if gap_rms else float("inf")
                    good = (ratio <= BF16_FLASH_RATIO
                            and max_ulps <= BF16_FLASH_ULPS)
                    verdict = (f"RMS ratio {ratio:.4f} (limit "
                               f"{BF16_FLASH_RATIO}; RMS err {rms:.3e}, "
                               f"bf16's own RMS {gap_rms:.3e}), max "
                               f"{max_ulps:.3f} ulps of the output's scale "
                               f"(limit {BF16_FLASH_ULPS}), share differing "
                               f"{differ:.2e}")
                    if lse_pair is not None:
                        lk, lp = lse_pair()
                        excess = float(((lk - lp).abs() - BF16_LSE_TOL
                                        * (1 + lp.abs())).max())
                        good = good and excess <= 0
                        verdict += (f", lse max |diff| "
                                    f"{float((lk - lp).abs().max()):.3e} "
                                    f"(limit {BF16_LSE_TOL} + "
                                    f"{BF16_LSE_TOL}·|lse|)")
                        del lk, lp
                    row["rms_ratio"] = max(row["rms_ratio"], ratio)
                    del gap
                elif level == "default":
                    own = want.float() - _flat(torch, plain32()).float()
                    own_rms = float(own.double().pow(2).mean().sqrt())
                    own_max = float(own.abs().max())
                    rms = float(d.double().pow(2).mean().sqrt())
                    ratio = rms / own_rms if own_rms else float("inf")
                    good = ratio <= LEVEL_RMS_RATIO and err <= own_max
                    verdict = (f"RMS ratio {ratio:.4f} (limit "
                               f"{LEVEL_RMS_RATIO}; the level's own RMS "
                               f"{own_rms:.3e}), max_abs_err within the "
                               f"level's own max {own_max:.3e}; max "
                               f"{max_ulps:.3f} ulp beyond atol, share "
                               f"differing {differ:.2e}")
                    row["rms_ratio"] = max(row["rms_ratio"], ratio)
                    del own
                else:
                    good = max_ulps <= 1 and differ <= BF16_ULP_SHARE
                    verdict = (f"max {max_ulps:.3f} ulp beyond atol "
                               f"{TOL[base][0]} (limit 1), share differing "
                               f"{differ:.2e} (limit {BF16_ULP_SHARE})")
                row["ulp_share"] = max(row["ulp_share"], differ)
                row["max_ulps"] = max(row["max_ulps"], max_ulps)
                del got, want, d, ulps
                t = time_ms(run)
                tp = time_ms(plain)
                t32 = time_ms(run32)
                tl = None if library is None else time_ms(library)
            finally:
                set_af_precision("highest")
            b, by = bf16_bound_ms(*work, level)
            log(f"check {row_name} {shape}: {verdict}, max_abs_err "
                f"{err:.3e} {'ok' if good else 'FAIL'}; kernel {t:.4f} ms, "
                f"its f32 kernel {t32:.4f} ms, plain {tp:.4f} ms, library "
                f"{'n/a' if tl is None else f'{tl:.4f} ms'}, bound "
                f"{b:.4f} ms ({by}-bound, {work[0] / 1e9:.3f} GFLOP, "
                f"{work[1] / 1e6:.3f} MB)")
            ok &= bool(good)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += t
            row["f32_ms"] += t32
            row["plain_ms"] += tp
            row["bound_ms"] += b
            split[by] += b
            if tl is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + tl
            del run, plain, plain32, run32, library, lse_pair
            torch.cuda.empty_cache()
        row["bound_by"] = max(split, key=split.get)
        log_sums(row_name, row, "its shapes")
        log(f"sum {row_name}: its f32 kernel {row['f32_ms']:.4f} ms")
    return ok


# the split bf16 K4b's reduction of its f32 partials: a row of its own
REDUCE_ROW = "flash_bwd_dkv_reduce"


def reduce_shapes():
    """(splits, 2, images, heads, Lk, D) of the partials of each
    FLASH_BWD_SHAPES case whose bf16 K4b splits its query walk."""
    from afldm_tpu_torch.ops import attention as A
    out = []
    for shape in FLASH_BWD_SHAPES:
        n, heads, L, Lk, d, _ = _flash_dims(shape)
        splits = A.flash_bwd_dkv_splits(n * heads, L, Lk, d)
        if splits > 1:
            out.append((splits, 2, n, heads, Lk, d))
    return out


def check_dkv_reduce(torch, report):
    """Phase 33's row of ``flash_bwd_dkv_reduce`` at each reduce_shapes
    partials, seeded: bit-identical to its plain version (the tolerance is
    0: both sum the same f32 values in split order and round once), timed
    beside it; bound the bytes (each partial read once, dk and dv written
    once at bf16); no library call computes the rounded sum in one."""
    from afldm_tpu_torch.ops import attention as A
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    row, ok = report[REDUCE_ROW], True
    split = {"operations": 0.0, "bytes": 0.0}
    for shape in reduce_shapes():
        ws = torch.randn(shape, device=dev, generator=g)
        got, want = A.flash_bwd_dkv_reduce(ws), A._dkv_reduce_plain(ws)
        err = float((got.float() - want.float()).abs().max())
        good = got.dtype == want.dtype and torch.equal(got, want)
        t = time_ms(lambda: A.flash_bwd_dkv_reduce(ws))
        tp = time_ms(lambda: A._dkv_reduce_plain(ws))
        nbytes = 4 * ws.numel() + 2 * want.numel()
        b, by = bound_ms(ws.numel() - want.numel(), nbytes)
        log(f"check {REDUCE_ROW} {shape}: max_abs_err {err:.3e} (limit 0: "
            f"bit-identical) {'ok' if good else 'FAIL'}; kernel {t:.4f} ms, "
            f"plain {tp:.4f} ms, library n/a, bound {b:.4f} ms ({by}-bound, "
            f"{nbytes / 1e6:.3f} MB)")
        ok &= bool(good)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += t
        row["plain_ms"] += tp
        row["bound_ms"] += b
        split[by] += b
        del ws, got, want
    row["bound_by"] = max(split, key=split.get)
    log_sums(REDUCE_ROW, row, "its shapes")
    return ok


def _launch_key(side, level, suffix=""):
    """The ``kernels.LAUNCHES`` key of one bf16 filtered activation (its
    forward, or with ``suffix`` '_bwd' its backward) on a ``side`` px map
    at ``level``: K5 / K5b up to PLANE_MAX px, K1 / K2 above, the reduced
    levels up to LEVEL_MAX px; None where H, W % 4 != 0 (the FFT chain)."""
    from afldm_tpu_torch.ops import filtered_act as FA
    if side % 4:
        return None
    route = "plane" if side <= FA.PLANE_MAX else "banded"
    lv = "highest" if side > FA.LEVEL_MAX else level
    return (f"filtered_act_{route}{suffix}"
            + ("" if lv == "highest" else f":{lv}") + "/bf16")


def reckon_filtered_launches(pipe, unet_forwards, decodes, level="highest"):
    """The filtered-activation launches that ``unet_forwards`` UNet
    forwards and ``decodes`` VAE decodes make, from the configs
    (``_unet_sites``, ``_vae_sites``), keyed by ``_launch_key``."""
    u, v = pipe.unet.config, pipe.vae.config
    per_unet = [a for part in _unet_sites(u, u.sample_size, False).values()
                for a in part[0]]
    _, per_decode, _ = _vae_sites(v, u.sample_size * v.downsample_ratio)
    counts = {}
    for runs, table in ((unet_forwards, per_unet), (decodes, per_decode)):
        for side, n_acts in table:
            key = _launch_key(side, level)
            if key:
                counts[key] = counts.get(key, 0) + runs * n_acts
    return counts


BF16_INTERP_KERNELS = ("filtered_act_plane/bf16", "filtered_act_banded/bf16",
                       "flash_fwd/bf16", "flash2_fwd/bf16")
# card vs CPU at bf16 on the tiny pipelines: RMS(card - CPU) at most this
# share of RMS(CPU at bf16 - CPU at f32), bf16's own error there, and so
# is the card's own error, RMS(card - CPU at f32); the PSNRs within
# BF16_TINY_DPSNR dB of the CPU's. Both devices round to bf16 after every
# layer, and a sum in another order that lands on the other side of a
# rounding edge flips a bf16 ulp, which the rest of the run amplifies as
# it amplifies its own roundings: two bf16 runs end about as far apart as
# either from f32 (measured on an H100: 0.90 for the protocol, 1.25 for
# the interp; the CPU tests find 0.95-1.01 between the port and JAX).
# A wrong kernel lands at the scale of the signal, far above
BF16_TINY_RATIO = 2.0
BF16_TINY_DPSNR = 0.5


def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def check_tiny_bf16(torch, what):
    """The tiny FFHQ pipeline at bf16 on the card and on the CPU with the
    same weights and inputs, and at f32 on the CPU: ``what`` 'protocol' (4
    steps, 4 shifts; images and PSNRs) or 'interp' (3 frames, 4 steps;
    latents and images)."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import (init_random_pipeline,
                                           shift_equivariance_eval)
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    cfgs = load_configs(tiny=True)
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn(1, 4, 8, 8, generator=gen)
    ends = torch.randn(2, 1, 4, 8, 8, generator=gen)
    out = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                    ("cpu", torch.float32)):
        pipe = init_random_pipeline(*cfgs, seed=0, device=dev, dtype=dt)
        kernels.reset_launch_counts()
        if what == "protocol":
            r = shift_equivariance_eval(pipe, init_latent=lat,
                                        num_inference_steps=4,
                                        num_shift_steps=4)
            out[dev, dt] = (torch.from_numpy(r.outputs), r.psnrs)
        else:
            la, im = _ffhq_interp(torch, pipe, ends, 3, 4)
            out[dev, dt] = (im.float().cpu(), la.float().cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    (card, c2), (cpu, p2), (f32, f2) = (out["cuda", torch.bfloat16],
                                        out["cpu", torch.bfloat16],
                                        out["cpu", torch.float32])
    ratio = _rms(card - cpu) / _rms(cpu - f32)
    accuracy = _rms(card - f32) / _rms(cpu - f32)
    if what == "protocol":
        d2 = float(np.abs(c2 - p2).max())
        gap2 = float(np.abs(p2 - f2).max())
        good2 = bool(np.isfinite(c2).all()) and d2 <= BF16_TINY_DPSNR
        second = (f"max |dPSNR| {d2:.3e} dB (limit {BF16_TINY_DPSNR}; CPU "
                  f"bf16 vs f32 {gap2:.3e} dB)")
        need = ("filtered_act_plane/bf16", "flash_fwd/bf16")
    else:
        r2 = _rms(c2 - p2) / _rms(p2 - f2)
        good2 = bool(torch.isfinite(c2).all()) and r2 <= BF16_TINY_RATIO
        second = f"latents RMS ratio {r2:.3f} (limit {BF16_TINY_RATIO})"
        need = ("filtered_act_plane/bf16", "flash_fwd/bf16",
                "flash2_fwd/bf16")
    missing = [k for k in need if k not in launched]
    ok = (ratio <= BF16_TINY_RATIO and accuracy <= BF16_TINY_RATIO and good2
          and not missing)
    log(f"tiny bf16 {what} (card vs CPU at bf16, the CPU's bf16 vs f32 as "
        f"the scale): images RMS ratio {ratio:.3f}, the card's against the "
        f"CPU's f32 {accuracy:.3f} (limit {BF16_TINY_RATIO} each), "
        f"{second}; launches {json.dumps(launched)} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# phase 34's runs of ``scripts.shift_ldm_ffhq``: (tag, extra flags,
# ``set_af_bf16_split`` during the run)
BF16_PROTOCOL_RUNS = (("bf16", [], False), ("bf16 + split", [], True),
                      ("bf16 at high", ["--af_precision", "high"], False),
                      ("bf16 at default", ["--af_precision", "default"],
                       False))


def run_bf16_protocol(torch, steps, f32_psnrs):
    """Phase 34: the FFHQ shift protocol at bf16 and full width through
    ``scripts.shift_ldm_ffhq --bf16`` (seed 0: the latent of phase 4),
    again with ``set_af_bf16_split(True)``, and at the reduced levels (the
    levels' bf16 variants). Returns (ok, [counts of each run])."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.ops import set_af_bf16_split, set_af_precision
    from afldm_tpu_torch.scripts import shift_ldm_ffhq
    ok, runs = True, []
    for tag, flags, split in BF16_PROTOCOL_RUNS:
        args = shift_ldm_ffhq.parse_args(
            ["--bf16", "--device", "cuda", "--num_inference_steps",
             str(steps), "--shift_steps", "16"] + flags)
        try:
            t0 = time.perf_counter()
            pipe = shift_ldm_ffhq.build(args)
            build = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            set_af_bf16_split(split)
            res = shift_ldm_ffhq.evaluate(pipe, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            set_af_bf16_split(False)
            set_af_precision("highest")
        counts = dict(kernels.LAUNCHES)
        runs.append(counts)
        want = reckon_filtered_launches(pipe, 2 * steps, 2,
                                        args.af_precision)
        got = {k: counts[k] for k in want}
        finite = bool(np.isfinite(res.psnrs).all()
                      and np.isfinite(res.outputs).all())
        delta = res.psnrs - f32_psnrs
        log(f"protocol {tag}: pipeline built in {build:.1f} s; 16 shifts x "
            f"{steps} steps in {wall:.2f} s wall; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean "
            f"PSNR {res.mean_psnr:.4f} dB, minus f32 (phase 4) "
            f"{float(delta.mean()):+.4f} dB")
        log(f"protocol {tag} PSNRs (dB): "
            + " ".join(f"{p:.3f}" for p in res.psnrs)
            + "; minus f32: " + " ".join(f"{p:+.3f}" for p in delta))
        log(f"protocol {tag} launches: {json.dumps(counts)}; filtered "
            f"activations reckoned from the configs {json.dumps(want)}")
        missing = _missing(f"protocol {tag}", counts,
                           [*want, "flash_fwd/bf16"])
        good = (finite and res.psnrs.shape == (16,) and got == want
                and not missing)
        if got != want:
            log(f"protocol {tag}: FAIL, launches {got} not as reckoned")
        if not good:
            log(f"protocol {tag}: FAIL")
        ok &= good
        del res, pipe
        torch.cuda.empty_cache()
    return ok, runs


def run_bf16_interp(torch, steps, n_frames=17):
    """Phase 35: the FFHQ interp path of phase 10 on a bf16 pipeline at
    ``steps`` DDIM steps."""
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.pipelines import init_random_pipeline
    from afldm_tpu_torch.scripts.shift_ldm_ffhq import load_configs
    pipe = init_random_pipeline(*load_configs(), seed=0, device="cuda",
                                dtype=torch.bfloat16)
    ends = torch.randn(2, 1, 4, 32, 32, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lat, img = _ffhq_interp(torch, pipe, ends, n_frames, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    finite = bool(torch.isfinite(lat).all() and torch.isfinite(img).all())
    # 2 inversions, 2 STORE passes and one interp pass; one decode
    want = reckon_filtered_launches(pipe, 5 * steps, 1)
    got = {k: counts[k] for k in want}
    log(f"FFHQ interp bf16: 2 inversions + 2 STORE passes + interp of "
        f"{n_frames} frames, {steps} steps each, and the decode in "
        f"{wall:.2f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; images "
        f"{tuple(img.shape)} {img.dtype} finite: {finite}")
    log(f"FFHQ interp bf16 launches: {json.dumps(counts)}; filtered "
        f"activations reckoned from the configs {json.dumps(want)}")
    missing = _missing("FFHQ interp bf16", counts, BF16_INTERP_KERNELS)
    ok = (finite and img.shape == (n_frames, 3, 256, 256) and got == want
          and not missing)
    if not ok:
        log("FFHQ interp bf16: FAIL")
    return ok, counts


# -- bf16 training --------------------------------------------------------

# the kernels each full-width bf16 training run must launch: the bf16
# variants of the forward and backward kernels (the LDM, I2SB and SD
# trainers; the AF-VAE's, whose attention is the D = 512 mid-block, has no
# flash launch)
BF16_TRAINING_KERNELS = ("filtered_act_plane/bf16", "flash_fwd/bf16",
                         "filtered_act_plane_bwd/bf16", "flash_bwd_dq/bf16",
                         "flash_bwd_dkv/bf16")
BF16_VAE_TRAINING_KERNELS = ("filtered_act_plane/bf16",
                             "filtered_act_banded/bf16",
                             "filtered_act_plane_bwd/bf16",
                             "filtered_act_banded_bwd/bf16")
# the backward kernels: the f32 ones must not launch in a bf16 step, and
# the bf16 ones launch as reckoned
F32_BWD_KERNELS = tuple(f"{k}{lv}" for k in ("filtered_act_plane_bwd",
                                             "filtered_act_banded_bwd")
                        for lv in ("", ":high", ":default")) + (
    "flash_bwd_dq", "flash_bwd_dkv")
BF16_BWD_KEYS = ("filtered_act_plane_bwd", "filtered_act_banded_bwd",
                 "flash_bwd_dq", "flash_bwd_dkv")


def _unet_sites(u, side0, sd):
    """{part: ([(side, filtered activations)], attention calls)} of one
    forward of a UNet config ``u`` on a ``side0`` px latent, part in
    'down', 'mid', 'up': two filtered activations a resnet (when the
    config filters them), one attention call an FFHQ-family attention
    layer, two (self and cross) an SD transformer layer."""
    n, lpb = len(u.block_out_channels), u.layers_per_block
    sides = [side0 // 2 ** i for i in range(n)]
    filt = u.alias_free if sd else u.resolved_filtered_act()
    per = 2 * getattr(u, "transformer_layers_per_block", 1) if sd else 1
    prefix = "CrossAttn" if sd else "Attn"
    down = ([(sides[i], 2 * lpb) for i in range(n)] if filt else [],
            per * sum(lpb for t in u.down_block_types
                      if t.startswith(prefix)))
    mid = ([(sides[-1], 4)] if filt else [],
           per * (1 if sd or u.add_attention else 0))
    up = ([(sides[n - 1 - i], 2 * (lpb + 1)) for i in range(n)]
          if filt else [],
          per * sum(lpb + 1 for t in getattr(u, "up_block_types", ())
                    if t.startswith(prefix)))
    return {"down": down, "mid": mid, "up": up}


def _vae_sites(v, res):
    """[(side, filtered activations)] of one encode and of one decode of an
    AF-VAE config ``v`` on ``res`` px images, and the flash attention calls
    of each: its mid-block's single head, flash up to D = 256 (the tiny
    VAE's 16), the plain version above (``model_afvae.json``'s 512)."""
    n, lpb = len(v.block_out_channels), v.layers_per_block
    z = res // 2 ** (n - 1)
    enc = [(res // 2 ** i, 2 * lpb) for i in range(n)
           if v.alias_free and v.down_filtered_act[i]]
    dec = [(z * 2 ** i, 2 * (lpb + 1)) for i in range(n)
           if v.alias_free and v.up_filtered_act[i]]
    if v.alias_free and v.mid_act:
        enc.append((z, 4))
        dec.append((z, 4))
    attn = int(v.mid_block_add_attention
               and v.block_out_channels[-1] <= 256)
    return enc, dec, attn


def reckon_bwd_launches(tr, name):
    """The bf16 backward launches one training micro-step of trainer
    ``name`` makes, from its configs: K5b (up to 64 px) or K2 (above) once
    for every filtered activation with H, W % 4 == 0, and K4a and K4b once
    each for every flash attention, in every model pass that is
    differentiated: the UNet's two passes (the prediction and the shifted
    CFA pass) of the LDM, I2SB and SD text trainers; the ControlNet's two
    and the UNet's up blocks in both (the ControlNet trainer trains only
    those, and its residuals enter there); the AF-VAE's two encodes and two
    decodes (with the shift loss; one each without). Recompute under
    gradient checkpointing adds forward launches, not backward ones."""
    level = tr.base_cfg.af_precision or "highest"
    counts = {f"{k}{'' if level == 'highest' else f':{level}'}/bf16": 0
              for k in BF16_BWD_KEYS}
    counts.update({f"{k}/bf16": 0 for k in BF16_BWD_KEYS})

    def add(sites, passes):
        for side, n_acts in sites:
            key = _launch_key(side, level, "_bwd")
            if key:
                counts[key] += passes * n_acts

    res = tr.base_cfg.resolution
    if name == "vae":
        enc, dec, attn = _vae_sites(tr.vae_config, res)
        passes = 2 if tr.cfg.use_shift_loss else 1
        add(enc, passes)
        add(dec, passes)
        counts["flash_bwd_dq/bf16"] += 2 * passes * attn
        counts["flash_bwd_dkv/bf16"] += 2 * passes * attn
        return counts
    side0 = res // tr.vae_config.downsample_ratio
    sd = name in ("sd_text", "norm_controlnet")
    sites = _unet_sites(tr.unet_config, side0, sd)
    shifted = (tr.cfg.use_cfa if name == "i2sb"
               else tr.cfg.use_shift_loss)
    passes = 2 if shifted else 1
    parts = [(sites[p], passes) for p in (("up",) if name ==
                                          "norm_controlnet"
                                          else ("down", "mid", "up"))]
    if name == "norm_controlnet":
        cn = _unet_sites(tr.controlnet.config, side0, True)
        parts += [(cn["down"], passes), (cn["mid"], passes)]
    for (acts, attn), n_passes in parts:
        add(acts, n_passes)
        counts["flash_bwd_dq/bf16"] += n_passes * attn
        counts["flash_bwd_dkv/bf16"] += n_passes * attn
    return counts


def _bf16_launches_as_reckoned(tag, tr, name, counts, n_steps, needed):
    """Logs the bf16 backward launches against ``reckon_bwd_launches`` over
    ``n_steps`` micro-steps; returns what failed: a kernel of ``needed``
    never launched, a backward count off the reckoning, or a launch of an
    f32 backward kernel."""
    per_step = reckon_bwd_launches(tr, name)
    want = {k: n_steps * v for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    f32 = {k: counts[k] for k in F32_BWD_KERNELS if counts[k]}
    log(f"{tag}: bf16 backward launches {json.dumps(got)}, reckoned "
        f"{json.dumps(want)} ({n_steps} micro-steps); f32 backward "
        f"launches {json.dumps(f32) if f32 else 'none'}")
    failed = _missing(tag, counts, needed)
    if got != want:
        log(f"{tag}: FAIL, the bf16 backward launches are not as reckoned")
        failed = failed + ["reckoning"]
    if f32:
        log(f"{tag}: FAIL, f32 backward kernels launched: {sorted(f32)}")
        failed = failed + sorted(f32)
    return failed


# phase 36's floors of a loss's bf16 - f32 gap, as shares of the loss
LOSS_FLOOR = 2.0 ** -8
LOOSE_LOSS_FLOOR = 2.0 ** -6
LOOSE_LOSS_KEYS = ("shift_loss", "d_weight", "disc_loss", "train_loss")
# phase 36's floor of the bf16 - f32 gap of each gradient norm that forms
# the AF-VAE's d_weight, as a share of the norm (one bf16 ulp)
NORM_FLOOR = 2.0 ** -8
# the CPU's thread counts over which phase 36 reads its bf16 references'
# own spread, besides the host's
SPREAD_THREADS = (1, 2, 4)


def check_tiny_bf16_training(torch):
    """Phase 36: one step of the tiny LDM (64 px), AF-VAE (128 px, the
    banded pair) and I2SB, SD text and normal-ControlNet trainers (64 px)
    at ``mixed_precision="bf16"`` from the same weights, images and draws
    on the card (the bf16 kernels) and on the CPU (their plain versions),
    and at f32 on the CPU: the losses and the gradients of the trained
    modules held to the CPU's own bf16 - f32 gap. Each loss within
    BF16_TINY_RATIO of its gap, the gap floored at a share of the loss,
    LOSS_FLOOR (one bf16 ulp, 2^-8) for a plain mean (the MSEs, KL, the
    perceptual loss), LOOSE_LOSS_FLOOR (four ulps, 2^-6) for the keys of
    LOOSE_LOSS_KEYS, and at the bf16 reference's own spread: the same CPU
    step at bf16 on SPREAD_THREADS threads and the host's, whose sums run
    in other orders. A loss is a mean of bf16 outputs whose errors may
    cancel, so its bf16 - f32 gap can fall well below the difference of
    two bf16 runs, most of all for a loss of a difference (the shift
    losses) or a ratio of gradient norms (the GAN weight d_weight, and so
    the total it multiplies into): the tiny AF-VAE's d_weight at bf16
    moves by per cents with the CPU's thread count alone. The gradients' RMS
    difference, over all the trained tensors of a trainer (at the host's
    thread count), within BF16_TINY_RATIO of their RMS gap, and each
    tensor's within 2 BF16_TINY_RATIO of its own (floored at 1e-2 of the
    largest tensor's gap: the attention's to_k biases have a gradient of
    zero in exact arithmetic); the card must launch the bf16 backward
    kernels and no f32 one."""
    import numpy as np
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch import train as T
    batches = {r: next(T.epoch_batches(T.SyntheticDataset(resolution=r,
                                                          length=2), 2))
               for r in (64, 128)}
    for b in batches.values():
        b["caption"] = np.array(["a red car", "a blue bird"])
        b["normal"] = b["input"][:, ::-1].copy()
    host = torch.get_num_threads()
    runs = [("cuda", "bf16", host), ("cpu", "bf16", host),
            ("cpu", None, host),
            *(("cpu", "bf16", t) for t in SPREAD_THREADS if t != host)]
    ok = True
    for name in ("ldm", "vae", *NEW_TRAINERS):
        res = {}
        for dev, mp, threads in runs:
            torch.set_num_threads(threads)
            try:
                res[(dev, mp, threads)] = _tiny_bf16_step(
                    torch, kernels, name, dev, mp, batches)
            finally:
                torch.set_num_threads(host)
        (lc, gc, launched, nc), (lb, gb, _, nb), (lf, gf, _, nf) = (
            res[r] for r in runs[:3])
        refs = {r[2]: res[r][0] for r in runs if r[:2] == ("cpu", "bf16")}
        spread = {k: max(r[k] for r in refs.values())
                  - min(r[k] for r in refs.values()) for k in lb}
        loss_ratios = {
            k: abs(lc[k] - lb[k]) / max(
                abs(lb[k] - lf[k]), spread[k], 1e-12, abs(lb[k]) * (
                    LOOSE_LOSS_FLOOR if k in LOOSE_LOSS_KEYS else LOSS_FLOOR))
            for k in lb}
        # the AF-VAE's d_weight norms, each held apart at its own floor
        norm_refs = [res[r][3] for r in runs if r[:2] == ("cpu", "bf16")]
        norm_ratios = {
            k: abs(nc[k] - nb[k]) / max(
                abs(nb[k] - nf[k]), max(r[k] for r in norm_refs)
                - min(r[k] for r in norm_refs), 1e-12,
                abs(nb[k]) * NORM_FLOOR)
            for k in nb}
        worst_norm = max(norm_ratios.values(), default=0.0)
        worst_key = max(loss_ratios, key=loss_ratios.get)
        worst_loss = loss_ratios[worst_key]
        d_all = np.sqrt(sum(float((gc[n] - gb[n]).double().pow(2).sum())
                            for n in gb))
        gap_all = np.sqrt(sum(float((gb[n] - gf[n]).double().pow(2).sum())
                              for n in gb))
        ratio_all = d_all / gap_all
        floor = 1e-2 * max(_rms(gb[n] - gf[n]) for n in gb)
        worst, worst_name = 0.0, None
        for n in gb:
            r = _rms(gc[n] - gb[n]) / max(_rms(gb[n] - gf[n]), floor)
            if r > worst:
                worst, worst_name = r, n
        f32 = sorted(k for k in F32_BWD_KERNELS if launched[k])
        bf = [k for k in launched if k.endswith("/bf16") and "_bwd" in k
              and launched[k]]
        good = (all(np.isfinite(v) for v in lc.values())
                and set(gc) == set(gb) and worst_loss <= BF16_TINY_RATIO
                and ratio_all <= BF16_TINY_RATIO
                and worst <= 2 * BF16_TINY_RATIO and not f32 and bf
                and worst_norm <= BF16_TINY_RATIO)
        log(f"tiny {name} training at bf16 (card vs CPU, one step): losses "
            f"{json.dumps(lc)}; worst loss difference {worst_loss:.3f} of "
            f"the CPU's own bf16 - f32 gap at {worst_key} (limit "
            f"{BF16_TINY_RATIO}; CPU at bf16 {lb[worst_key]:.6g}, at f32 "
            f"{lf[worst_key]:.6g}, at bf16 on "
            + ", ".join(f"{t} threads {r[worst_key]:.6g}"
                        for t, r in refs.items())
            + "; each: "
            + " ".join(f"{k} {v:.3f}" for k, v in loss_ratios.items())
            + "; the bf16 references' spread, each: "
            + " ".join(f"{k} {v:.6g}" for k, v in spread.items())
            + "); "
            + ("d_weight's gradient norms (card, CPU at bf16, at f32; "
               "difference / gap, limit "
               f"{BF16_TINY_RATIO}, floor {NORM_FLOOR} of the norm): "
               + " ".join(f"{k} {nc[k]:.6g} {nb[k]:.6g} {nf[k]:.6g} "
                          f"{norm_ratios[k]:.3f}" for k in nb) + "; "
               if nb else "")
            + f"gradients' RMS difference {ratio_all:.3f} of their RMS gap "
            f"(limit {BF16_TINY_RATIO}) over {len(gb)} tensors, worst "
            f"tensor {worst:.3f} at {worst_name} (limit "
            f"{2 * BF16_TINY_RATIO}); bf16 backward launches "
            f"{json.dumps({k: launched[k] for k in bf})}, f32 backward "
            f"launches {f32 or 'none'} {'ok' if good else 'FAIL'}")
        ok &= bool(good)
    return ok


# phase 36's controls: faults that it must fail
CONTROLS = ("f32_attention", "dk")


@contextlib.contextmanager
def planted_fault(control):
    """One of CONTROLS planted in the attention: 'f32_attention' computes
    the CPU's bf16 forward attention in f32, its output rounded once to
    bf16 (the card keeps K3/bf16); 'dk' scales the card's bf16 dk (K4b's)
    by 1.25."""
    from afldm_tpu_torch.ops import attention as A
    fwd, dkv = A.flash_fwd, A.flash_bwd_dkv

    def f32_fwd(q, k, v, scale=None):
        if q.device.type == "cpu" and A._all_bf16((q, k, v)):
            out, lse = A._attention_plain(q.float(), k.float(), v.float(),
                                          scale)
            return out.to(q.dtype), lse
        return fwd(q, k, v, scale)

    def bad_dkv(*args, **kwargs):
        dk, dv = dkv(*args, **kwargs)
        return (dk * 1.25 if dk.is_cuda else dk), dv

    if control == "f32_attention":
        A.flash_fwd = f32_fwd
    else:
        A.flash_bwd_dkv = bad_dkv
    try:
        yield
    finally:
        A.flash_fwd, A.flash_bwd_dkv = fwd, dkv


def _tiny_bf16_step(torch, kernels, name, dev, mp, batches):
    """Phase 36's step of the tiny trainer ``name`` on ``dev`` at ``mp``:
    (its logged losses, the gradients of its trained modules on the CPU,
    the card's launch counts of the step or None on the CPU, and for the
    AF-VAE the two gradient norms of its d_weight, ``adaptive_norms``, on
    the step's draws; else {})."""
    if name == "ldm":
        tr = _tiny_trainer(dev, mp)
    elif name == "vae":
        tr = _tiny_vae_trainer(dev, mp)
    else:
        tr = _tiny_new_trainer(torch, name, dev, mp)
    batch = batches[128 if name == "vae" else 64]
    if dev == "cuda":
        kernels.reset_launch_counts()
    if name == "vae":
        x = torch.from_numpy(batch["input"]).permute(
            0, 3, 1, 2).contiguous().to(tr.device)
        draws = tr.draw(0, 2)
        norms = dict(zip(("rec_grad_norm", "gan_grad_norm"),
                         (float(n) for n in tr.adaptive_norms(x, draws))))
        logs = tr.generator_backward(x, draws)
        mods = {"vae": tr.vae}
    else:
        norms = {}
        loss, logs = _trainer_loss(torch, tr, name, 0, batch)
        loss.backward()
        mods = _trainer_modules(tr)
    launched = None
    if dev == "cuda":
        torch.cuda.synchronize()
        launched = dict(kernels.LAUNCHES)
    return ({k: float(v) for k, v in logs.items()},
            {f"{m}.{n}": p.grad.detach().float().cpu()
             for m, mod in mods.items() for n, p in mod.named_parameters()
             if p.grad is not None},
            launched, norms)


def log_bf16_ratios(stats):
    """The bf16 runs' median step and peak memory against the f32 runs'
    of the same trainers in this call."""
    for name in stats.get("bf16", {}):
        b, f = stats["bf16"][name], stats["f32"].get(name)
        if not f:
            continue
        log(f"bf16/f32 {name} training: median step {b['median_s']:.3f} / "
            f"{f['median_s']:.3f} s = {b['median_s'] / f['median_s']:.3f}, "
            f"peak memory {b['peak_gib']:.2f} / {f['peak_gib']:.2f} GiB = "
            f"{b['peak_gib'] / f['peak_gib']:.3f}")


# -- phases 38-39: P1 and P2 at bf16, and the bench scripts ----------------

# the probes' bf16 rows: each takes its f32 row's KERNELS shapes
PROBE_BF16_ROWS = ("flash_probe_dots/bf16", "flash_probe_stream/bf16")


def check_bf16_probes(torch, report):
    """Phase 38: P1 and P2 at bf16 at their KERNELS shapes against their
    plain bf16 versions on the card: the RMS of (kernel - plain) at most
    BF16_FLASH_RATIO of the RMS of (plain - the f32 plain on the same
    values), K3/bf16's limit; the largest difference in bf16 ulps of the
    element logged. Each timed beside its plain version, its f32 kernel on
    the same values and, for P1, the library call (two bf16 matmuls, the
    scores rounded to bf16 between them); fills the rows of ``report``."""
    from afldm_tpu_torch.ops import flash_probes as P
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    bf = torch.bfloat16
    ok = True
    for row_name in PROBE_BF16_ROWS:
        base = row_name.split("/")[0]
        row = report[row_name]
        split = {"operations": 0.0, "bytes": 0.0}
        fn, plain = getattr(P, base), getattr(P, f"{base}_plain")
        for shape in KERNELS[base]["shapes"]:
            n, heads, L, Lk, d, n_kv = _flash_dims(shape)
            q = torch.randn(n, heads, L, d, device=dev, generator=g).to(bf)
            k, v = (torch.randn(n_kv, heads, Lk, d, device=dev,
                                generator=g).to(bf).expand(n, -1, -1, -1)
                    for _ in range(2))
            f32 = [t.float() for t in (q, k, v)]
            got, want = fn(q, k, v), plain(q, k, v)
            assert got.dtype == want.dtype == bf
            diff = got.float() - want.float()
            gap = want.float() - plain(*f32)
            rms, gap_rms = (float(t.double().pow(2).mean().sqrt())
                            for t in (diff, gap))
            ratio = rms / gap_rms if gap_rms else float("inf")
            max_ulps = float(bf16_ulps(torch, got, want).max())
            differ = float((got != want).double().mean())
            err = float(diff.abs().max())
            good = ratio <= BF16_FLASH_RATIO
            del got, want, diff, gap
            library = None
            if base == "flash_probe_dots":
                def library():  # the scores rounded to bf16 by the matmul
                    return torch.matmul(torch.matmul(q, k.transpose(-1, -2)),
                                        v)
            t = time_ms(lambda: fn(q, k, v))
            tp = time_ms(lambda: plain(q, k, v))
            t32 = time_ms(lambda: fn(*f32))
            tl = None if library is None else time_ms(library)
            flops, _ = probe_work(base, shape)
            # q, the unique K/V rows and out at 2 bytes
            nbytes = 2 * (2 * n * heads * L * d + 2 * n_kv * heads * Lk * d)
            b, by = bf16_bound_ms(flops, nbytes, None)
            log(f"check {row_name} {shape}: RMS ratio {ratio:.4f} (limit "
                f"{BF16_FLASH_RATIO}; RMS err {rms:.3e}, bf16's own RMS "
                f"{gap_rms:.3e}), max {max_ulps:.3f} bf16 ulps of the "
                f"element, share differing {differ:.2e}, max_abs_err "
                f"{err:.3e} {'ok' if good else 'FAIL'}; kernel {t:.4f} ms, "
                f"its f32 kernel {t32:.4f} ms, plain {tp:.4f} ms, library "
                f"{'n/a' if tl is None else f'{tl:.4f} ms'}, bound "
                f"{b:.4f} ms ({by}-bound, {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.3f} MB)")
            ok &= bool(good)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["rms_ratio"] = max(row["rms_ratio"], ratio)
            row["max_ulps"] = max(row["max_ulps"], max_ulps)
            row["ulp_share"] = max(row["ulp_share"], differ)
            row["ms"] += t
            row["f32_ms"] += t32
            row["plain_ms"] += tp
            row["bound_ms"] += b
            split[by] += b
            if tl is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + tl
            del q, k, v, f32, library
            torch.cuda.empty_cache()
        row["bound_by"] = max(split, key=split.get)
        log_sums(row_name, row, "its shapes")
        log(f"sum {row_name}: its f32 kernel {row['f32_ms']:.4f} ms")
    return ok


def _numbers(obj):
    """Every int or float inside a script's result (dicts, lists)."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _numbers(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _numbers(v)]
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return [obj]
    return []


# phase 39: each bench script at a small configuration on the card, with
# the kernels it exists to time. The JAX scripts' --tiny where they have
# one (bench_interp_denoise, run_all_benchmarks), else few iterations (the
# kernel and attention benches at their full shapes; the whole-model
# benches at full width with a small batch, few steps or frames)
BENCH_SCRIPTS = (
    ("bench_attention", ["--iters", "3", "--grad"],
     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("bench_filtered_act", ["--iters", "3", "--grad"],
     ("filtered_act_plane", "filtered_act_banded", "filtered_act_plane_bwd",
      "filtered_act_banded_bwd")),
    ("bench_sdpa2", ["--iters", "3", "--dtype", "bf16"],
     ("flash_fwd/bf16", "flash2_fwd/bf16")),
    ("bench_flash_bwd_sweep", ["--iters", "3"],
     ("flash_fwd/bf16", "flash_bwd_dq/bf16", "flash_bwd_dkv/bf16")),
    ("bench_train", ["--batch", "2", "--steps", "1", "--no_shift_loss"],
     ("filtered_act_plane", "filtered_act_banded", "flash_fwd",
      "filtered_act_plane_bwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("roofline_denoise", ["--batch", "1", "--iters", "1", "--repeats", "1"],
     ("filtered_act_plane/bf16", "filtered_act_plane:high/bf16",
      "filtered_act_plane:default/bf16", "flash_fwd/bf16")),
    ("bench_interp_denoise", ["--tiny", "--frames", "3", "--steps", "2",
                              "--iters", "1"],
     ("filtered_act_plane/bf16", "flash_fwd/bf16")),
    ("bench_pipelines", ["--frames", "2", "--resolution", "256", "--steps",
                         "2", "--interp_frames", "2"],
     ("filtered_act_plane", "filtered_act_banded", "flash_fwd")),
    ("run_all_benchmarks", ["--tiny", "--steps", "2", "--shift_steps", "2"],
     ("filtered_act_plane", "flash_fwd")),
)


def run_bench_scripts(torch):
    """Phase 39: each of BENCH_SCRIPTS through its ``main(argv)`` on the
    card, its output under results/chip_smoke_scripts_torch/, counters set
    to 0 just before and read just after: every number it returns finite
    and the kernels it times launched. Returns (ok, [counts])."""
    import importlib
    import math
    from afldm_tpu_torch import kernels
    out_dir = REPO / "results" / "chip_smoke_scripts_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    ok, all_counts = True, []
    for name, argv, needed in BENCH_SCRIPTS:
        mod = importlib.import_module(f"afldm_tpu_torch.scripts.{name}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = mod.main([*argv, "--out", str(out_dir / f"{name}.json")])
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        all_counts.append(counts)
        nums = _numbers(result)
        finite = bool(nums) and all(math.isfinite(x) for x in nums)
        missing = _missing(f"script {name}", counts, needed)
        launched = {k: v for k, v in counts.items() if v}
        log(f"script {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f}"
            f" s wall, {len(nums)} numbers, all finite: {finite}; result "
            f"{json.dumps(result)}; launches {json.dumps(launched)}")
        good = finite and not missing
        if not good:
            log(f"script {name}: FAIL")
        ok &= good
        torch.cuda.empty_cache()
    return ok, all_counts


def _lap_timer():
    """``lap(label)`` logs the wall time since the previous lap."""
    last = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        log(f"phase time: {label} {now - last[0]:.1f} s")
        last[0] = now
    return lap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the serving path (default 50)")
    ap.add_argument("--train_steps", type=int, default=4,
                    help="steps of the full-width training path (default 4)")
    ap.add_argument("--vae_steps", type=int, default=8,
                    help="micro-steps of the full-width VAE training path "
                         "(default 8: 4 updates, the first ones far into "
                         "the lr warmup)")
    ap.add_argument("--interp_steps", type=int, default=20,
                    help="DDIM steps of the full-width FFHQ interp path "
                         "(default 20)")
    ap.add_argument("--sd_frames", type=int, default=17,
                    help="frames of the full-width SD interpolation "
                         "(default 17)")
    ap.add_argument("--sd_steps", type=int, default=10,
                    help="DDIM steps of the full-width SD interpolation "
                         "(default 10)")
    ap.add_argument("--serve_steps", type=int, default=20,
                    help="DDIM steps of each full-width service request "
                         "(default 20)")
    ap.add_argument("--sr_steps", type=int, default=20,
                    help="I2SB steps of the full-width SR protocol "
                         "(default 20)")
    ap.add_argument("--video_frames", type=int, default=8,
                    help="frames of the full-width video editing (default "
                         "8, the CLI's)")
    ap.add_argument("--video_steps", type=int, default=10,
                    help="DDIM steps of the full-width video editing, at "
                         "strength 0.7 (default 10: 7 denoise steps)")
    ap.add_argument("--normal_shifts", type=int, default=16,
                    help="shifts of the full-width normal estimation "
                         "(default 16)")
    ap.add_argument("--trainer_steps", type=int, default=3,
                    help="steps of each full-width I2SB, SD text and "
                         "normal-ControlNet trainer (default 3)")
    ap.add_argument("--eq_samples", type=int, default=4,
                    help="samples of the full-width EQ metrics (default 4)")
    ap.add_argument("--eq_steps", type=int, default=10,
                    help="DDIM steps of each EQ generation (default 10; the "
                         "CLI's 20)")
    ap.add_argument("--afp_steps", type=int, default=20,
                    help="DDIM steps of the full-width af_precision eval "
                         "(default 20; the CLI's 50)")
    ap.add_argument("--afp_shifts", type=int, default=4,
                    help="shifts of the full-width af_precision eval "
                         "(default 4; the CLI's 8)")
    ap.add_argument("--afp_vae_steps", type=int, default=4,
                    help="micro-steps of the AF-VAE trainer at each level "
                         "(default 4)")
    ap.add_argument("--bf16_interp_steps", type=int, default=10,
                    help="DDIM steps of the full-width FFHQ interp on a "
                         "bf16 pipeline (default 10)")
    ap.add_argument("--control", choices=CONTROLS, default=None,
                    help="run phase 36 alone with this fault planted and "
                         "exit 0 only if it fails (no result line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not (REPO / "afldm_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: afldm_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from afldm_tpu_torch import kernels
    from afldm_tpu_torch.ops import set_af_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{n} {t:.1f} s" for n, t in
                    kernels.BUILD_SECONDS.items()) + ")")
    for name in kernels.SOURCES:
        for fn, line in ptxas_lines(kernels.build_log(name)):
            log(f"  ptxas {name} {fn}: {line}")

    set_af_precision("highest")
    if args.control:
        with planted_fault(args.control):
            caught = not check_tiny_bf16_training(torch)
        log(f"phase 36 with the {args.control} fault planted: "
            + ("failed, as it must" if caught else "PASSED: FAIL"))
        return 0 if caught else 1
    report = {k: dict(name=k, route=v["route"], source=v["source"],
                      replaces=v["replaces"], launches=0, max_abs_err=0.0,
                      ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
                      library_ms=None)
              for k, v in KERNELS.items()}
    for k in LEVEL_KERNELS:  # the bf16 variants: rows of their own
        for level in LEVELS:
            report[f"{k}:{level}"] = dict(
                report[k], name=f"{k}:{level}", rms_ratio=0.0,
                source=LEVEL_SOURCES.get(k, report[k]["source"]))
    for row, base, level in BF16_ROWS:  # the bf16-activation variants
        src = report[base]["source"] if level == "highest" else \
            LEVEL_SOURCES.get(base, report[base]["source"])
        report[row] = dict(report[base], name=row, rms_ratio=0.0,
                           ulp_share=0.0, max_ulps=0, f32_ms=0.0, source=src)
    for row in PROBE_BF16_ROWS:  # the probes' bf16 variants
        base = row.split("/")[0]
        report[row] = dict(report[base], name=row, rms_ratio=0.0,
                           ulp_share=0.0, max_ulps=0, f32_ms=0.0)
    report[REDUCE_ROW] = dict(report["flash_bwd_dkv"], name=REDUCE_ROW)
    lap = _lap_timer()
    ok = check_kernels(torch, report)
    lap("kernel check (phase 1)")
    ok &= check_tiny_reference(torch)
    main_ok, counts, f32_psnrs = run_main_path(torch, args.steps)
    ok &= main_ok
    torch.cuda.empty_cache()
    lap("tiny reference and the main path")
    ok &= check_tiny_training(torch)
    stats = {"f32": {}, "bf16": {}}
    train_ok, train_counts = run_training(
        torch, args.train_steps, stats=stats["f32"].setdefault("ldm", {}))
    ok &= train_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_vae_training(torch)
    vae_ok, vae_counts = run_vae_training(
        torch, args.vae_steps, stats=stats["f32"].setdefault("vae", {}))
    ok &= vae_ok
    torch.cuda.empty_cache()
    lap("LDM and AF-VAE training")
    ok &= check_tiny_interp(torch)
    interp_ok, interp_counts = run_ffhq_interp(torch, args.interp_steps)
    ok &= interp_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_sd_interp(torch)
    sd_ok, sd_counts = run_sd_interp(torch, args.sd_frames, args.sd_steps)
    ok &= sd_ok
    torch.cuda.empty_cache()
    lap("FFHQ and SD interpolation")
    sweep_ok, sweep_counts = run_sweep(torch, "f32")
    ok &= sweep_ok
    torch.cuda.empty_cache()
    head_ok, head_counts = run_headline(torch)
    ok &= head_ok
    ok &= check_tiny_service(torch)
    serve_ok, serve_counts = run_service(torch, args.serve_steps)
    ok &= serve_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_sr(torch)
    sr_ok, sr_counts = run_sr(torch, args.sr_steps)
    ok &= sr_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_video_editing(torch)
    video_ok, video_counts = run_video_editing(torch, args.video_frames,
                                               args.video_steps)
    ok &= video_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_normal(torch)
    normal_ok, normal_counts = run_normal_estimation(torch,
                                                     args.normal_shifts)
    ok &= normal_ok
    torch.cuda.empty_cache()
    lap("sweep, headline, service, SR, video editing, normals")
    ok &= check_tiny_new_trainers(torch)
    ok &= check_text_encoder(torch)
    ok &= check_sd_round_trip(torch)
    new_counts = []
    sd_state = None
    for name in NEW_TRAINERS:
        if name != "i2sb" and sd_state is None:
            sd_state = _sd_states(torch)
        run_ok, run_counts = run_new_trainer(
            torch, name, args.trainer_steps, sd_state,
            stats=stats["f32"].setdefault(name, {}))
        ok &= run_ok
        new_counts.append(run_counts)
        torch.cuda.empty_cache()
    del sd_state
    lap("the I2SB, SD text and ControlNet trainers")
    ok &= check_shift_ops(torch)
    eq_ok, eq_counts, eq_pipe = run_equivariance(torch, args.eq_samples,
                                                 args.eq_steps)
    ok &= eq_ok
    seq_ok, seq_counts = run_sequential_protocol(torch, eq_pipe)
    ok &= seq_ok
    del eq_pipe
    torch.cuda.empty_cache()
    lap("shift ops, EQ metrics, sequential protocol")
    ok &= check_level_kernels(torch, report)
    time_resamplers(torch)
    lap("level kernels and resamplers")
    afp_ok, afp_counts = run_af_precision_eval(torch, args.afp_steps,
                                               args.afp_shifts)
    ok &= afp_ok
    torch.cuda.empty_cache()
    vlev_ok, vlev_counts = run_vae_training_level(torch, args.afp_vae_steps)
    ok &= vlev_ok
    torch.cuda.empty_cache()
    lap("af_precision eval, AF-VAE training at each level")
    ok &= check_bf16_kernels(torch, report)
    ok &= check_dkv_reduce(torch, report)
    lap("bf16 kernel check")
    ok &= check_tiny_bf16(torch, "protocol")
    bf_ok, bf_counts = run_bf16_protocol(torch, args.steps, f32_psnrs)
    ok &= bf_ok
    torch.cuda.empty_cache()
    ok &= check_tiny_bf16(torch, "interp")
    bfi_ok, bfi_counts = run_bf16_interp(torch, args.bf16_interp_steps)
    ok &= bfi_ok
    torch.cuda.empty_cache()
    lap("bf16 protocol and interp")
    ok &= check_tiny_bf16_training(torch)
    lap("tiny bf16 training")
    bf16_train_counts = []
    run_ok, run_counts = run_training(
        torch, args.train_steps, "bf16",
        stats["bf16"].setdefault("ldm", {}))
    ok &= run_ok
    bf16_train_counts.append(run_counts)
    torch.cuda.empty_cache()
    run_ok, run_counts = run_vae_training(
        torch, args.vae_steps, "bf16", stats["bf16"].setdefault("vae", {}))
    ok &= run_ok
    bf16_train_counts.append(run_counts)
    torch.cuda.empty_cache()
    sd_state = None
    for name in NEW_TRAINERS:
        if name != "i2sb" and sd_state is None:
            sd_state = _sd_states(torch)
        run_ok, run_counts = run_new_trainer(
            torch, name, args.trainer_steps, sd_state, "bf16",
            stats["bf16"].setdefault(name, {}))
        ok &= run_ok
        bf16_train_counts.append(run_counts)
        torch.cuda.empty_cache()
    del sd_state
    lap("bf16 training at full width")
    log_bf16_ratios(stats)
    ok &= check_bf16_probes(torch, report)
    bf_sweep_ok, bf_sweep_counts = run_sweep(torch, "bf16")
    ok &= bf_sweep_ok
    torch.cuda.empty_cache()
    lap("bf16 probes and the flash sweep at bf16")
    scripts_ok, script_counts = run_bench_scripts(torch)
    ok &= scripts_ok
    lap("the bench scripts")
    runs = (counts, train_counts, vae_counts, interp_counts, sd_counts,
            sweep_counts, head_counts, serve_counts, sr_counts, video_counts,
            normal_counts, *new_counts, eq_counts, seq_counts, *afp_counts,
            *vlev_counts, *bf_counts, bfi_counts, *bf16_train_counts,
            bf_sweep_counts)
    for k, row in report.items():
        row["launches"] = sum(c[k] for c in runs)
    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(report.values())}))
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
