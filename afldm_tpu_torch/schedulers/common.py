"""Shared beta-schedule construction (diffusers conventions), numpy only.
The port's own copy of ``afldm_tpu/schedulers/common.py``."""

import math

import numpy as np


def betas_for_alpha_bar(num_diffusion_timesteps, max_beta=0.999,
                        alpha_transform_type="cosine"):
    """ref i2sb_scheduler.py:48-90."""
    if alpha_transform_type == "cosine":
        def alpha_bar_fn(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    elif alpha_transform_type == "exp":
        def alpha_bar_fn(t):
            return math.exp(t * -12.0)
    else:
        raise ValueError(alpha_transform_type)
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar_fn(t2) / alpha_bar_fn(t1), max_beta))
    return np.asarray(betas, dtype=np.float32)


def rescale_zero_terminal_snr(betas):
    """ref i2sb_scheduler.py:94-128 (arXiv 2305.08891 Alg. 1)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)

    a0 = alphas_bar_sqrt[0].copy()
    aT = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = alphas_bar_sqrt - aT
    alphas_bar_sqrt = alphas_bar_sqrt * a0 / (a0 - aT)

    alphas_bar = alphas_bar_sqrt ** 2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return (1 - alphas).astype(np.float32)


def make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule,
               trained_betas=None):
    """diffusers beta schedules (ref i2sb_scheduler.py:163-182)."""
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float32)
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float32) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_train_timesteps)
    if beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, num_train_timesteps)
        return (1 / (1 + np.exp(-x)) * (beta_end - beta_start)
                + beta_start).astype(np.float32)
    raise NotImplementedError(beta_schedule)


def spaced_timesteps(num_train_timesteps, num_inference_steps,
                     timestep_spacing, steps_offset=0):
    """linspace/leading/trailing spacing (diffusers Table 2 of 2305.08891;
    ref i2sb_scheduler.py:274-300). Returns a descending int64 array."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) > "
            f"num_train_timesteps ({num_train_timesteps})")
    if timestep_spacing == "linspace":
        ts = (np.linspace(0, num_train_timesteps - 1, num_inference_steps)
              .round()[::-1].copy().astype(np.int64))
    elif timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = ((np.arange(0, num_inference_steps) * step_ratio)
              .round()[::-1].copy().astype(np.int64))
        ts += steps_offset
    elif timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio)
                      ).astype(np.int64)
        ts -= 1
    else:
        raise ValueError(timestep_spacing)
    return ts
