"""Trainer hook surface, factory and the shared optimizer and remat
machinery. Counterpart of ``afldm_tpu/train/trainer.py``.

A trainer owns its modules, its optimizer and its EMA on one device (the
card unless the caller passes ``device``); ``training_step`` runs one
micro-batch eagerly. The JAX package's mesh, sharding and jit have no
counterpart here: one card, no model parallelism, float32.
"""

import abc
import functools
import json
import math
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from ..ops.ideal_lpf import set_af_precision
from ..pipelines.loading import resolve_device


def lr_multiplier(cfg, total_steps: Optional[int] = None):
    """lr / base lr at update k (counted from 0), the optax schedules of the
    JAX ``make_optimizer``: "constant" with a linear warmup from 0 over
    ``lr_warmup_steps`` updates, or "cosine" (``warmup_cosine_decay_schedule``
    to 0 at ``total_steps``, warmup included)."""
    warm = cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant":
        if not warm:
            return lambda k: 1.0
        return lambda k: min(k / warm, 1.0)
    if cfg.lr_scheduler == "cosine":
        if total_steps is None:
            raise ValueError("the cosine schedule needs total_steps")
        decay = total_steps - warm

        def cosine(k):
            if k < warm:
                return k / warm
            frac = min(k - warm, decay) / decay
            return 0.5 * (1.0 + math.cos(math.pi * frac))
        return cosine
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


class TrainOptimizer:
    """The chain of the JAX ``make_optimizer``: global-norm clip, then AdamW
    (decoupled weight decay, as ``optax.adamw``), then a ``LambdaLR`` whose
    lr at update k is the optax schedule at count k; with ``grad_accum``
    k > 1 the gradients of k micro-batches are averaged first
    (``optax.MultiSteps``).

    Call ``step()`` after the backward pass of every micro-batch: it
    returns True on the micro-batches where it applied an update."""

    def __init__(self, params, cfg, total_steps: Optional[int] = None,
                 grad_accum: int = 1, train_batch_size: int = 1):
        base_lr = cfg.learning_rate
        if getattr(cfg, "scale_lr", False):
            base_lr = base_lr * grad_accum * train_batch_size
        self.params = [p for p in params if p.requires_grad]
        self.max_grad_norm = cfg.max_grad_norm
        self.grad_accum = grad_accum
        self.micro_step = 0
        self.opt = torch.optim.AdamW(
            self.params, lr=base_lr, betas=(cfg.adam_beta1, cfg.adam_beta2),
            eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lr_multiplier(cfg, total_steps))

    @property
    def lr(self) -> float:
        """The lr of the next update."""
        return self.opt.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self) -> bool:
        self.micro_step += 1
        if self.micro_step < self.grad_accum:
            return False
        self.micro_step = 0
        for p in self.params:
            if p.grad is None:  # optax sees a zero gradient (and decays p)
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.grad_accum > 1:
            torch._foreach_div_(grads, float(self.grad_accum))
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # optax.clip_by_global_norm: unchanged below the limit, g/|g|*limit
        # at or above it (no host sync)
        torch._foreach_mul_(grads, (self.max_grad_norm / norm).clamp(max=1.0))
        self.opt.step()
        self.sched.step()
        self.opt.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(),
                "sched": self.sched.state_dict(),
                "micro_step": self.micro_step}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.sched.load_state_dict(state["sched"])
        self.micro_step = int(state["micro_step"])


# "dots": the aten products whose outputs selective checkpointing keeps
# (the JAX policy dots_with_no_batch_dims_saveable keeps dots and convs)
_SAVED_OPS = frozenset([
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.convolution.default,
    torch.ops.aten._convolution.default])


def _save_products(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: str):
    """BaseTrainingConfig.remat_policy -> the ``context_fn`` of
    ``torch.utils.checkpoint.checkpoint``: "full" recomputes everything
    (None), "dots" keeps matmul and convolution outputs."""
    if name == "full":
        return None
    if name == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                 _save_products)
    raise ValueError(f"unknown remat_policy {name!r} (full|dots)")


def checkpointed(fn, policy: str):
    """``fn`` whose activations are recomputed in the backward pass
    (non-reentrant ``torch.utils.checkpoint``), under ``remat_policy``."""
    context_fn = remat_policy(policy)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}

    def run(*args):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return run


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Trainer(abc.ABC):
    """Hook surface of the JAX ``Trainer``: init_modules, init_optimizers,
    set_dataset, prepare_modules, training_step, validate, save_pipeline,
    state_for_checkpoint and load_state."""

    def __init__(self, base_cfg, cfg, device=None):
        self.base_cfg = base_cfg
        self.cfg = cfg
        if base_cfg.mixed_precision == "bf16":
            raise NotImplementedError(
                "mixed_precision='bf16' is not ported yet: the kernels are "
                "float32")
        if (getattr(base_cfg, "model_parallel", 1) or 1) > 1:
            raise NotImplementedError("model_parallel > 1 is not ported: "
                                      "the port trains on one card")
        if getattr(base_cfg, "fsdp", False):
            raise NotImplementedError("fsdp is not ported: the port trains "
                                      "on one card")
        set_af_precision(base_cfg.af_precision)
        self.device = resolve_device(device)

    @abc.abstractmethod
    def init_modules(self):
        ...

    @abc.abstractmethod
    def init_optimizers(self, total_steps=None):
        ...

    def set_dataset(self, dataset):
        self.dataset = dataset

    @abc.abstractmethod
    def prepare_modules(self):
        """Initialise the weights and build the optimizer state and EMA."""

    @abc.abstractmethod
    def training_step(self, global_step, batch) -> dict:
        ...

    def validate(self, global_step):
        return {}

    def save_pipeline(self, output_dir):
        pass

    @abc.abstractmethod
    def state_for_checkpoint(self) -> dict:
        ...

    @abc.abstractmethod
    def load_state(self, state: dict):
        ...


_WAITING = {
    "i2sb": "I2SB super-resolution (ROADMAP Queue 1 item 12)",
    "sd_text": "the SD family (ROADMAP Queue 1 item 14)",
    "norm_controlnet": "the SD family (ROADMAP Queue 1 item 14)",
}


def create_trainer(name: str, base_cfg, cfg, device=None) -> Trainer:
    """Factory. "vae" and "ldm" are ported; the others raise naming their
    slice."""
    if name == "ldm":
        from .ldm_trainer import LDMTrainer
        return LDMTrainer(base_cfg, cfg, device=device)
    if name == "vae":
        from .vae_trainer import VAETrainer
        return VAETrainer(base_cfg, cfg, device=device)
    if name in _WAITING:
        raise NotImplementedError(f"trainer {name!r} is not ported yet: it "
                                  f"comes with {_WAITING[name]}")
    raise ValueError(f"unknown trainer {name!r}")
