"""Training config system: a JSON file holds a ``base`` key plus exactly one
trainer key (vae | ldm | i2sb | sd_text | norm_controlnet). The port's own
copy of ``afldm_tpu/train/config.py``: the same dataclasses and fields, so
the repository's training JSONs load unchanged; unknown fields (e.g.
xformers flags) are accepted and ignored. Fields that select features this
port does not have yet (``model_parallel`` > 1, ``fsdp``) load, and the
trainer raises on them; ``mixed_precision="bf16"`` trains in bfloat16."""

import json
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class BaseTrainingConfig:
    logging_dir: str = "logs"
    output_dir: str = "train_ckpt/run"

    logger: str = "tensorboard"
    checkpointing_steps: int = 500
    checkpoints_total_limit: int = 20
    valid_epochs: int = 100
    valid_steps: int = 0
    save_model_epochs: int = 100
    resume_from_checkpoint: Optional[str] = None

    seed: Optional[int] = None
    num_epochs: int = 200
    train_batch_size: int = 1
    dataloader_num_workers: int = 8
    gradient_accumulation_steps: int = 1
    mixed_precision: Optional[str] = None
    gradient_checkpointing: bool = False
    # selectivity when gradient_checkpointing is on: "full" recomputes the
    # whole UNet in the backward pass (least memory); "dots" keeps the
    # outputs of matmuls and convolutions and recomputes the rest
    remat_policy: str = "full"
    # precision of the alias-free circulant products: "highest" (exact
    # float32), "high" (3 bf16 passes a product) or "default" (1)
    af_precision: str = "highest"
    # tensor-parallel size (1: one card; more raises in this port)
    model_parallel: int = 1
    # fully sharded parameters and optimizer state (raises in this port)
    fsdp: bool = False

    is_imagenet: bool = False
    prompt_dropout: float = 0.0
    dataset_name: Optional[str] = None
    dataset_config_name: Optional[str] = None
    train_data_dir: Optional[str] = None
    train_files: Optional[str] = None
    cache_dir: Optional[str] = None
    resolution: int = 512
    center_crop: bool = True
    random_flip: bool = False
    valid_data_dir: Optional[str] = None

    push_to_hub: bool = False
    hub_model_id: str = ""

    # accepted for compatibility, unused
    enable_xformers_memory_efficient_attention: bool = True


@dataclass
class _OptimConfig:
    scale_lr: bool = False
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    use_ema: bool = False
    foreach_ema: bool = False
    offload_ema: bool = False
    max_grad_norm: float = 1.0


@dataclass
class VAETrainingConfig(_OptimConfig):
    model_cfg: str = ""
    pretrained_model_name_or_path: Optional[str] = None
    use_disc: bool = False
    disc_cfg: Optional[str] = None
    use_shift_loss: bool = False
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    # local VGG16/LPIPS checkpoint for the perceptual loss; empty: the
    # random-feature proxy
    lpips_vgg_path: str = ""
    kl_weight: float = 1e-6
    gradient_accumulation_steps: int = 2


@dataclass
class LDMTrainingConfig(_OptimConfig):
    vae_path: str = ""
    scheduler_path: str = ""
    is_vqvae: bool = False
    unet_config: Optional[str] = None
    unet_path: Optional[str] = None
    prediction_type: str = "epsilon"
    af_models: bool = False
    use_shift_loss: bool = False
    wrap_act: bool = True
    use_cross_attn: bool = True
    use_stop_grad: bool = False
    valid_seed: int = 0
    valid_batch_size: int = 1


@dataclass
class I2SBLDMTrainingConfig(_OptimConfig):
    scheduler_path: str = ""
    vae_path: Optional[str] = None
    unet_config: Optional[str] = None
    unet_path: Optional[str] = None
    af_models: bool = True
    is_ode: bool = True
    use_cfa: bool = False
    valid_seed: int = 0
    valid_batch_size: int = 1


@dataclass
class SDTextTrainingConfig(_OptimConfig):
    """Text-conditioned SD finetune."""
    pretrained_model_name_or_path: str = ""
    vae_path: Optional[str] = None
    af_models: bool = True
    use_shift_loss: bool = True
    use_cross_attn: bool = True
    valid_seed: int = 0
    valid_batch_size: int = 1


@dataclass
class NormControlNetConfig(_OptimConfig):
    """Latent-ControlNet normal-estimation training."""
    pretrained_model_name_or_path: str = ""
    controlnet_config: Optional[str] = None
    af_models: bool = True
    use_shift_loss: bool = True
    is_yoso: bool = True
    zero_input_prob: float = 0.4
    valid_seed: int = 0
    valid_batch_size: int = 1


TRAINER_CONFIG_CLASSES = {
    "base": BaseTrainingConfig,
    "vae": VAETrainingConfig,
    "ldm": LDMTrainingConfig,
    "i2sb": I2SBLDMTrainingConfig,
    "sd_text": SDTextTrainingConfig,
    "norm_controlnet": NormControlNetConfig,
}


def _build(cls, d):
    known = {f.name for f in fields(cls)}
    kept = {k: v for k, v in d.items() if k in known}
    return cls(**kept)


def load_training_config(config_path: str):
    """JSON file with 'base' + exactly one trainer key. Returns
    {"base": BaseTrainingConfig, <key>: its trainer config}."""
    with open(config_path) as f:
        data = json.load(f)
    base = data.pop("base")
    if len(data) != 1:
        raise ValueError(f"{config_path}: a config has 'base' and exactly "
                         f"one trainer key, got {sorted(data)}")
    key = next(iter(data))
    cls = TRAINER_CONFIG_CLASSES[key]
    return {"base": _build(BaseTrainingConfig, base),
            key: _build(cls, data[key])}
