from .config import (BaseTrainingConfig, I2SBLDMTrainingConfig,
                     LDMTrainingConfig, NormControlNetConfig,
                     SDTextTrainingConfig, VAETrainingConfig,
                     load_training_config)
from .trainer import Trainer, TrainOptimizer, create_trainer, remat_policy
from .ema import EMA, ema_decay
from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         resume_step_from_path, save_checkpoint)
from .data import (DeadLeavesDataset, ImageFolderDataset, SyntheticDataset,
                   epoch_batches, make_dataset)

__all__ = [
    "BaseTrainingConfig", "I2SBLDMTrainingConfig", "LDMTrainingConfig",
    "NormControlNetConfig", "SDTextTrainingConfig", "VAETrainingConfig",
    "load_training_config", "Trainer",
    "TrainOptimizer", "create_trainer", "remat_policy",
    "EMA", "ema_decay", "latest_checkpoint", "restore_checkpoint",
    "resume_step_from_path", "save_checkpoint", "DeadLeavesDataset",
    "ImageFolderDataset", "SyntheticDataset", "epoch_batches",
    "make_dataset",
]
