from vlnce_torch.trainers.base_trainer import (  # noqa: F401  (registry population)
    BaseVLNCETrainer,
    RecollectTrainer,
)
from vlnce_torch.trainers.dagger_trainer import DaggerTrainer  # noqa: F401

__all__ = ["BaseVLNCETrainer", "DaggerTrainer", "RecollectTrainer"]
