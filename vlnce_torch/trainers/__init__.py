from vlnce_torch.trainers.base_trainer import BaseVLNCETrainer  # noqa: F401  (registry population)
from vlnce_torch.trainers.dagger_trainer import DaggerTrainer  # noqa: F401
from vlnce_torch.trainers.recollect_trainer import RecollectTrainer  # noqa: F401

__all__ = ["BaseVLNCETrainer", "DaggerTrainer", "RecollectTrainer"]
