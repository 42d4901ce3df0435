from vlnce_torch.trainers.base_trainer import (  # noqa: F401  (registry population)
    BaseVLNCETrainer,
    DaggerTrainer,
    RecollectTrainer,
)

__all__ = ["BaseVLNCETrainer", "DaggerTrainer", "RecollectTrainer"]
