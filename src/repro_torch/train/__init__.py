"""The training loop (counterpart of ``repro.train``)."""

from .trainer import (TrainerConfig, Trainer, TrainStep,  # noqa: F401
                      make_train_step)
