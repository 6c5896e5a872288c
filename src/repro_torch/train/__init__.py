"""Training: the train-step factory and the fault-tolerant Trainer."""

from repro_torch.train.trainer import (
    StragglerWatchdog,
    Trainer,
    TrainerConfig,
    TrainState,
    init_train_state,
    make_key,
    make_train_step,
)

__all__ = [
    "StragglerWatchdog",
    "Trainer",
    "TrainerConfig",
    "TrainState",
    "init_train_state",
    "make_key",
    "make_train_step",
]
