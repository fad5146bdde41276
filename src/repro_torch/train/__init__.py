"""The training path (the port's copy of the JAX package's ``train/``)."""
from .loop import Trainer, TrainerConfig
from .loss import softmax_xent
from .step import (TrainState, forward, init_state,
                   make_partitioned_train_step, make_train_step)

__all__ = ["Trainer", "TrainerConfig", "softmax_xent", "TrainState",
           "forward", "init_state", "make_train_step",
           "make_partitioned_train_step"]
