"""Training step (counterpart of ``ray_tpu.train.train_step``)."""

from .train_step import (TrainState, make_optimizer, make_train_step)

__all__ = ["TrainState", "make_optimizer", "make_train_step"]
