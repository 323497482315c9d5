"""Training step and the multi-process plane (counterparts of
``ray_tpu.train.train_step`` and ``ray_tpu.train.distributed``)."""

from .train_step import (TrainState, make_optimizer,
                         make_sharded_train_step, make_train_step,
                         shard_state)

__all__ = ["TrainState", "make_optimizer", "make_sharded_train_step",
           "make_train_step", "shard_state"]
