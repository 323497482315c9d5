"""Training step, the multi-process plane and checkpoints (counterparts
of ``ray_tpu.train.train_step``, ``ray_tpu.train.distributed``,
``ray_tpu.train.checkpoint`` and ``ray_tpu.train.sharded_checkpoint``;
import the last three as modules)."""

from .train_step import (TrainState, make_optimizer,
                         make_sharded_train_step, make_train_step,
                         shard_state)

__all__ = ["TrainState", "make_optimizer", "make_sharded_train_step",
           "make_train_step", "shard_state"]
