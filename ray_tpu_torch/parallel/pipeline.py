"""Pipeline parallelism: GPipe microbatch rotation over a process group.
Counterpart of ``ray_tpu/parallel/pipeline.py``.

Each rank of the ``pipeline`` group holds one stage.  The JAX package
runs the ticks as a ``lax.scan`` inside ``shard_map`` and rotates the
activations with ``ppermute``; here the ticks are a Python loop on local
tensors and the rotation is ring attention's ``_Shift`` (backward: the
reverse rotation).  There are M + S - 1 ticks, and every stage computes
on every tick, bubbles included, as the scan does: stage 0 takes
microbatch ``clip(t, 0, M - 1)``, the other stages what they received,
and the last stage records tick ``t - (S - 1)`` when it is a real one.
The choices are ``torch.where``s, not branches, so that every rank's
graph holds the same rotations and each one's backward runs on every
rank in the same order (a rank that skipped one would hang the group).
The bubble fraction is (S - 1) / (M + S - 1).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   *, num_microbatches: int, group=None,
                   checkpoint_stage: bool = True) -> torch.Tensor:
    """Run a pipeline of S stages (the ranks of ``group``, a process
    group or a collective group; None: the default group) over a batch.

    stage_fn(stage_params, activation) -> activation of the same shape.
    ``stage_params``: this rank's stage (what ``shard_map`` leaves of
    the stacked leaves in the JAX package).  ``x``: the full batch
    [batch, ...]; every rank passes it, stage 0 consumes it (its
    gradient lands on stage 0).  Returns the last stage's output
    [batch, ...] on every rank: a masked all-reduce whose backward hands
    each rank's (equal) output gradient to the last stage, so every rank
    backpropagates the same loss.  ``checkpoint_stage`` recomputes each
    tick's stage in the backward (``torch.utils.checkpoint``)."""
    from .grad_collectives import reduce_from_region
    from .ring_attention import _Shift, _wait, process_group

    group = process_group(group)
    s, stage = group.size(), group.rank()
    m = num_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    fn = stage_fn
    if checkpoint_stage:
        from ..ops.remat import checkpoint

        def fn(params, h):
            return checkpoint(stage_fn, params, h)

    first = torch.tensor(stage == 0, device=x.device)
    acts = torch.zeros_like(micro[0])
    outputs = [torch.zeros_like(micro[0]) for _ in range(m)]
    total = m + s - 1
    pending: list = []
    for t in range(total):
        inp = torch.where(first, micro[min(t, m - 1)], acts)
        out = fn(stage_params, inp)
        idx = min(max(t - (s - 1), 0), m - 1)
        valid = torch.tensor(stage == s - 1 and t >= s - 1,
                             device=x.device)
        outputs[idx] = torch.where(valid, out.to(x.dtype), outputs[idx])
        if s > 1 and t < total - 1:   # the last rotation would go unused
            (acts,) = _Shift.apply(group, pending, out)
            _wait(pending)
    last = torch.tensor(stage == s - 1, device=x.device)
    full = torch.where(last, torch.stack(outputs), 0.0)
    return reduce_from_region(full, [group]).reshape(x.shape)


def stack_stage_params(params_per_stage: Sequence) -> Any:
    """Stack a list of per-stage trees (mappings, sequences or tensors)
    into one tree with a leading stage dim; rank r passes
    ``params[r]``-sliced leaves to ``pipeline_apply``."""
    first = params_per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in params_per_stage])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params(list(z))
                            for z in zip(*params_per_stage))
    return torch.stack(list(params_per_stage))
