"""All-reduces that autograd differentiates, over lists of process groups.

Three pairs of forward and backward, the ones a ``shard_map`` program
spells with ``psum`` and its transpose:

- ``all_reduce_sum``: sum forward, sum backward (``psum``, whose
  transpose is ``psum``): a value summed over data-parallel ranks that
  every rank's loss then uses;
- ``copy_to_region``: identity forward, sum backward: a replicated value
  entering a computation that each rank does only a part of (its
  experts, its slice of a hidden dim), so its gradient is partial;
- ``reduce_from_region``: sum forward, identity backward: the partial
  results of such a computation made whole; the gradient, like the
  value, is then the same on every rank.

Each takes the groups in any order and skips those of size 1.  A CUDA
tensor on a gloo group is staged through host memory.  The ops call the
process group's own ``allreduce``, so they also run on a standalone gloo
group (``collective_group.base.standalone_gloo_group``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _active(groups: Sequence) -> tuple:
    return tuple(g for g in groups if g is not None and g.size() > 1)


def _sum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    from ..collective.collective_group.base import backend_name

    out = x.detach().clone().contiguous()
    for g in groups:
        staged = out.is_cuda and backend_name(g) == "gloo"
        buf = out.cpu() if staged else out
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        g.allreduce([buf], opts).wait()
        out = buf.to(x.device) if staged else buf
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.groups), None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.groups), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _apply(fn, x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    groups = _active(groups)
    return fn.apply(x, groups) if groups else x


def all_reduce_sum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    return _apply(_AllReduceSum, x, groups)


def copy_to_region(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    return _apply(_CopyToRegion, x, groups)


def reduce_from_region(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    return _apply(_ReduceFromRegion, x, groups)
