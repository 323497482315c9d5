"""Activation recomputation that does not import the compiler stack.

``torch.utils.checkpoint.checkpoint`` is wrapped by
``torch._disable_dynamo``, and its non-reentrant path reads
``torch._dynamo.config``: its first call imports ``torch._dynamo`` (with
sympy and triton where they are installed).  The port compiles nothing,
yet that import, with the DTensor module's (``device.is_dtensor``), was
most of a new process's first training step: about 3 s on a CPU box, and
on an H100 host 7.36-7.67 s of modules and first GPT-2 124M step against
1.27-1.36 s without (``tools/worker_start.py``; NVIDIA H100 80GB HBM3,
700 W).  Every trainer worker, ring rank and pipeline stage paid it.

``checkpoint`` is the same non-reentrant scheme without it: the forward
saves nothing for its backward (a saved-tensors hook keeps only a
count); the backward's first unpack runs the function again, with the
CPU and CUDA RNG states its forward began with, keeps the tensors that
run saves (detached, so nothing refers back to the graph) and stops the
run once it has saved as many as the forward did (torch's early stop:
the block's last product, whose output nothing saves, is not run again),
then hands each out in order.  The port runs no autocast, and this
recomputation would not replay one, so it refuses to run under it;
first-order gradients only: a backward with ``create_graph=True``
raises.
"""

from __future__ import annotations

import torch
from torch.autograd.graph import saved_tensors_hooks


def _refuse(_packed):
    raise RuntimeError("ops.remat: a backward through a recomputation")


class _Enough(Exception):
    """Raised from the recomputation's pack hook once it holds every
    tensor the forward saved: what follows in the function is not run."""


class _Frame:
    """One checkpointed call: the function and its inputs, the RNG
    states its forward began with, how many tensors the forward saved
    and, after the first unpack, the tensors the recomputation saved."""

    def __init__(self, fn, args, kwargs):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.cpu_rng = torch.get_rng_state()
        self.devices = sorted({a.device.index for a in args
                               if isinstance(a, torch.Tensor) and a.is_cuda})
        self.cuda_rng = [torch.cuda.get_rng_state(d) for d in self.devices]
        self.saved = 0
        self.recomputed = None

    def pack(self, _tensor) -> int:
        self.saved += 1
        return self.saved - 1

    def unpack(self, index: int):
        if self.recomputed is None:
            self.recomputed = self._recompute()
        return self.recomputed[index]

    def _recompute(self) -> list:
        if torch.is_grad_enabled():
            raise RuntimeError("ops.remat.checkpoint: higher-order "
                               "gradients (create_graph=True) are not "
                               "supported")
        store = []

        def keep(t):
            store.append(t.detach())
            if len(store) == self.saved:
                raise _Enough

        with torch.random.fork_rng(devices=self.devices, device_type="cuda"):
            torch.set_rng_state(self.cpu_rng)
            for d, state in zip(self.devices, self.cuda_rng):
                torch.cuda.set_rng_state(state, d)
            try:
                with torch.enable_grad(), saved_tensors_hooks(keep, _refuse):
                    self.fn(*self.args, **self.kwargs)
            except _Enough:
                pass
        if len(store) != self.saved:
            raise RuntimeError(f"ops.remat.checkpoint: the recomputation "
                               f"saved {len(store)} tensors, the forward "
                               f"{self.saved}")
        return store


def checkpoint(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the
    backward: what ``torch.utils.checkpoint.checkpoint(fn, *args,
    use_reentrant=False, **kwargs)`` computes, the same numbers."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if torch.is_autocast_enabled("cuda") or torch.is_autocast_enabled("cpu"):
        raise RuntimeError("ops.remat.checkpoint does not replay autocast")
    frame = _Frame(fn, args, kwargs)
    with saved_tensors_hooks(frame.pack, frame.unpack):
        return fn(*args, **kwargs)
