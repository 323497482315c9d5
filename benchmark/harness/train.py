"""Training cells: the port's ``make_train_step`` on seeded GPT-2
weights and uniform token batches.

Set-up builds one training state from the seed and drives it through
the mix's first steps (the warm-up); the window then drives the same
state, issuing steps back to back with no synchronisation between them,
and ends with one.  What the first steps produced is held against the
reference once the window has closed and the program's state is gone:
each step's loss, the first gradient as the optimizer took it (read
from its first moment), and the parameters' change over the first
steps.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from . import env
from . import trace as tracing
from . import weights as W


class Program:
    """The system under test: the port's model, optimizer and step."""

    def __init__(self, cfg: dict, seed: int, device, loss_rows=None):
        from ray_tpu_torch.models.gpt2 import GPT2, gpt2_loss_fn
        from ray_tpu_torch.train.train_step import (TrainState,
                                                    make_optimizer,
                                                    make_train_step)

        train = cfg["train"]
        pcfg = W.port_config(cfg, attn_impl=train["attn_impl"],
                             remat=train["remat"])
        self.model = GPT2(pcfg, device)
        self.model.load_state_dict(W.gpt2_weights(cfg, seed, device))
        opt = {k: v for k, v in train["optimizer"].items() if k != "eps"}
        self.optimizer = make_optimizer(**opt)
        self.state = TrainState.create(self.model, self.optimizer)
        chunk = train["loss_chunk"]

        def loss_fn(model, batch):
            if loss_rows is not None:             # a planted fault
                batch = {"tokens": batch["tokens"][:loss_rows]}
            return gpt2_loss_fn(pcfg, model, batch, loss_chunk=chunk)

        self.step_fn = make_train_step(loss_fn, self.optimizer)
        self.names = [n for n, _p in self.model.named_parameters()]

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        self.state, info = self.step_fn(self.state, {"tokens": tokens})
        return info["loss"]

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.state.opt_state["mu"]))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def change_norms(cfg: dict, seed: int, params: Dict[str, torch.Tensor],
                 device) -> torch.Tensor:
    """Norms of each piece's change from the seed's initial weights."""
    init = W.gpt2_weights(cfg, seed, device)
    with torch.no_grad():
        out = torch.stack([
            torch.linalg.vector_norm(params[p][..., sl].detach().float()
                                     - init[p][..., sl])
            for _piece, p, sl in W.segments(cfg)])
    del init
    return out


def first_steps(prog: Program, cfg: dict, feed: W.TokenFeed, n: int,
                seed: int, device):
    """Drive ``prog`` through ``n`` steps on the feed, as the window
    will.  Returns the batches, the losses (tensors), the first
    gradient's piece norms and the change's piece norms."""
    b1 = cfg["train"]["optimizer"]["b1"]
    batches: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    grad = None
    for i in range(n):
        tokens = feed.next()
        batches.append(tokens.clone())
        losses.append(prog.step(tokens))
        if i == 0:
            grad = W.segment_norms(cfg, prog.first_moment()) / (1.0 - b1)
    change = change_norms(cfg, seed, prog.params(), device)
    return batches, losses, grad, change


def _rel_gaps(prog: torch.Tensor, ref: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each piece's gap of norms, over the larger of that piece's
    reference norm and the median piece's."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    floor = ref.median()
    return (prog - ref).abs() / torch.maximum(ref, floor)


def reference_readings(cfg: dict, seed: int, batches, device,
                       precision: str = "fp32") -> Dict[str, Any]:
    """The reference's losses, first-gradient and change piece norms
    over ``batches`` from the seed's weights."""
    from ..reference import gpt2 as ref

    ref.exact_float32()
    p = W.gpt2_weights(cfg, seed, device)
    norms: Dict[str, torch.Tensor] = {}

    def on_first(name: str, g: torch.Tensor) -> None:
        for piece, param, sl in pieces.get(name, ()):
            norms[piece] = torch.linalg.vector_norm(g[..., sl])

    pieces: Dict[str, list] = {}
    for seg in W.segments(cfg):
        pieces.setdefault(seg[1], []).append(seg)
    losses = ref.train(p, batches, cfg, cfg["train"]["optimizer"],
                       cfg["train"]["reference_rows"], precision, on_first)
    grad = torch.stack([norms[piece] for piece, _p, _s in W.segments(cfg)])
    change = change_norms(cfg, seed, p, device)
    del p
    return {"losses": losses, "grad": grad, "change": change}


def counted(ref: Dict[str, Any]) -> torch.Tensor:
    """Which pieces the change is compared on: those whose reference
    gradient is a thousandth of the median piece's or more (the others
    move by rounding alone under Adam)."""
    return (ref["grad"] >= 1e-3 * ref["grad"].median()).cpu()


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers that decide ``correct``: the largest loss gap, and
    the worst piece's gap of the first gradient and of the change (over
    the ``counted`` pieces)."""
    grad = _rel_gaps(prog["grad"].cpu(), ref["grad"].cpu())
    change = _rel_gaps(prog["change"].cpu(), ref["change"].cpu(),
                       counted(ref))
    return {
        "loss_gap": max(abs(a - b) for a, b in
                        zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": float(grad.max()),
        "change_norm_gap": float(change.max()),
    }


def worst_pieces(cfg: dict, prog: Dict[str, Any], ref: Dict[str, Any]
                 ) -> Dict[str, str]:
    """The pieces that set the worst gaps (for the record)."""
    names = [piece for piece, _p, _s in W.segments(cfg)]
    keep = counted(ref)
    kept = [n for n, k in zip(names, keep.tolist()) if k]
    g = _rel_gaps(prog["grad"].cpu(), ref["grad"].cpu())
    c = _rel_gaps(prog["change"].cpu(), ref["change"].cpu(), keep)
    return {"grad": names[int(g.argmax())], "change": kept[int(c.argmax())]}


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Dict[str, Any]:
    cfg = dict(cell.config)
    traffic = cell.traffic
    rows, width = traffic["batch"], traffic["seq"] + 1
    if device.type == "cuda":
        from ray_tpu_torch.ops import _kernels

        _kernels.library()                      # build or load the kernels
    env.phase(t_start, "kernels loaded")
    prog = Program(cfg, seed, device)
    env.phase(t_start, "model and optimizer built")
    feed = W.TokenFeed(seed, rows, width, cfg["vocab_size"], device)
    batches, first_losses, grad, change = first_steps(
        prog, cfg, feed, traffic["first_steps"], seed, device)
    _sync(device)
    env.phase(t_start, f"{traffic['first_steps']} first steps done")
    if traced:
        tracing.warm(device)
    _sync(device)
    t_open = time.perf_counter()
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses: List[torch.Tensor] = []
    host: List[float] = []
    summary = None
    if traced:
        def traced_steps():
            for _ in range(traffic["traced_steps"]):
                losses.append(prog.step(feed.next()))

        summary = tracing.complete_capture(device, traced_steps)
    while time.perf_counter() - t_open < seconds:
        tokens = feed.next()
        t0 = time.perf_counter()
        losses.append(prog.step(tokens))
        host.append(time.perf_counter() - t0)
    _sync(device)
    window_s = time.perf_counter() - t_open
    env.after_window(device)
    out = {
        "kind": "train", "setup_s": setup_s, "window_s": window_s,
        "steps": len(losses), "tokens_per_step": rows * (width - 1),
        "host_issue_s": host,
        "trace": summary,
        "trace_steps": traffic["traced_steps"] if traced else 0,
        "attempted": len(losses),
        "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }
    prog_read = {"losses": [float(x) for x in first_losses],
                 "grad": grad, "change": change}
    del prog, losses, first_losses
    _free(device)
    print(f"program freed: {env.device_memory(device)}", file=sys.stderr)
    t_ref = time.perf_counter()
    ref = reference_readings(cfg, seed, batches, device)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    out["checks"] = compare(prog_read, ref)
    out["info"] = {
        "losses": prog_read["losses"], "reference_losses": ref["losses"],
        "pieces_left_out": int((~counted(ref)).sum()),
        "worst_pieces": worst_pieces(cfg, prog_read, ref)}
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
