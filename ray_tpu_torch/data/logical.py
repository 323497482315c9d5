"""Logical plan + optimizer for Datasets.

Role-equivalent to the reference's logical planning layer (ref:
python/ray/data/_internal/logical/interfaces/logical_plan.py and the
fusion rule at _internal/logical/rules/operator_fusion.py:41): a
Dataset records WHAT to compute as a chain of logical operators; the
planner turns that into physical stages, fusing every run of
map-compatible operators into ONE task per block so a chained
map → filter → map_batches pipeline costs exactly num_blocks tasks.

Design note vs the reference: Ray's planner optimizes a DAG of
dozens of operator types; here the executable substrate is
(sources, fused op chain) — see dataset.py `_process_block` — so the
planner's job is (a) proving/normalizing the fusion that execution
relies on and (b) explaining it (`Dataset.explain()`).  Structural
operators (union/zip/limit) enter the plan as stage boundaries:
union concatenates per-block source chains (zero tasks), zip pairs
aligned blocks into one task per pair, and limit is a streaming
early-stop at execution (ref: dataset.py:2052 union, :2543 zip).
Counterpart of ``ray_tpu/data/logical.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


@dataclass
class LogicalOp:
    """One node of the logical plan (linear chain; structural ops
    carry their upstream plans as children)."""

    name: str
    children: List["LogicalOp"] = field(default_factory=list)
    detail: str = ""

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = f"{pad}{self.name}" + (f"({self.detail})"
                                      if self.detail else "")
        return "\n".join([line] + [c.describe(indent + 1)
                                   for c in self.children])


def read_op(n_blocks: int) -> LogicalOp:
    return LogicalOp("Read", detail=f"blocks={n_blocks}")


def map_op(kind: str, fn: Callable,
           parent: Optional[LogicalOp] = None) -> LogicalOp:
    fname = getattr(fn, "__name__", "")
    return LogicalOp(f"Map[{kind}]",
                     children=[parent] if parent else [],
                     detail=fname)


def union_op(plans: List[LogicalOp]) -> LogicalOp:
    return LogicalOp("Union", children=plans)


def zip_op(left: LogicalOp, right: LogicalOp) -> LogicalOp:
    return LogicalOp("Zip", children=[left, right])


def limit_op(parent: LogicalOp, n: int) -> LogicalOp:
    return LogicalOp("Limit", children=[parent], detail=f"n={n}")


def barrier_op(parent: Optional[LogicalOp], kind: str,
               n_blocks: int) -> LogicalOp:
    return LogicalOp(f"Exchange[{kind}]",
                     children=[parent] if parent else [],
                     detail=f"blocks={n_blocks}")


@dataclass
class PhysicalStage:
    """One executable stage: `tasks` tasks, each running `fused_ops`
    logical operators fused into a single `_process_block` call (the
    operator-fusion invariant the tests assert; ref:
    operator_fusion.py:41 fusing compatible one-to-one operators)."""

    kind: str                 # read+map | exchange | limit
    tasks: int
    fused_ops: int

    def describe(self) -> str:
        return (f"{self.kind}: {self.tasks} task(s), "
                f"{self.fused_ops} fused op(s)/task")


def plan_stages(plan: LogicalOp) -> List[PhysicalStage]:
    """Fold the logical plan into physical stages, applying the map
    fusion rule: every maximal run of Map[*] ops above one Read /
    Union / Zip collapses into that source's stage (one task per
    block).  Union splices its children's fused top stages into one
    stage; Zip absorbs BOTH sides' chains into one task per block
    pair (for per-block-heterogeneous unions, fused_ops reports the
    largest child chain)."""

    def sub(node: LogicalOp):
        """Returns (stages, pending_fused) for the subtree; the
        pending count is the Map run not yet folded into a stage."""
        if node.name.startswith("Map["):
            st, fused = sub(node.children[0]) if node.children \
                else ([], 0)
            return st, fused + 1
        if node.name == "Read":
            n = int(node.detail.split("=")[1])
            return [PhysicalStage("read+map", n, 0)], 0
        if node.name == "Union":
            out: List[PhysicalStage] = []
            total = 0
            chain_max = 0
            for c in node.children:
                st, fused = sub(c)
                if st and st[-1].kind == "read+map":
                    top = st.pop()
                    total += top.tasks
                    chain_max = max(chain_max, top.fused_ops + fused)
                # Remaining child stages (limits/exchanges of frozen
                # inputs) already produced their refs; keep them.
                out.extend(st)
            out.append(PhysicalStage("read+map", total, chain_max))
            return out, 0
        if node.name == "Zip":
            lst, lf = sub(node.children[0])
            rst, rf = sub(node.children[1])
            tasks = 0
            fused = 0
            if lst and lst[-1].kind == "read+map":
                top = lst.pop()
                tasks = top.tasks
                fused += top.fused_ops + lf
            if rst and rst[-1].kind == "read+map":
                rtop = rst.pop()
                tasks = tasks or rtop.tasks
                fused += rtop.fused_ops + rf
            return (lst + rst
                    + [PhysicalStage("read+map", tasks, fused)]), 0
        if node.name == "Limit":
            st, fused = sub(node.children[0]) if node.children \
                else ([], 0)
            if st and st[-1].kind == "read+map":
                st[-1].fused_ops += fused
            return st + [PhysicalStage("limit", 0, 0)], 0
        if node.name.startswith("Exchange["):
            st, fused = sub(node.children[0]) if node.children \
                else ([], 0)
            if st and st[-1].kind == "read+map":
                st[-1].fused_ops += fused
            n = int(node.detail.split("=")[1])
            return st + [PhysicalStage("exchange", 2 * n, 0)], 0
        return [], 0

    stages, top_fused = sub(plan)
    if stages and top_fused:
        for s in reversed(stages):
            if s.kind == "read+map":
                s.fused_ops += top_fused
                break
    return stages


def explain(plan: LogicalOp) -> str:
    stages = plan_stages(plan)
    lines = ["-- logical --", plan.describe(), "-- physical --"]
    lines += [s.describe() for s in stages]
    return "\n".join(lines)
