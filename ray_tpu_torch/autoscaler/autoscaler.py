"""The scaling loop: demand -> bin-pack -> launch; idle -> drain ->
terminate.

Role-equivalent to the reference's StandardAutoscaler.update (ref:
autoscaler/_private/autoscaler.py:171,365) with the
ResourceDemandScheduler's bin-packing (ref:
resource_demand_scheduler.py) collapsed into one first-fit pass: the
demand vector is a handful of shapes (CPU hosts, GPU machines, whole
multi-host slices), not a cloud menagerie, so utilization-scorer
machinery is deliberately dropped.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.rpc import RpcClient, RpcError
from .node_provider import NodeProvider

logger = logging.getLogger("ray_tpu_torch.autoscaler")


@dataclass
class NodeType:
    """One launchable shape (ref: cluster YAML available_node_types).

    A multi-host slice is expressed as one NodeType whose resources
    cover the whole slice (e.g. {"GPU": 16, "slice-h100-16": 1}) — the
    provider brings the slice up or down atomically.
    """

    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class AutoscalerConfig:
    node_types: List[NodeType] = field(default_factory=list)
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0
    max_launch_batch: int = 8


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items())


def _sub(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class StandardAutoscaler:
    """Polls controller load metrics and reconciles the node set."""

    def __init__(self, controller_addr: str, provider: NodeProvider,
                 config: AutoscalerConfig):
        self.controller_addr = controller_addr
        self.provider = provider
        self.config = config
        self._types = {t.name: t for t in config.node_types}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cli: Optional[RpcClient] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # provider_id -> launch time; protects just-launched nodes from
        # the idle reaper before they register.
        self._launch_times: Dict[str, float] = {}
        # Decision ring: one record per reconcile tick that acted or
        # hit unsatisfiable demand, mirrored to the controller so `rt
        # doctor` can answer "why didn't it scale" without reading
        # the autoscaler log (round-5 demand-blindness weakness).
        self.decisions: "deque[Dict]" = deque(maxlen=128)
        self._unsatisfied: List[Dict[str, float]] = []

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rt-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=15)

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._run_async())
        finally:
            self._loop.close()

    async def _run_async(self) -> None:
        self._cli = RpcClient(self.controller_addr, tag="autoscaler")
        while not self._stop.is_set():
            try:
                await self.update()
            except RpcError:
                logger.warning("controller unreachable; retrying")
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("autoscaler update failed")
            await asyncio.sleep(self.config.update_interval_s)
        await self._cli.close()

    # ----------------------------------------------------------- the update
    async def update(self) -> Dict[str, List[str]]:
        """One reconcile pass; returns {"launched": [...],
        "terminated": [...]} for tests/introspection."""
        lm = await self._cli.call("get_load_metrics", {})
        self._unsatisfied: List[Dict[str, float]] = []
        preempted = await self._reap_preempted()
        launched = await self._scale_up(lm)
        terminated = await self._scale_down(lm)
        n_demands = len(lm["pending_demands"]) + \
            len(lm["pending_placement_groups"])
        if launched or terminated or preempted or self._unsatisfied:
            rec = {"ts": time.time(), "demands": n_demands,
                   "launched": list(launched),
                   "terminated": list(terminated),
                   "preempted": list(preempted),
                   "unsatisfied": list(self._unsatisfied)}
            self.decisions.append(rec)
            try:
                await self._cli.notify("report_autoscaler_decision",
                                       rec)
            except RpcError:
                pass
        return {"launched": launched, "terminated": terminated,
                "preempted": preempted}

    async def _reap_preempted(self) -> List[str]:
        """Providers that can observe cloud-side preemption (GCP Spot
        VMs report TERMINATED) expose ``reap_preempted``:
        untracking a preempted node drops the type's live count below
        its target, so the normal demand/min_workers pass RELAUNCHES a
        replacement this same tick instead of treating the loss as
        terminal.  The reap is recorded in the decision ring."""
        reap = getattr(self.provider, "reap_preempted", None)
        if reap is None:
            return []
        try:
            gone = await asyncio.get_event_loop().run_in_executor(
                None, reap)
        except Exception:  # noqa: BLE001 — a cloud hiccup must not
            logger.exception("preemption reap failed")  # kill the loop
            return []
        for pid in gone:
            self._launch_times.pop(pid, None)
            logger.warning("node %s was preempted; replacement counts "
                           "against its type's target", pid)
        return list(gone)

    def _counts_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for pid in self.provider.non_terminated_nodes():
            t = self.provider.node_type_of(pid)
            if t:
                counts[t] = counts.get(t, 0) + 1
        return counts

    async def _scale_up(self, lm: Dict) -> List[str]:
        # (priority, shape): plain lease demand carries no priority
        # (0); pending gangs carry their job's.  Higher priority packs
        # and launches first, so when the launch batch cap bites, the
        # nodes that do come up serve the most important waiter.
        prioritized: List = [(0, dict(d)) for d in lm["pending_demands"]]
        for pg in lm["pending_placement_groups"]:
            pri = int(pg.get("priority", 0))
            # STRICT_PACK bundles must land on ONE node: fuse them so
            # bin-packing can't split what placement won't.
            if pg["strategy"] == "STRICT_PACK":
                fused: Dict[str, float] = {}
                for b in pg["bundles"]:
                    for k, v in b.items():
                        fused[k] = fused.get(k, 0.0) + v
                prioritized.append((pri, fused))
            else:
                prioritized.extend((pri, b) for b in pg["bundles"])
        if not prioritized:
            return []

        # Capacity that can still absorb demand: live nodes' available
        # plus nodes launched but not yet registered (full resources).
        # Draining nodes are NOT capacity — they refuse new leases and
        # will be gone by their deadline (their replacement demand
        # arrives through pending_demands, so bin-packing launches the
        # substitute during the grace window).
        capacity: List[Dict[str, float]] = [
            dict(info["available"]) for info in lm["nodes"].values()
            if not info.get("draining")]
        for pid in self.provider.non_terminated_nodes():
            nid = self.provider.node_cluster_id(pid)
            if nid is not None and nid not in lm["nodes"]:
                t = self._types.get(self.provider.node_type_of(pid) or "")
                if t is not None:
                    capacity.append(dict(t.resources))

        counts = self._counts_by_type()
        to_launch: List[NodeType] = []
        for _pri, demand in sorted(
                prioritized,
                key=lambda pd: (-pd[0], -sum(pd[1].values()))):
            placed = False
            for cap in capacity:
                if _fits(cap, demand):
                    _sub(cap, demand)
                    placed = True
                    break
            if placed:
                continue
            # First-fit over declared types (ref:
            # resource_demand_scheduler.py get_nodes_for).
            for t in self.config.node_types:
                have = counts.get(t.name, 0) + sum(
                    1 for x in to_launch if x.name == t.name)
                if have >= t.max_workers:
                    continue
                if _fits(dict(t.resources), demand):
                    to_launch.append(t)
                    cap = dict(t.resources)
                    _sub(cap, demand)
                    capacity.append(cap)
                    break
            else:
                self._unsatisfied.append(dict(demand))
                logger.warning("demand %s fits no launchable node type",
                               demand)
        # Honor min_workers regardless of demand.
        for t in self.config.node_types:
            have = counts.get(t.name, 0) + sum(
                1 for x in to_launch if x.name == t.name)
            for _ in range(t.min_workers - have):
                to_launch.append(t)

        launched = []
        for t in to_launch[: self.config.max_launch_batch]:
            loop = asyncio.get_event_loop()
            pid = await loop.run_in_executor(
                None, self.provider.create_node, t.name,
                dict(t.resources))
            self._launch_times[pid] = time.time()
            launched.append(pid)
            logger.info("launched %s (%s)", pid, t.name)
        return launched

    async def _scale_down(self, lm: Dict) -> List[str]:
        counts = self._counts_by_type()
        terminated = []
        for pid in list(self.provider.non_terminated_nodes()):
            t = self._types.get(self.provider.node_type_of(pid) or "")
            if t is None:
                continue
            if counts.get(t.name, 0) <= t.min_workers:
                continue
            nid = self.provider.node_cluster_id(pid)
            info = lm["nodes"].get(nid)
            if info is not None and info.get("draining"):
                # Mid-drain nodes die on their own schedule (and their
                # replacement is already launching); idle-reaping one
                # would race the checkpoint-on-notice window.
                continue
            if info is None:
                # Not registered yet: give it launch grace, then treat a
                # silent node as dead and reap it.
                if time.time() - self._launch_times.get(pid, 0) > 120:
                    await asyncio.get_event_loop().run_in_executor(
                        None, self.provider.terminate_node, pid)
                    terminated.append(pid)
                    counts[t.name] -= 1
                continue
            if info["idle_s"] < self.config.idle_timeout_s:
                continue
            if lm["pending_demands"] or lm["pending_placement_groups"]:
                continue  # demand exists; don't thrash
            # Drain-if-idle first: the agent REFUSES if a lease landed
            # since the last heartbeat, closing the observe-then-kill
            # race (ref: DrainRaylet node_manager.proto:407).
            try:
                from ..core.ids import NodeID

                r = await self._cli.call("drain_node", {
                    "node_id": NodeID.from_hex(nid),
                    "if_idle": True, "reason": "idle timeout"})
                if not r.get("ok"):
                    continue  # became busy; retry next round
            except RpcError:
                pass
            loop = asyncio.get_event_loop()
            await loop.run_in_executor(
                None, self.provider.terminate_node, pid)
            terminated.append(pid)
            counts[t.name] -= 1
            logger.info("terminated idle %s (%s)", pid, t.name)
        return terminated
