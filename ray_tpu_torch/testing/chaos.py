"""Chaos killers: background threads that keep killing cluster pieces.

Role-equivalent to the reference's chaos fixtures (ref:
python/ray/_private/test_utils.py — NodeKillerBase:1581 kills raylets,
WorkerKillerActor:1678 kills task workers mid-run).  Process-based
rather than actor-based: the single-machine Cluster fixture exposes the
OS processes directly, so killers operate on pids — the failure the
system sees (SIGKILL, no goodbye) is identical.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import List, Optional


class _KillerThread:
    def __init__(self, interval_s: float, seed: int,
                 max_kills: int = 0):
        self._interval = interval_s
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._max_kills = max_kills  # 0 = unbounded
        self.kills: List[int] = []

    def start(self) -> "_KillerThread":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            if self._max_kills and len(self.kills) >= self._max_kills:
                return
            try:
                pid = self._pick()
            except Exception:
                continue
            if pid is None:
                continue
            try:
                self._kill(pid)
                self.kills.append(pid)
            except (ProcessLookupError, PermissionError):
                pass

    def _kill(self, pid: int) -> None:
        os.kill(pid, signal.SIGKILL)

    def _pick(self) -> Optional[int]:  # pragma: no cover - abstract
        raise NotImplementedError


class NodeKiller(_KillerThread):
    """Kills a random non-head node agent from a Cluster fixture (ref:
    NodeKillerBase)."""

    def __init__(self, cluster, interval_s: float = 5.0, seed: int = 0,
                 spare_head: bool = True, max_kills: int = 0):
        super().__init__(interval_s, seed, max_kills)
        self._cluster = cluster
        self._spare_head = spare_head

    def _pick(self) -> Optional[int]:
        nodes = list(self._cluster.nodes)
        if self._spare_head and nodes:
            nodes = nodes[1:]
        live = [n for n in nodes if n.proc.poll() is None]
        if not live:
            return None
        victim = self._rng.choice(live)
        return victim.proc.pid


class PreemptionKiller(_KillerThread):
    """Mirrors a real GCP spot preemption: the victim node agent gets
    SIGTERM (the preemption notice — it enters DRAINING and the
    training plane races a checkpoint-on-notice), then after the
    configured grace the whole node dies hard — SIGKILL to the agent
    AND every worker process it hosts, like the VM vanishing (ref:
    NodeKillerBase, plus the GCP preemption-notice semantics the
    drain plane exists for)."""

    def __init__(self, cluster, interval_s: float = 10.0,
                 grace_s: float = 3.0, seed: int = 0,
                 spare_head: bool = True, max_kills: int = 0):
        super().__init__(interval_s, seed, max_kills)
        self._cluster = cluster
        self._grace = grace_s
        self._spare_head = spare_head

    def _pick(self):
        nodes = list(self._cluster.nodes)
        if self._spare_head and nodes:
            nodes = nodes[1:]
        live = [n for n in nodes if n.proc.poll() is None]
        if not live:
            return None
        return self._rng.choice(live)

    def _kill(self, node) -> None:
        preempt_node_processes(node, self._grace,
                               stop_event=self._stop)


def _agent_worker_pids(agent_addr: str) -> List[int]:
    """Worker pids of a (single-machine test) node agent, via its
    list_workers RPC — the processes a real VM death would take out
    along with the agent."""
    import asyncio

    from ..core.rpc import RpcClient

    async def _go():
        cli = RpcClient(agent_addr, connect_timeout=5.0)
        try:
            r = await cli.call("list_workers", {})
            return [w["pid"] for w in r.get("workers", [])]
        finally:
            await cli.close()

    try:
        return asyncio.run(_go())
    except Exception:
        return []


def preempt_node_processes(node, grace_s: float,
                           stop_event: Optional[threading.Event] = None
                           ) -> None:
    """SIGTERM the agent (preemption notice), wait ``grace_s``, then
    SIGKILL the agent and every worker it hosted — the full lifecycle
    of an announced VM death.  ``node`` is a cluster_utils.NodeHandle
    (or anything with .proc and .agent_addr)."""
    worker_pids = _agent_worker_pids(node.agent_addr)
    try:
        node.proc.terminate()  # the notice
    except (ProcessLookupError, PermissionError):
        pass
    if stop_event is not None:
        stop_event.wait(grace_s)
    else:
        time.sleep(grace_s)
    for pid in [node.proc.pid] + worker_pids:
        try:
            os.kill(pid, signal.SIGKILL)  # the VM dies
        except (ProcessLookupError, PermissionError):
            pass
    try:
        node.proc.wait(timeout=5)
    except Exception:
        pass


def _controller_call(address: str, method: str, payload=None):
    import asyncio

    from ..core.rpc import RpcClient

    async def _go():
        cli = RpcClient(address, connect_timeout=5.0)
        try:
            return await cli.call(method, payload or {})
        finally:
            await cli.close()

    return asyncio.run(_go())


class ReplicaKiller(_KillerThread):
    """SIGKILLs a random SERVE REPLICA worker by pid — the chaos the
    request-resilience plane exists for (failover retries + circuit
    breakers must absorb the death before the serve controller's
    health probe replaces the actor).  Replica workers are found by
    cross-referencing the controller's actor table (class ``_Replica``)
    with each node agent's worker inventory, exactly the processes a
    crashing model server would take out (ref: WorkerKillerActor, but
    aimed at serve replicas specifically)."""

    def __init__(self, cluster, interval_s: float = 2.0, seed: int = 0,
                 max_kills: int = 0):
        super().__init__(interval_s, seed, max_kills)
        self._cluster = cluster

    def _replica_actor_ids(self) -> set:
        actors = _controller_call(self._cluster.address,
                                  "list_actors") or []
        out = set()
        for a in actors:
            if a.get("class_name") == "_Replica":
                aid = a.get("actor_id")
                out.add(aid.hex() if hasattr(aid, "hex") else str(aid))
        return out

    def _pick(self) -> Optional[int]:
        replicas = self._replica_actor_ids()
        if not replicas:
            return None
        pids: List[int] = []
        for node in self._cluster.nodes:
            if node.proc.poll() is not None:
                continue
            try:
                import asyncio

                from ..core.rpc import RpcClient

                async def _go(addr=node.agent_addr):
                    cli = RpcClient(addr, connect_timeout=5.0)
                    try:
                        return await cli.call("list_workers", {})
                    finally:
                        await cli.close()

                info = asyncio.run(_go())
            except Exception:
                continue
            for w in info.get("workers", []):
                if w.get("actor_id") in replicas:
                    pids.append(w["pid"])
        if not pids:
            return None
        return self._rng.choice(pids)


class TornWriteInjector:
    """SIGKILLs a saving process mid-shard-write — the torn-write
    chaos the crash-atomic checkpoint commit exists for.  A watcher
    thread polls the run directory for an in-progress staging dir
    (``checkpoint_*.tmp/``) containing at least ``min_files`` data
    files, then kills the target pid dead, leaving exactly the
    half-written state a preemption SIGKILL at the grace deadline
    leaves.  ``find_latest_in``/restore must then land on the last
    COMMITTED checkpoint and ``rt doctor`` must name the torn dir."""

    def __init__(self, run_dir: str, pid: int,
                 min_files: int = 1, poll_s: float = 0.002):
        self.run_dir = run_dir
        self.pid = pid
        self.min_files = min_files
        self._poll = poll_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.killed_at: Optional[str] = None  # the tmp dir we tore

    def start(self) -> "TornWriteInjector":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _staging_files(self):
        import glob

        for tmp in glob.glob(os.path.join(self.run_dir,
                                          "checkpoint_*.tmp")):
            files = glob.glob(os.path.join(tmp, "shard_*", "*.npy")) \
                + glob.glob(os.path.join(tmp, "*.msgpack")) \
                + glob.glob(os.path.join(tmp, "shard_*", "*.npy.tmp"))
            if len(files) >= self.min_files:
                return tmp
        return None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                tmp = self._staging_files()
            except OSError:
                continue
            if tmp is None:
                continue
            try:
                os.kill(self.pid, signal.SIGKILL)
                self.killed_at = tmp
            except (ProcessLookupError, PermissionError):
                pass
            return


class WorkerKiller(_KillerThread):
    """Kills a random live worker process of the given agents (ref:
    WorkerKillerActor — kills the process executing a task, exercising
    retry paths)."""

    def __init__(self, agent_call, interval_s: float = 2.0,
                 seed: int = 0, max_kills: int = 0):
        """``agent_call(method, payload)`` reaches a node agent (e.g.
        ``runtime.agent_call``)."""
        super().__init__(interval_s, seed, max_kills)
        self._agent_call = agent_call

    def _pick(self) -> Optional[int]:
        info = self._agent_call("list_workers", {})
        pids = [w["pid"] for w in info.get("workers", [])
                if w.get("state") in ("leased", "actor")]
        if not pids:
            return None
        return self._rng.choice(pids)
