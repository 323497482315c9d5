"""Node provider that bootstraps real machines through command runners.

Role-equivalent to the reference's SSH-bootstrapping provider stack
(ref: autoscaler/_private/commands.py get_or_create_head_node +
NodeUpdater in updater.py + the local provider's static host pool, and
autoscaler/_private/gcp/ for the multi-host mode): the launcher and
the autoscaler drive THIS class, which picks a free host (or a whole
slice), pushes file mounts, runs setup commands, and starts the node
agent with `rt start --address=...`, parsing the machine-readable
RT_NODE_ID/RT_PIDS trailer to track it.

Termination kills the recorded pids on every host of the unit and
returns the unit to the free pool.  With ``provider.type: subprocess``
the identical flow runs against this machine (hermetic tests — the
fake-multi-node pattern applied to the SSH path).
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from .cluster_spec import ClusterSpec, NodeTypeSpec
from .command_runner import (CommandRunner, PodCommandRunner,
                             SSHCommandRunner, SubprocessCommandRunner)
from .node_provider import NodeProvider

logger = logging.getLogger("ray_tpu_torch.autoscaler.remote")


def make_runner(spec: ClusterSpec,
                host_or_hosts: Union[str, Sequence[str]]
                ) -> CommandRunner:
    """One host -> plain runner; a host list -> pod fan-out runner."""
    if isinstance(host_or_hosts, (list, tuple)):
        return PodCommandRunner(
            [make_runner(spec, h) for h in host_or_hosts])
    host = host_or_hosts
    if spec.runner_type() == "subprocess":
        return SubprocessCommandRunner(host)
    return SSHCommandRunner(host, user=spec.ssh_user,
                            key_file=spec.ssh_private_key,
                            port=spec.ssh_port)


def split_slice_resources(resources: Dict[str, float],
                          n_hosts: int) -> List[Dict[str, float]]:
    """Per-host resource shares for one slice: CPUs and GPUs divide
    evenly across hosts; slice-level label resources (anything else,
    e.g. ``slice-h100-16: 1``) ride on host 0 only — the reference's
    TPU-pod-head pattern (ref: _private/accelerators/tpu.py:230
    pod-name extra resource on worker 0)."""
    shares: List[Dict[str, float]] = [dict() for _ in range(n_hosts)]
    for key, val in resources.items():
        if key in ("CPU", "GPU"):
            for s in shares:
                s[key] = val / n_hosts
        else:
            shares[0][key] = val
    return shares


@dataclass
class _LaunchedNode:
    provider_id: str
    node_type: str
    unit: Union[str, List[str]]            # host or slice host-list
    node_ids: List[str] = field(default_factory=list)
    pids_by_host: Dict[str, List[int]] = field(default_factory=dict)


def _parse_trailer(output: str) -> Dict[str, str]:
    vals: Dict[str, str] = {}
    for line in output.splitlines():
        if line.startswith("RT_") and "=" in line:
            k, _, v = line.partition("=")
            vals[k] = v.strip()
    return vals


class RemoteNodeProvider(NodeProvider):
    """Static-host-pool provider over command runners (SSH or local)."""

    def __init__(self, spec: ClusterSpec, head_address: str):
        self.spec = spec
        self.head_address = head_address
        self._counter = itertools.count(1)
        self._lock = threading.Lock()
        self._nodes: Dict[str, _LaunchedNode] = {}
        # node type -> free launchable units
        self._free: Dict[str, List[Union[str, List[str]]]] = {}
        for t in spec.worker_types():
            self._free[t.name] = self._auto_pool(t)

    def _auto_pool(self, t: NodeTypeSpec
                   ) -> List[Union[str, List[str]]]:
        pool = self.spec.hosts_for(t.name)
        if pool or self.spec.provider_type != "subprocess":
            return pool
        # Hermetic mode: synthesize localhost units up to max_workers.
        if t.hosts_per_slice > 1:
            return [[f"local-{t.name}-{i}-{h}"
                     for h in range(t.hosts_per_slice)]
                    for i in range(t.max_workers)]
        return [f"local-{t.name}-{i}" for i in range(t.max_workers)]

    # ------------------------------------------------------------ bootstrap
    def _bootstrap_host(self, runner: CommandRunner,
                        resources: Dict[str, float],
                        extra_env: Optional[Dict[str, str]] = None,
                        setup: Sequence[str] = ()) -> Dict[str, str]:
        env = {**self.spec.env, **(extra_env or {})}
        for remote, local in self.spec.file_mounts.items():
            runner.put(local, remote)
        for cmd in (*self.spec.initialization_commands,
                    *self.spec.setup_commands,
                    *self.spec.worker_setup_commands, *setup):
            runner.run(cmd, env=env or None)
        out = runner.run(self.spec.render_start(
            self.spec.worker_start_command,
            address=self.head_address, resources=resources),
            env=env or None, timeout=600.0)
        return _parse_trailer(out)

    def _bootstrap_unit(self, node: "_LaunchedNode",
                        t: NodeTypeSpec,
                        resources: Dict[str, float]) -> None:
        """Push setup + start the agent(s) on every host of the unit.
        On slice-sibling failure, kills agents already started before
        re-raising (subclasses decide what happens to the unit)."""
        unit = node.unit
        if isinstance(unit, list):                      # a slice
            shares = split_slice_resources(
                resources or t.resources, len(unit))

            def _boot(i: int) -> Dict[str, str]:
                return self._bootstrap_host(
                    make_runner(self.spec, unit[i]), shares[i],
                    extra_env={"RT_GPU_WORKER_ID": str(i),
                               "RT_GPU_SLICE": node.provider_id},
                    setup=t.setup_commands)

            # All hosts of the slice bootstrap in parallel — the
            # slice comes up in one host's time, not n hosts'.
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(len(unit)) as pool:
                futs = [pool.submit(_boot, i)
                        for i in range(len(unit))]
                outs: List[Optional[Dict[str, str]]] = []
                first_err: Optional[BaseException] = None
                for f in futs:
                    try:
                        outs.append(f.result())
                    except Exception as e:  # noqa: BLE001
                        first_err = first_err or e
                        outs.append(None)
            for host, tr in zip(unit, outs):
                if tr is None:
                    continue
                node.node_ids.append(tr.get("RT_NODE_ID", ""))
                node.pids_by_host[host] = [
                    int(x) for x in
                    tr.get("RT_PIDS", "").split(",") if x]
            if first_err is not None:
                # A sibling host failed: agents already started on
                # the hosts that succeeded would be orphaned when
                # the unit is released — kill them.
                self._kill_node_pids(node)
                raise first_err
        else:
            runner = make_runner(self.spec, unit)
            tr = self._bootstrap_host(runner,
                                      resources or t.resources,
                                      setup=t.setup_commands)
            node.node_ids.append(tr.get("RT_NODE_ID", ""))
            node.pids_by_host[unit] = [
                int(x) for x in tr.get("RT_PIDS", "").split(",")
                if x]

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        t = self.spec.node_types[node_type]
        with self._lock:
            if not self._free.get(node_type):
                raise RuntimeError(
                    f"no free hosts for node type {node_type!r}")
            unit = self._free[node_type].pop(0)
        pid = f"{node_type}-{next(self._counter)}"
        node = _LaunchedNode(pid, node_type, unit)
        try:
            self._bootstrap_unit(node, t, resources)
        except Exception:
            with self._lock:
                self._free[node_type].insert(0, unit)
            raise
        with self._lock:
            self._nodes[pid] = node
        logger.info("launched %s on %s", pid, unit)
        return pid

    def _kill_node_pids(self, node: "_LaunchedNode") -> None:
        """Best-effort kill of every agent pid recorded for ``node``."""
        hosts = node.unit if isinstance(node.unit, list) else [node.unit]
        for host in hosts:
            pids = node.pids_by_host.get(host, [])
            if not pids:
                continue
            runner = make_runner(self.spec, host)
            kill = " ".join(str(p) for p in pids)
            try:
                runner.run(f"kill {kill} 2>/dev/null; sleep 1; "
                           f"kill -9 {kill} 2>/dev/null; true",
                           timeout=60.0, check=False)
            except Exception:
                logger.warning("kill on %s failed for %s",
                               host, node.provider_id, exc_info=True)

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(provider_id, None)
        if node is None:
            return
        self._kill_node_pids(node)
        with self._lock:
            self._free.setdefault(node.node_type, []).append(node.unit)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def node_cluster_id(self, provider_id: str) -> Optional[str]:
        with self._lock:
            node = self._nodes.get(provider_id)
        if node is None or not node.node_ids:
            return None
        return node.node_ids[0] or None

    def node_type_of(self, provider_id: str) -> Optional[str]:
        with self._lock:
            node = self._nodes.get(provider_id)
        return node.node_type if node else None

    def adopt(self, launched: Dict[str, Dict]) -> None:
        """Pre-register nodes another process already launched (the
        `rt up` min_workers) so this provider neither relaunches them
        nor hands their hosts out again.  ``launched`` is the cluster
        state file's entry: provider_id -> {node_type, unit,
        pids_by_host, node_ids}."""
        with self._lock:
            for pid, rec in launched.items():
                unit = rec["unit"]
                if isinstance(unit, list):
                    unit = list(unit)
                node = _LaunchedNode(
                    pid, rec["node_type"], unit,
                    node_ids=list(rec.get("node_ids") or []),
                    pids_by_host={h: list(p) for h, p in
                                  (rec.get("pids_by_host")
                                   or {}).items()})
                self._nodes[pid] = node
                free = self._free.get(rec["node_type"], [])
                if unit in free:
                    free.remove(unit)
                # Keep the launch counter ahead of adopted ids.
                next(self._counter)

    # Used by `rt down` to clean every known unit, launched or not.
    def all_known_hosts(self) -> List[str]:
        hosts: List[str] = []
        for t in self.spec.worker_types():
            for unit in self.spec.hosts_for(t.name):
                hosts.extend(unit if isinstance(unit, list) else [unit])
        return hosts
