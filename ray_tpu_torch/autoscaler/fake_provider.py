"""Hermetic provider: "nodes" are real node-agent processes on this
machine.

Role-equivalent to the reference's fake multi-node provider (ref:
autoscaler/_private/fake_multi_node/node_provider.py), the piece that
makes autoscaler logic testable with no cloud: every launch is a real
agent joining the real controller, so scheduling/draining paths are the
production ones.
"""

from __future__ import annotations

import itertools
import subprocess
from typing import Dict, List, Optional

from ..core import node_launcher
from ..core.config import RuntimeConfig
from .node_provider import NodeProvider


class FakeNodeProvider(NodeProvider):
    def __init__(self, config: RuntimeConfig, session: str,
                 controller_addr: str):
        self._config = config
        self._session = session
        self._controller_addr = controller_addr
        self._counter = itertools.count(1)
        # provider_id -> (proc, node_type, node_id_hex)
        self._nodes: Dict[str, tuple] = {}

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        res = dict(resources)
        num_cpus = res.pop("CPU", None)
        num_gpus = res.pop("GPU", None)
        pid = f"fake-{node_type}-{next(self._counter)}"
        proc, _addr, node_id_hex = node_launcher.start_node_agent(
            self._config, self._session, self._controller_addr,
            num_cpus=num_cpus, num_gpus=num_gpus,
            custom_resources=res or None, tag=pid)
        self._nodes[pid] = (proc, node_type, node_id_hex)
        return pid

    def terminate_node(self, provider_id: str) -> None:
        entry = self._nodes.pop(provider_id, None)
        if entry is None:
            return
        proc: subprocess.Popen = entry[0]
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()

    def non_terminated_nodes(self) -> List[str]:
        return [pid for pid, (proc, _t, _n) in self._nodes.items()
                if proc.poll() is None]

    def node_cluster_id(self, provider_id: str) -> Optional[str]:
        entry = self._nodes.get(provider_id)
        return entry[2] if entry else None

    def node_type_of(self, provider_id: str) -> Optional[str]:
        entry = self._nodes.get(provider_id)
        return entry[1] if entry else None

    def shutdown(self) -> None:
        for pid in list(self._nodes):
            self.terminate_node(pid)
