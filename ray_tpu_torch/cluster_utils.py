"""Multi-node test cluster on a single machine.

Role-equivalent to the reference's ray.cluster_utils.Cluster (ref:
python/ray/cluster_utils.py:135) — per SURVEY.md §4.2 the single
highest-leverage piece of test infrastructure: N node agents as separate
OS processes sharing one controller, exercising real distributed paths
(spillback scheduling, object transfer, node failure) with no cloud.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .core.config import RuntimeConfig
from .core import node_launcher


@dataclass
class NodeHandle:
    proc: subprocess.Popen
    agent_addr: str
    node_id_hex: str


class Cluster:
    """Start a controller and add/remove node agents programmatically."""

    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None,
                 config: Optional[RuntimeConfig] = None):
        self.config = config or RuntimeConfig.from_env()
        self.session = f"testcluster_{int(time.time()*1000) % 10**10}"
        self._controller_proc, self.address = node_launcher.start_controller(
            self.config, self.session)
        self.nodes: List[NodeHandle] = []
        if initialize_head:
            self.add_node(is_head=True, **(head_node_args or {}))

    @property
    def head_node(self) -> NodeHandle:
        return self.nodes[0]

    def add_node(self, *, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 is_head: bool = False) -> NodeHandle:
        proc, addr, nid = node_launcher.start_node_agent(
            self.config, self.session, self.address,
            num_cpus=num_cpus, num_gpus=num_gpus,
            custom_resources=resources, is_head=is_head,
            tag=f"n{len(self.nodes)}")
        handle = NodeHandle(proc, addr, nid)
        self.nodes.append(handle)
        return handle

    def preempt_node(self, node: NodeHandle,
                     grace_s: float = 3.0) -> None:
        """Preempt a node the way GCP does: SIGTERM (the preemption
        notice — the agent enters DRAINING, training gangs get the
        interruption flag and checkpoint-on-notice), then after
        ``grace_s`` the agent AND its workers are SIGKILLed like the
        VM vanishing.  Blocks for the grace window."""
        from .testing.chaos import preempt_node_processes

        preempt_node_processes(node, grace_s)
        try:
            self.nodes.remove(node)
        except ValueError:
            pass

    def remove_node(self, node: NodeHandle, *,
                    allow_graceful: bool = False) -> None:
        """Kill a node agent (and its workers), simulating node failure."""
        try:
            if allow_graceful:
                node.proc.terminate()
            else:
                node.proc.kill()
            node.proc.wait(timeout=10)
        except Exception:
            pass
        self.nodes.remove(node)

    def kill_controller(self) -> None:
        """SIGKILL the controller (GCS fault injection)."""
        self._controller_proc.kill()
        self._controller_proc.wait(timeout=10)

    def restart_controller(self) -> None:
        """Start a fresh controller on the SAME address/session — the
        GCS-restart scenario (ref: NotifyGCSRestart): with persistence
        on, it reloads its tables and agents/drivers reconnect."""
        from .core.net import port_of

        self._controller_proc, addr = node_launcher.start_controller(
            self.config, self.session, port=port_of(self.address))
        assert addr == self.address, (addr, self.address)

    def wait_for_nodes(self, timeout: float = 30.0) -> None:
        """Block until every added node is registered and alive."""
        import ray_tpu_torch

        deadline = time.time() + timeout
        want = {n.node_id_hex for n in self.nodes}
        while time.time() < deadline:
            alive = {n["NodeID"] for n in ray_tpu_torch.nodes() if n["Alive"]}
            if want <= alive:
                return
            time.sleep(0.1)
        raise TimeoutError(f"nodes never came up: {want - alive}")

    def shutdown(self) -> None:
        for node in list(self.nodes):
            try:
                node.proc.kill()
                node.proc.wait(timeout=5)
            except Exception:
                pass
        self.nodes.clear()
        try:
            self._controller_proc.kill()
            self._controller_proc.wait(timeout=5)
        except Exception:
            pass
        # Clean session shm segments.
        import os

        prefix = f"rt_{self.session}_"
        try:
            for name in os.listdir("/dev/shm"):
                if name.startswith(prefix):
                    try:
                        os.unlink(os.path.join("/dev/shm", name))
                    except OSError:
                        pass
        except OSError:
            pass
