"""AutoscalingCluster: a head + autoscaler over the fake provider.

Role-equivalent to the reference's cluster_utils.AutoscalingCluster
(ref: python/ray/cluster_utils.py:26) — the hermetic harness that runs
the REAL autoscaler against in-process "cloud" nodes, used by the
autoscaler tests and available to users for local elasticity
experiments.

A head without ``"GPU"`` in ``head_resources`` detects the machine's
GPUs (``num_gpus=None``): pass ``{"CPU": ..., "GPU": 0}`` so that GPU
demand goes pending and the autoscaler launches a GPU node for it.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from ..core import node_launcher
from ..core.config import RuntimeConfig
from .autoscaler import AutoscalerConfig, NodeType, StandardAutoscaler
from .fake_provider import FakeNodeProvider


class AutoscalingCluster:
    def __init__(self, node_types: List[NodeType],
                 head_resources: Optional[dict] = None,
                 idle_timeout_s: float = 60.0,
                 update_interval_s: float = 0.5,
                 config: Optional[RuntimeConfig] = None):
        os.environ["RT_AUTOSCALING_ENABLED"] = "1"
        self.config = config or RuntimeConfig.from_env()
        self.session = f"autoscale_{int(time.time() * 1000) % 10 ** 10}"
        self._procs = []
        proc, self.address = node_launcher.start_controller(
            self.config, self.session)
        self._procs.append(proc)
        head = dict(head_resources or {"CPU": 1})
        proc, _addr, self.head_node_id = node_launcher.start_node_agent(
            self.config, self.session, self.address,
            num_cpus=head.get("CPU"), num_gpus=head.get("GPU"),
            custom_resources={k: v for k, v in head.items()
                              if k not in ("CPU", "GPU")} or None,
            is_head=True, tag="head")
        self._procs.append(proc)
        self.provider = FakeNodeProvider(self.config, self.session,
                                         self.address)
        self.autoscaler = StandardAutoscaler(
            self.address, self.provider,
            AutoscalerConfig(node_types=node_types,
                             idle_timeout_s=idle_timeout_s,
                             update_interval_s=update_interval_s))
        self.autoscaler.start()

    def shutdown(self) -> None:
        self.autoscaler.stop()
        self.provider.shutdown()
        for proc in reversed(self._procs):
            proc.terminate()
        for proc in self._procs:
            try:
                proc.wait(timeout=10)
            except Exception:
                proc.kill()
        os.environ.pop("RT_AUTOSCALING_ENABLED", None)
