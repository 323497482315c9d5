"""Provider interface: how the autoscaler creates/destroys nodes.

Role-equivalent to the reference's NodeProvider (ref:
python/ray/autoscaler/node_provider.py) reduced to the lifecycle the
scaler actually drives.  A provider launches a machine that runs
``rt start --address=<head>`` (or its in-process equivalent) and
reports which launched nodes are still alive.

Slice note: a provider node is the atomicity unit — a multi-host
node type maps to one whole slice of GPU machines (all its hosts join
as agents), as the JAX package's TPU slice does, where the reference's
``tpu_command_runner.py`` fans out to every host in the pod.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional


class NodeProvider(abc.ABC):
    @abc.abstractmethod
    def create_node(self, node_type: str, resources: Dict[str, float]
                    ) -> str:
        """Launch one node of ``node_type``; returns a provider node id."""

    @abc.abstractmethod
    def terminate_node(self, provider_id: str) -> None:
        """Tear the node down (drain is the scaler's job)."""

    @abc.abstractmethod
    def non_terminated_nodes(self) -> List[str]:
        """Provider ids of launched nodes still running."""

    def node_cluster_id(self, provider_id: str) -> Optional[str]:
        """Controller node-id hex for a launched node, once known."""
        return None

    def node_type_of(self, provider_id: str) -> Optional[str]:
        return None
