"""Autoscaler: demand-driven node launch/terminate over a provider.

Role-equivalent to the reference's autoscaler (ref:
autoscaler/_private/autoscaler.py:171 StandardAutoscaler.update,
resource_demand_scheduler.py bin-packing, fake_multi_node/ hermetic
provider, gcp/ node types).  ``GPU`` takes the place of the JAX
package's ``TPU``; ``gcp_provider.py`` creates GPU VMs through Compute
Engine.
"""

from .autoscaler import NodeType, StandardAutoscaler  # noqa
from .cluster_spec import ClusterSpec, load_cluster_spec  # noqa
from .command_runner import (CommandRunner, PodCommandRunner,  # noqa
                             SSHCommandRunner, SubprocessCommandRunner)
from .fake_provider import FakeNodeProvider  # noqa
from .node_provider import NodeProvider  # noqa
from .remote_provider import RemoteNodeProvider  # noqa
from .sdk import AutoscalingCluster  # noqa
