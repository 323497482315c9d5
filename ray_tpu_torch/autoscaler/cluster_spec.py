"""Cluster spec: the YAML schema behind ``rt up``.

Role-equivalent to the reference's cluster YAML (ref:
python/ray/autoscaler/ray-schema.json and the multi-host examples
under autoscaler/gcp/): a named cluster, a provider section describing
reachable machines, auth for SSH, node types with resources and min/max
counts, file mounts, and setup/start commands.

The JAX package's schema with GPU for TPU: the provider section
enumerates hosts — a static host pool per node type (the reference's
"local" provider pattern) and ``gpu_slices``, host groups that are
created/destroyed atomically with commands fanned to every host (one
logical node of several GPU machines, the JAX package's TPU slice).
``provider.type: subprocess`` runs the identical flow against this
machine for hermetic tests; ``provider.type: gcp`` creates GPU VMs
through Compute Engine (``gcp_provider.py``).
"""

from __future__ import annotations

import os
import shlex
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

DEFAULT_HEAD_START = (
    "python -m ray_tpu_torch.scripts.cli start --head --port {port}"
    " --resources {resources}")
DEFAULT_SOURCE_IMAGE = ("projects/deeplearning-platform-release/global/"
                        "images/family/common-cu124-ubuntu-2204")
DEFAULT_WORKER_START = (
    "python -m ray_tpu_torch.scripts.cli start --address {address}"
    " --resources {resources}")


@dataclass
class NodeTypeSpec:
    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 0
    # Slice mode: >1 means one logical node = one slice of this many
    # hosts; worker start fans out to each (host 0 carries any
    # slice-level label resources, like the JAX package's slice head).
    hosts_per_slice: int = 1
    setup_commands: List[str] = field(default_factory=list)
    # provider.type gcp: the GPU VM this node type creates (ref:
    # autoscaler/_private/gcp/config.py node_config machineType): an
    # H100 machine type such as a3-highgpu-1g, its boot image, and
    # Spot provisioning where asked.
    machine_type: Optional[str] = None
    source_image: str = DEFAULT_SOURCE_IMAGE
    spot: bool = False


@dataclass
class ClusterSpec:
    cluster_name: str
    provider_type: str                      # "ssh" | "subprocess"
    head_host: str
    head_node_type: str
    node_types: Dict[str, NodeTypeSpec]
    # node type -> flat host pool (one host per node)
    worker_hosts: Dict[str, List[str]] = field(default_factory=dict)
    # node type -> list of slices, each a list of hosts
    gpu_slices: Dict[str, List[List[str]]] = field(default_factory=dict)
    ssh_user: Optional[str] = None
    ssh_private_key: Optional[str] = None
    ssh_port: int = 22
    head_port: int = 6379
    file_mounts: Dict[str, str] = field(default_factory=dict)
    initialization_commands: List[str] = field(default_factory=list)
    setup_commands: List[str] = field(default_factory=list)
    head_setup_commands: List[str] = field(default_factory=list)
    worker_setup_commands: List[str] = field(default_factory=list)
    head_start_command: str = DEFAULT_HEAD_START
    worker_start_command: str = DEFAULT_WORKER_START
    idle_timeout_s: float = 60.0
    env: Dict[str, str] = field(default_factory=dict)
    # provider.type gcp: project/zone/api options (ref:
    # autoscaler/_private/gcp/config.py provider section).
    gcp: Dict[str, Any] = field(default_factory=dict)

    def runner_type(self) -> str:
        """How setup/start commands reach a host: 'subprocess' for
        hermetic local execution, 'ssh' otherwise.  GCP clusters may
        force subprocess for tests (provider.bootstrap_runner)."""
        if self.provider_type == "subprocess":
            return "subprocess"
        if self.gcp.get("bootstrap_runner") == "subprocess":
            return "subprocess"
        return "ssh"

    # ------------------------------------------------------------ helpers
    def head_type(self) -> NodeTypeSpec:
        return self.node_types[self.head_node_type]

    def worker_types(self) -> List[NodeTypeSpec]:
        return [t for n, t in self.node_types.items()
                if n != self.head_node_type]

    def hosts_for(self, node_type: str) -> List[Any]:
        """Launchable units for a type: hosts, or host-lists (slices)."""
        t = self.node_types[node_type]
        if t.hosts_per_slice > 1:
            return list(self.gpu_slices.get(node_type, []))
        return list(self.worker_hosts.get(node_type, []))

    def render_start(self, template: str, *, address: str = "",
                     resources: Dict[str, float] | None = None) -> str:
        return template.format(
            port=self.head_port, address=address,
            resources=shlex.quote(
                __import__("json").dumps(resources or {})))


def _as_cmd_list(v: Any) -> List[str]:
    if v is None:
        return []
    if isinstance(v, str):
        return [v]
    return [str(x) for x in v]


def load_cluster_spec(path: str) -> ClusterSpec:
    """Parse + validate a cluster YAML into a ClusterSpec."""
    import yaml

    with open(os.path.expanduser(path)) as f:
        raw = yaml.safe_load(f) or {}
    return parse_cluster_spec(raw)


def parse_cluster_spec(raw: Dict[str, Any]) -> ClusterSpec:
    for req in ("cluster_name", "provider", "available_node_types",
                "head_node_type"):
        if req not in raw:
            raise ValueError(f"cluster spec missing required key {req!r}")
    prov = raw["provider"]
    ptype = prov.get("type", "ssh")
    if ptype not in ("ssh", "subprocess", "gcp"):
        raise ValueError(f"unknown provider.type {ptype!r} "
                         "(expected 'ssh', 'subprocess' or 'gcp')")
    gcp_cfg: Dict[str, Any] = {}
    if ptype == "gcp":
        for req in ("project_id", "zone"):
            if req not in prov:
                raise ValueError(
                    f"provider.type gcp requires provider.{req}")
        if prov.get("use_queued_resources"):
            raise ValueError(
                "provider.use_queued_resources is a TPU API feature: "
                "Compute Engine has no queued resources for GPU VMs "
                "(use Spot VMs, node_type spot: true, or a reservation "
                "instead)")
        gcp_cfg = {k: prov[k] for k in
                   ("project_id", "zone", "api_base",
                    "bootstrap_runner", "access_token",
                    "poll_interval_s", "create_timeout_s") if k in prov}

    node_types: Dict[str, NodeTypeSpec] = {}
    for name, nt in raw["available_node_types"].items():
        node_types[name] = NodeTypeSpec(
            name=name,
            resources={k: float(v)
                       for k, v in (nt.get("resources") or {}).items()},
            min_workers=int(nt.get("min_workers", 0)),
            max_workers=int(nt.get("max_workers",
                                   nt.get("min_workers", 0))),
            hosts_per_slice=int(nt.get("hosts_per_slice", 1)),
            setup_commands=_as_cmd_list(nt.get("setup_commands")),
            machine_type=nt.get("machine_type"),
            source_image=str(nt.get("source_image",
                                    DEFAULT_SOURCE_IMAGE)),
            spot=bool(nt.get("spot", False)),
        )
    head_type = raw["head_node_type"]
    if head_type not in node_types:
        raise ValueError(f"head_node_type {head_type!r} not in "
                         "available_node_types")

    auth = raw.get("auth") or {}
    worker_hosts = {k: list(v) for k, v in
                    (prov.get("worker_hosts") or {}).items()}
    gpu_slices = {k: [list(s) for s in v] for k, v in
                  (prov.get("gpu_slices") or {}).items()}
    for name, t in node_types.items():
        if name == head_type:
            continue
        pool = (gpu_slices.get(name) if t.hosts_per_slice > 1
                else worker_hosts.get(name))
        if t.max_workers > 0 and ptype == "ssh" and not pool:
            raise ValueError(
                f"node type {name!r} has max_workers={t.max_workers} "
                "but no hosts in provider.worker_hosts/gpu_slices")
        if t.hosts_per_slice > 1:
            for s in gpu_slices.get(name, []):
                if len(s) != t.hosts_per_slice:
                    raise ValueError(
                        f"slice {s} of type {name!r} has {len(s)} "
                        f"hosts, expected {t.hosts_per_slice}")

    head_host = prov.get("head_host",
                         "localhost" if ptype == "subprocess" else None)
    if not head_host:
        raise ValueError("provider.head_host is required for type: ssh")

    env = {str(k): str(v) for k, v in (raw.get("env") or {}).items()}
    if any(t.max_workers > t.min_workers for n, t in node_types.items()
           if n != head_type):
        # Scalable cluster: agents must HOLD cluster-infeasible demand
        # (reported to the scaling loop) instead of failing fast.
        env.setdefault("RT_AUTOSCALING_ENABLED", "1")

    return ClusterSpec(
        cluster_name=str(raw["cluster_name"]),
        provider_type=ptype,
        head_host=head_host,
        head_node_type=head_type,
        node_types=node_types,
        worker_hosts=worker_hosts,
        gpu_slices=gpu_slices,
        ssh_user=auth.get("ssh_user"),
        ssh_private_key=auth.get("ssh_private_key"),
        ssh_port=int(auth.get("ssh_port", 22)),
        head_port=int(prov.get("head_port", 6379)),
        file_mounts={str(k): str(v)
                     for k, v in (raw.get("file_mounts") or {}).items()},
        initialization_commands=_as_cmd_list(
            raw.get("initialization_commands")),
        setup_commands=_as_cmd_list(raw.get("setup_commands")),
        head_setup_commands=_as_cmd_list(raw.get("head_setup_commands")),
        worker_setup_commands=_as_cmd_list(
            raw.get("worker_setup_commands")),
        head_start_command=str(
            raw.get("head_start_command") or DEFAULT_HEAD_START),
        worker_start_command=str(
            raw.get("worker_start_command") or DEFAULT_WORKER_START),
        idle_timeout_s=float(raw.get("idle_timeout_s", 60.0)),
        env=env,
        gcp=gcp_cfg,
    )
