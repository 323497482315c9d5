"""GCP GPU-VM node provider — creates/deletes real H100 capacity.

Role-equivalent to the reference's GCP provider stack (ref:
autoscaler/_private/gcp/node_provider.py GCPNodeProvider, node.py
GCPComputeNode + config.py's provider bootstrap) and the JAX package's
TPU-VM provider, with Compute Engine's instances API in place of the
Cloud TPU API: create an instance (an H100 machine type such as
``a3-highgpu-1g``, ``onHostMaintenance: TERMINATE`` as GPU VMs require,
Spot where the node type asks) -> poll the zone operation -> wait for
RUNNING -> read ``networkInterfaces[].networkIP`` -> bootstrap the host
through the command-runner stack (the path the static-pool provider
uses).  The REST surface is driven directly (no cloud SDK): every call
goes through one ``transport`` function, urllib's by default.

Compute Engine has no counterpart of the TPU API's queued resources:
``provider.use_queued_resources`` is refused when the spec is parsed
(``cluster_spec.parse_cluster_spec``).  A Spot VM is created with
``instanceTerminationAction: STOP``, so a preempted VM stays listed as
TERMINATED and ``reap_preempted`` deletes and untracks it (the JAX
provider reads a TPU node's PREEMPTED state the same way).

Hermetic testing: ``provider.api_base`` points the client at a stub,
``ComputeApi(transport=...)`` replaces the HTTP layer, and
``provider.bootstrap_runner: subprocess`` runs the agent bootstrap on
this machine.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from .cluster_spec import ClusterSpec, NodeTypeSpec
from .remote_provider import RemoteNodeProvider, _LaunchedNode

logger = logging.getLogger("ray_tpu_torch.autoscaler.gcp")

METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                      "instance/service-accounts/default/token")

# (method, url, headers, body) -> (HTTP status, response bytes)
Transport = Callable[[str, str, Dict[str, str], Optional[bytes]],
                     Tuple[int, bytes]]


def urllib_transport(method: str, url: str, headers: Dict[str, str],
                     body: Optional[bytes]) -> Tuple[int, bytes]:
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class GcpApiError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"GCP API error {status}: {body[-500:]}")
        self.status = status


class ComputeApi:
    """Thin client for Compute Engine's zonal instances surface (ref:
    https://cloud.google.com/compute/docs/reference/rest/v1/instances)."""

    def __init__(self, project: str, zone: str, *,
                 api_base: Optional[str] = None,
                 access_token: Optional[str] = None,
                 transport: Optional[Transport] = None):
        self.base = (api_base
                     or "https://compute.googleapis.com/compute/v1"
                     ).rstrip("/")
        self.zone = zone
        self.parent = f"projects/{project}/zones/{zone}"
        self._token = access_token
        self._transport = transport or urllib_transport

    # ------------------------------------------------------------- plumbing
    def _auth_header(self) -> Dict[str, str]:
        if self._token:
            return {"Authorization": f"Bearer {self._token}"}
        # The VM's service-account token (how a head VM authenticates).
        try:
            status, raw = self._transport(
                "GET", METADATA_TOKEN_URL, {"Metadata-Flavor": "Google"},
                None)
            if status == 200:
                tok = json.loads(raw)["access_token"]
                return {"Authorization": f"Bearer {tok}"}
        except Exception:
            pass
        return {}

    def _request(self, method: str, path: str,
                 body: Optional[Dict] = None) -> Dict[str, Any]:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json",
                   **self._auth_header()}
        status, payload = self._transport(method, f"{self.base}/{path}",
                                          headers, data)
        if status >= 400:
            raise GcpApiError(status, payload.decode("utf-8", "replace"))
        return json.loads(payload) if payload else {}

    # ------------------------------------------------------------ instances
    def instance_body(self, name: str, t: NodeTypeSpec,
                      labels: Optional[Dict[str, str]] = None) -> Dict:
        """The insert request for one GPU VM of node type ``t``."""
        scheduling: Dict[str, Any] = {"onHostMaintenance": "TERMINATE",
                                      "automaticRestart": not t.spot}
        if t.spot:
            scheduling.update(provisioningModel="SPOT",
                              instanceTerminationAction="STOP")
        return {"name": name,
                "machineType": f"zones/{self.zone}/machineTypes/"
                               f"{t.machine_type}",
                "labels": labels or {},
                "scheduling": scheduling,
                "disks": [{"boot": True, "autoDelete": True,
                           "initializeParams": {
                               "sourceImage": t.source_image}}],
                "networkInterfaces": [{
                    "network": "global/networks/default"}]}

    def create_instance(self, body: Dict) -> Dict:
        return self._request("POST", f"{self.parent}/instances", body)

    def get_instance(self, name: str) -> Dict:
        return self._request("GET", f"{self.parent}/instances/{name}")

    def list_instances(self) -> List[Dict]:
        out: List[Dict] = []
        token = ""
        while True:
            path = f"{self.parent}/instances"
            if token:
                path += f"?pageToken={token}"
            r = self._request("GET", path)
            out.extend(r.get("items", []))
            token = r.get("nextPageToken") or ""
            if not token:
                return out

    def delete_instance(self, name: str) -> Dict:
        return self._request("DELETE", f"{self.parent}/instances/{name}")

    # ----------------------------------------------------- zone operations
    def get_operation(self, op_name: str) -> Dict:
        return self._request("GET", f"{self.parent}/operations/{op_name}")

    def wait_operation(self, op: Dict, *, timeout: float = 600.0,
                       poll_s: float = 2.0) -> Dict:
        """Poll a zone operation to DONE (ref: node.py
        wait_for_compute_zone_operation)."""
        deadline = time.time() + timeout
        while op.get("status") != "DONE":
            if time.time() > deadline:
                raise TimeoutError(
                    f"operation {op.get('name')} never completed")
            time.sleep(poll_s)
            op = self.get_operation(op["name"])
        if op.get("error"):
            errors = op["error"].get("errors") or [{}]
            raise GcpApiError(op.get("httpErrorStatusCode", -1),
                              json.dumps(errors))
        return op


def _instance_ips(instance: Dict) -> List[str]:
    """Internal IPs of the VM (ref: node.py GCPComputeNode
    .get_internal_ip over networkInterfaces)."""
    return [nic["networkIP"]
            for nic in instance.get("networkInterfaces") or []
            if nic.get("networkIP")]


class GCPGpuNodeProvider(RemoteNodeProvider):
    """Creates GPU VMs through Compute Engine, then bootstraps their
    host with the shared command-runner path.  Provider node id == the
    instance name, so adoption/termination survive restarts."""

    def __init__(self, spec: ClusterSpec, head_address: str):
        super().__init__(spec, head_address)
        g = spec.gcp
        self.api = ComputeApi(g["project_id"], g["zone"],
                              api_base=g.get("api_base"),
                              access_token=g.get("access_token"))
        self.poll_s = float(g.get("poll_interval_s", 2.0))
        self.create_timeout_s = float(g.get("create_timeout_s", 900.0))
        # Instance names carry a per-provider nonce: a restarted
        # provider's counter restarts at 1 and would otherwise collide
        # with adopted instances' names (409 alreadyExists).
        self._nonce = os.urandom(2).hex()

    def _auto_pool(self, t: NodeTypeSpec) -> List:
        return []  # capacity comes from the cloud, not a host pool

    # ------------------------------------------------------------ lifecycle
    def _await_running(self, name: str) -> Dict:
        deadline = time.time() + self.create_timeout_s
        while time.time() < deadline:
            inst = self.api.get_instance(name)
            status = inst.get("status")
            if status == "RUNNING":
                return inst
            if status in ("STOPPING", "STOPPED", "SUSPENDED",
                          "TERMINATED"):
                raise RuntimeError(
                    f"GPU VM {name} entered status {status}")
            time.sleep(self.poll_s)
        raise TimeoutError(f"GPU VM {name} never became RUNNING")

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        t = self.spec.node_types[node_type]
        if not t.machine_type:
            raise ValueError(
                f"node type {node_type!r} needs machine_type for "
                f"provider.type: gcp")
        with self._lock:
            n = next(self._counter)
        name = (f"{self.spec.cluster_name}-{node_type}"
                f"-{self._nonce}-{n}".replace("_", "-").lower())
        # GCP label values must be lowercase [a-z0-9-]; sanitize the
        # same way names are so create never trips the charset rule.
        labels = {"rt-cluster": self._label_cluster_name(),
                  "rt-node-type": node_type.replace("_", "-").lower()}
        # ANY failure between the create request and a recorded,
        # bootstrapped node must delete the VM — one stuck in
        # PROVISIONING would otherwise bill untracked.
        try:
            op = self.api.create_instance(
                self.api.instance_body(name, t, labels))
            self.api.wait_operation(op, timeout=self.create_timeout_s,
                                    poll_s=self.poll_s)
            ips = _instance_ips(self._await_running(name))
            if not ips:
                raise RuntimeError(
                    f"GPU VM {name} is RUNNING but has no networkIP")
        except Exception:
            self._delete_instance(name)
            raise
        node = _LaunchedNode(name, node_type, ips[0])
        try:
            self._bootstrap_unit(node, t, resources)
        except Exception:
            # Paid capacity must not leak when bootstrap fails.
            self._delete_instance(name)
            raise
        with self._lock:
            self._nodes[name] = node
        logger.info("launched GPU VM %s (%s) on %s", name,
                    t.machine_type, ips[0])
        return name

    def _delete_instance(self, name: str) -> None:
        try:
            op = self.api.delete_instance(name)
            self.api.wait_operation(op, timeout=300.0, poll_s=self.poll_s)
        except GcpApiError as e:
            if e.status != 404:
                logger.warning("delete of GPU VM %s failed: %s", name, e)
        except Exception:
            logger.warning("delete of GPU VM %s failed", name,
                           exc_info=True)

    def _label_cluster_name(self) -> str:
        """cluster_name sanitized to GCP's label-value charset
        (lowercase [a-z0-9-]) — must match what create_node stamps."""
        return self.spec.cluster_name.replace("_", "-").lower()

    def cleanup_cluster_capacity(self) -> List[str]:
        """Delete EVERY VM labeled with this cluster — the `rt down`
        backstop for autoscaler-launched nodes that never reached the
        state file (leaked paid capacity otherwise)."""
        deleted: List[str] = []
        try:
            instances = self.api.list_instances()
        except Exception:
            logger.warning("list_instances failed during cleanup",
                           exc_info=True)
            return deleted
        for inst in instances:
            name = inst.get("name") or ""
            if not name:
                continue
            label = (inst.get("labels") or {}).get("rt-cluster")
            if label != self._label_cluster_name():
                # A VM labeled for a DIFFERENT cluster is never ours,
                # even if its name shares our prefix ("rt" vs
                # "rt-demo"); the prefix fallback covers unlabeled VMs.
                if label is not None:
                    continue
                if not name.startswith(self._label_cluster_name() + "-"):
                    continue
            self._delete_instance(name)
            deleted.append(name)
        return deleted

    def reap_preempted(self) -> List[str]:
        """Untrack VMs that Compute Engine reports TERMINATED (a Spot
        preemption, or a host event under ``onHostMaintenance:
        TERMINATE``) so the autoscaler relaunches replacements against
        the type's target.  The dead VM is deleted: a TERMINATED
        instance still holds its name and disk until then."""
        try:
            states = {i.get("name"): i.get("status")
                      for i in self.api.list_instances()}
        except Exception:
            logger.warning("list_instances failed during preemption "
                           "scan", exc_info=True)
            return []
        reaped = []
        with self._lock:
            tracked = list(self._nodes)
        for pid in tracked:
            # Only an EXPLICIT terminal status reaps: a VM merely
            # missing from a (transient, truncated) listing is unknown.
            if states.get(pid) != "TERMINATED":
                continue
            with self._lock:
                node = self._nodes.pop(pid, None)
            if node is None:
                continue
            logger.warning("GPU VM %s is TERMINATED; reaping for "
                           "replacement", pid)
            self._kill_node_pids(node)
            self._delete_instance(pid)
            reaped.append(pid)
        return reaped

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(provider_id, None)
        if node is not None:
            self._kill_node_pids(node)
        self._delete_instance(provider_id)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)
