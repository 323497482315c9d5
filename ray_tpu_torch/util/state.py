"""Cluster state API: the part of ``ray_tpu/util/state.py`` the port has
so far, from a connected driver or by controller address.

``list_nodes``, ``list_leases``, ``torch_profile`` (the counterpart
of ``jax_profile``: an on-demand ``torch.profiler`` capture on every
live worker), and the read side of the telemetry plane: ``telemetry``,
``metrics_history``, ``serve_resilience``, ``load_metrics`` and
``perf``.  The rest of the state API (tasks, actors, objects, logs,
timelines) and its ``rt`` CLI are not ported yet (ROADMAP Queue 1 item
5, "doctor, state and the rt CLI").
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional


def _call(method: str, payload: Optional[Dict] = None,
          address: Optional[str] = None) -> Any:
    """One controller RPC: over the connected runtime's channel, or to
    the controller at ``address`` (``host:port``)."""
    from ..core import runtime as runtime_mod

    if address is None:
        rt = runtime_mod.get_runtime_quiet()
        if rt is None or not hasattr(rt, "controller_call"):
            raise ConnectionError(
                "No cluster: call ray_tpu_torch.init(mode='cluster') "
                "first or pass address=.")
        return rt.controller_call(method, payload or {})
    if address == "auto":
        raise NotImplementedError(
            "address='auto' reads the rt CLI's cluster record, not ported "
            "yet (ROADMAP Queue 1 item 5: 'doctor, state and the rt "
            "CLI'); pass the controller's host:port")
    from ..core.rpc import RpcClient

    async def _go():
        cli = RpcClient(address, connect_timeout=10.0)
        try:
            return await cli.call(method, payload or {})
        finally:
            await cli.close()

    return asyncio.run(_go())


def list_nodes() -> List[Dict]:
    out = []
    for n in _call("list_nodes", {}):
        d = dict(n)
        v = d.get("node_id")
        if hasattr(v, "hex"):
            d["node_id"] = v.hex()
        out.append(d)
    return out


def _agent_call(agent_addr: str, method: str,
                payload: Optional[Dict] = None) -> Any:
    from ..core.rpc import RpcClient

    async def _go():
        cli = RpcClient(agent_addr, connect_timeout=10.0)
        try:
            return await cli.call(method, payload or {})
        finally:
            await cli.close()

    return asyncio.run(_go())


def _agents(node_id: Optional[str]) -> List[Dict]:
    nodes = [n for n in list_nodes() if n["alive"]]
    if node_id:
        nodes = [n for n in nodes
                 if str(n["node_id"]).startswith(node_id)]
    return nodes


def list_leases(*, node_id: Optional[str] = None) -> List[Dict]:
    """Each live node agent's lease ledger: held leases (owner, worker,
    resources, GPU ids, age), queued lease requests and the demand
    vector."""
    out = []
    for n in _agents(node_id):
        try:
            out.append(_agent_call(n["agent_addr"], "list_leases"))
        except Exception as e:  # noqa: BLE001 — one dead agent must
            # not hide every other node's ledger
            out.append({"node_id": n["node_id"],
                        "error": f"agent unreachable: {e}"})
    return out


def torch_profile(*, duration_s: float = 3.0,
                  node_id: Optional[str] = None,
                  force: bool = False) -> List[Dict]:
    """Start an on-demand ``torch.profiler`` capture on every live worker
    (optionally filtered by node prefix) and return
    [{node_id, pid, ok, path, kernels | error}, ...]: ``path`` is the
    worker's Chrome trace, ``kernels`` its device kernels by name and
    count.  Workers that never imported torch are skipped unless
    ``force``; artifact paths are also reported to the controller."""
    from concurrent.futures import ThreadPoolExecutor

    nodes = _agents(node_id)
    if not nodes:
        return []

    def _one(n):
        try:
            r = _agent_call(n["agent_addr"], "torch_profile_workers",
                            {"duration_s": duration_s, "force": force})
        except Exception as e:  # noqa: BLE001 — one dead agent must
            # not discard every other node's finished capture
            return [{"node_id": n["node_id"], "pid": -1, "ok": False,
                     "error": f"agent unreachable: {e}"}]
        return [{"node_id": n["node_id"], **rec}
                for rec in r.get("results", [])]

    # Concurrent fan-out: every node captures the SAME wall-clock
    # window, so one distributed train step shows up on all ranks.
    out: List[Dict] = []
    with ThreadPoolExecutor(max_workers=min(len(nodes), 16)) as ex:
        for rows in ex.map(_one, nodes):
            out.extend(rows)
    return out


def metrics_history(*, source: Optional[str] = None,
                    address: Optional[str] = None) -> Dict[str, Any]:
    """Per-node metric time series: {source: [[ts, {metric: value}],
    ...]} over the controller's retained window."""
    return _call("metrics_history", {"source": source}, address)


def telemetry(*, address: Optional[str] = None) -> Dict[str, Any]:
    """Raw telemetry feed: latest per-source metric snapshots + retained
    flight-recorder dumps.  ``util.telemetry.cluster_summary`` is the
    aggregated operator view."""
    return _call("telemetry", {}, address)


def load_metrics(*, address: Optional[str] = None) -> Dict[str, Any]:
    """The autoscaler's input view: per-node utilization/idle age +
    the cluster demand vector."""
    return _call("get_load_metrics", {}, address)


def serve_resilience(*, address: Optional[str] = None
                     ) -> Dict[str, Any]:
    """The serve resilience plane's published stats (replica
    replacement log, reported breaker states, admission-queue depth
    per deployment), mirrored by the serve controller into the
    cluster KV so readers get it over the plain controller RPC.  Empty
    dict when serve is not running."""
    try:
        raw = _call("kv_get", {"key": "serve/resilience"}, address)
    except Exception:
        return {}
    if not raw:
        return {}
    try:
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode()
        return json.loads(raw)
    except Exception:
        return {}


def perf(*, address: Optional[str] = None) -> Dict[str, Any]:
    """The performance introspection report: roofline position, step
    decomposition, per-axis collective shares, compile events,
    device-memory watermarks; see util/xprof.py."""
    from . import xprof as xprof_mod

    return xprof_mod.cluster_report(address=address)
