"""Cluster launcher verbs: up / down / exec / autoscale.

Role-equivalent to the reference's `ray up` family (ref:
autoscaler/_private/commands.py get_or_create_head_node:?,
teardown_cluster, exec_cluster): `rt up cluster.yaml` bootstraps the
head over a command runner, records the cluster state, brings up
min_workers through the RemoteNodeProvider, and starts the scaling
loop on the head so the cluster keeps reconciling after the laptop
disconnects — the reference's monitor-on-head model.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import time
from typing import Dict, List, Optional

from .autoscaler import AutoscalerConfig, NodeType, StandardAutoscaler
from .cluster_spec import ClusterSpec, load_cluster_spec
from .command_runner import CommandRunner
from .remote_provider import (RemoteNodeProvider, _parse_trailer,
                              make_runner)

logger = logging.getLogger("ray_tpu_torch.autoscaler.commands")


def _state_dir() -> str:
    from ..core.config import RuntimeConfig

    root = RuntimeConfig.from_env().session_dir_root
    d = os.path.join(root, "clusters")
    os.makedirs(d, exist_ok=True)
    return d


def _state_path(name: str) -> str:
    return os.path.join(_state_dir(), f"{name}.json")


def save_cluster_state(spec: ClusterSpec, state: Dict) -> None:
    with open(_state_path(spec.cluster_name), "w") as f:
        json.dump(state, f, indent=2)


def load_cluster_state(name: str) -> Optional[Dict]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _bootstrap_head(spec: ClusterSpec) -> Dict[str, str]:
    runner = make_runner(spec, spec.head_host)
    env = dict(spec.env)
    for remote, local in spec.file_mounts.items():
        runner.put(local, remote)
    for cmd in (*spec.initialization_commands, *spec.setup_commands,
                *spec.head_setup_commands,
                *spec.head_type().setup_commands):
        runner.run(cmd, env=env or None)
    out = runner.run(spec.render_start(
        spec.head_start_command,
        resources=spec.head_type().resources),
        env=env or None, timeout=600.0)
    trailer = _parse_trailer(out)
    if "RT_ADDRESS" not in trailer:
        raise RuntimeError(
            "head start command produced no RT_ADDRESS trailer:\n"
            + out[-2000:])
    # The controller may bind an ephemeral port and advertise a
    # loopback-visible IP; external workers must dial the head host.
    addr = trailer["RT_ADDRESS"]
    if spec.provider_type == "ssh":
        port = addr.rsplit(":", 1)[1]
        addr = f"{spec.head_host}:{port}"
        trailer["RT_ADDRESS"] = addr
    return trailer


def head_dir(spec: ClusterSpec) -> str:
    """Where `rt up` leaves the spec's copy and the scaling loop's log
    on the head: the session root's clusters directory when the head is
    this machine (subprocess runner), /tmp on a remote head."""
    return _state_dir() if spec.runner_type() == "subprocess" else "/tmp"


def autoscaler_log(spec: ClusterSpec) -> str:
    return os.path.join(head_dir(spec),
                        f"rt_autoscaler_{spec.cluster_name}.log")


def _start_autoscaler_on_head(spec: ClusterSpec, spec_path: str,
                              address: str) -> None:
    runner = make_runner(spec, spec.head_host)
    remote_spec = os.path.join(head_dir(spec),
                               f"rt_cluster_{spec.cluster_name}.yaml")
    runner.put(spec_path, remote_spec)
    # Ship the cluster state too: the head-side provider adopts the
    # already-launched min_workers instead of double-launching them.
    runner.put(_state_path(spec.cluster_name),
               _state_path(spec.cluster_name))
    runner.run_background(
        f"python -m ray_tpu_torch.scripts.cli autoscale "
        f"{shlex.quote(remote_spec)} --address {shlex.quote(address)}",
        env=spec.env or None,
        log_file=autoscaler_log(spec))


def up(spec_path: str, *, no_autoscaler: bool = False,
       no_workers: bool = False) -> Dict:
    """Bring the cluster up; returns the recorded state dict."""
    spec = load_cluster_spec(spec_path)
    existing = load_cluster_state(spec.cluster_name)
    if existing:
        try:
            _ping(existing["address"])
            logger.info("cluster %s already up at %s",
                        spec.cluster_name, existing["address"])
            return existing
        except Exception:
            pass  # stale state; bring up fresh

    trailer = _bootstrap_head(spec)
    address = trailer["RT_ADDRESS"]
    state = {
        "cluster_name": spec.cluster_name,
        "address": address,
        "session": trailer.get("RT_SESSION", ""),
        "head_host": spec.head_host,
        "head_pids": [int(x) for x in
                      trailer.get("RT_PIDS", "").split(",") if x],
        "spec_path": os.path.abspath(spec_path),
        "launched": {},
        "started_at": time.time(),
    }
    save_cluster_state(spec, state)

    if not no_workers:
        provider = provider_from_spec(spec, address)
        for t in spec.worker_types():
            for _ in range(t.min_workers):
                pid = provider.create_node(t.name, dict(t.resources))
                node = provider._nodes[pid]
                state["launched"][pid] = {
                    "node_type": t.name,
                    "unit": node.unit,
                    "node_ids": node.node_ids,
                    "pids_by_host": node.pids_by_host,
                }
        save_cluster_state(spec, state)

    scalable = any(t.max_workers > t.min_workers
                   for t in spec.worker_types())
    if scalable and not no_autoscaler:
        _start_autoscaler_on_head(spec, spec_path, address)
        state["autoscaler"] = "head"
        save_cluster_state(spec, state)
    return state


def _ping(address: str) -> Dict:
    import asyncio

    from ..core.rpc import RpcClient

    async def _go():
        cli = RpcClient(address, tag="rt-up")
        try:
            return await asyncio.wait_for(cli.call("ping", {}), 5.0)
        finally:
            await cli.close()

    return asyncio.new_event_loop().run_until_complete(_go())


def down(spec_path: str) -> None:
    """Tear the cluster down: graceful cluster_shutdown RPC, then kill
    recorded/launched processes on every known host."""
    spec = load_cluster_spec(spec_path)
    state = load_cluster_state(spec.cluster_name) or {}
    address = state.get("address")
    if address:
        import asyncio

        from ..core.rpc import RpcClient

        async def _go():
            cli = RpcClient(address, tag="rt-down")
            try:
                await asyncio.wait_for(
                    cli.call("cluster_shutdown", {}), 10.0)
            finally:
                await cli.close()

        try:
            asyncio.new_event_loop().run_until_complete(_go())
        except Exception:
            logger.info("graceful shutdown RPC failed; killing")

    session = state.get("session", "")
    # Kill launched worker units' recorded pids.
    for rec in (state.get("launched") or {}).values():
        for host, pids in (rec.get("pids_by_host") or {}).items():
            if not pids:
                continue
            kill = " ".join(str(p) for p in pids)
            try:
                make_runner(spec, host).run(
                    f"kill {kill} 2>/dev/null; true",
                    timeout=60.0, check=False)
            except Exception:
                pass
    # Kill the head's controller+agent, and any autoscaler-launched
    # agents we don't have pids for (match by session tag) — on the
    # head AND every worker host the spec knows, since the head-side
    # scaling loop may have launched nodes after `rt up` returned.
    head = make_runner(spec, spec.head_host)
    head_pids = " ".join(str(p) for p in state.get("head_pids", []))
    # [r]ay_tpu_torch-style bracket: the pattern must not match the
    # cleanup shell's OWN command line (a self-match SIGTERMs the shell
    # before the later pkill statements run).
    session_kill = (f"pkill -f '[r]ay_tpu_torch.*--session {session}' "
                    "2>/dev/null; " if session else "")
    cleanup = f"kill {head_pids} 2>/dev/null; " if head_pids else ""
    cleanup += session_kill
    cleanup += (f"pkill -f '[r]t_cluster_{spec.cluster_name}.yaml' "
                "2>/dev/null; true")
    try:
        head.run(cleanup, timeout=60.0, check=False)
    except Exception:
        pass
    if session_kill:
        provider = provider_from_spec(spec, address or "")
        for host in provider.all_known_hosts():
            if host == spec.head_host:
                continue
            try:
                make_runner(spec, host).run(session_kill + "true",
                                            timeout=60.0, check=False)
            except Exception:
                pass
    if spec.provider_type == "gcp":
        # Cloud capacity: terminate tracked nodes through the public
        # provider API, then sweep by cluster label — autoscaler-
        # launched nodes never reach the state file and would bill
        # forever otherwise.
        provider = provider_from_spec(spec, address or "")
        if state.get("launched"):
            provider.adopt(state["launched"])
            for pid in list(state["launched"]):
                provider.terminate_node(pid)
        leaked = provider.cleanup_cluster_capacity()
        if leaked:
            logger.info("rt down: swept %d unrecorded GPU VMs: %s",
                        len(leaked), leaked)
    try:
        os.remove(_state_path(spec.cluster_name))
    except OSError:
        pass


def exec_cluster(spec_path: str, cmd: str, *,
                 all_nodes: bool = False) -> List[str]:
    """Run a shell command on the head (or every known host)."""
    spec = load_cluster_spec(spec_path)
    hosts = [spec.head_host]
    if all_nodes:
        state = load_cluster_state(spec.cluster_name) or {}
        for rec in (state.get("launched") or {}).values():
            unit = rec.get("unit")
            hosts.extend(unit if isinstance(unit, list) else [unit])
    outs = []
    for host in hosts:
        outs.append(make_runner(spec, host).run(
            cmd, env=spec.env or None))
    return outs


def provider_from_spec(spec: ClusterSpec,
                       address: str) -> RemoteNodeProvider:
    if spec.provider_type == "gcp":
        from .gcp_provider import GCPGpuNodeProvider

        return GCPGpuNodeProvider(spec, address)
    return RemoteNodeProvider(spec, address)


def autoscaler_from_spec(spec: ClusterSpec, address: str
                         ) -> StandardAutoscaler:
    provider = provider_from_spec(spec, address)
    state = load_cluster_state(spec.cluster_name)
    if state and state.get("launched"):
        provider.adopt(state["launched"])
    cfg = AutoscalerConfig(
        node_types=[NodeType(t.name, dict(t.resources),
                             min_workers=t.min_workers,
                             max_workers=t.max_workers)
                    for t in spec.worker_types()],
        idle_timeout_s=spec.idle_timeout_s)
    return StandardAutoscaler(address, provider, cfg)


def run_autoscaler(spec_path: str, address: str) -> None:
    """Foreground scaling loop (the head-side daemon `rt up` starts)."""
    spec = load_cluster_spec(spec_path)
    scaler = autoscaler_from_spec(spec, address)
    scaler.start()
    # The first line of the log `rt up` leaves on the head.
    types = [(t.name, t.min_workers, t.max_workers)
             for t in scaler.config.node_types]
    print(f"rt autoscale: cluster {spec.cluster_name} at {address}, "
          f"adopted {scaler.provider.non_terminated_nodes()}, node types "
          f"{types}", flush=True)
    try:
        while True:
            time.sleep(5.0)
    except KeyboardInterrupt:
        pass
    finally:
        scaler.stop()
