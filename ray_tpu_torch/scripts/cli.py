"""``rt`` — the cluster operations CLI.

Role-equivalent to the reference's ``ray`` CLI (ref:
python/ray/scripts/scripts.py:654 ``ray start``): brings a head node up on
one machine, joins worker machines to it by address, and inspects/stops
the running cluster.  This is the multi-host entry point — ``rt start
--head`` on the coordinator VM, ``rt start --address=<head>:<port>`` on
every other machine, then any driver connects with
``ray_tpu_torch.init(address=...)`` (or ``address="auto"`` on a
machine that ran ``start``).

Run as ``python -m ray_tpu_torch.scripts.cli`` (alias: ``python -m
ray_tpu_torch``).  ``start --num-gpus`` overrides GPU detection.

State: each machine records the processes it started under
``<session_dir_root>/<session>/cluster.json`` and points
``<session_dir_root>/latest`` at the newest session, so ``rt stop`` /
``address="auto"`` need no arguments.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time
from typing import Dict, List, Optional

DEFAULT_PORT = 6380


# --------------------------------------------------------------- state file
def _state_path(config, session: str) -> str:
    return os.path.join(config.session_dir_root, session, "cluster.json")


def _latest_path(config) -> str:
    return os.path.join(config.session_dir_root, "latest")


def _record(config, session: str, *, address: str,
            pids: List[int], head: bool) -> None:
    path = _state_path(config, session)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    old_pids: List[int] = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            old_pids = prev.get("pids", [])
            head = head or prev.get("head", False)
        except (json.JSONDecodeError, OSError):
            pass
    # Fresh address/session always win — a stale file from a dead
    # cluster must not shadow the one just started.
    state = {"session": session, "address": address, "head": head,
             "pids": old_pids + pids}
    with open(path, "w") as f:
        json.dump(state, f)
    tmp = _latest_path(config) + ".tmp"
    with open(tmp, "w") as f:
        f.write(session)
    os.replace(tmp, _latest_path(config))


def _load_latest(config) -> Optional[Dict]:
    try:
        with open(_latest_path(config)) as f:
            session = f.read().strip()
        with open(_state_path(config, session)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def resolve_address(config=None, address: Optional[str] = None
                    ) -> Optional[str]:
    """Resolve ``auto``/None to this machine's recorded cluster address
    (the ``ray.init("auto")`` convention)."""
    if address and address != "auto":
        return address
    env = os.environ.get("RT_ADDRESS", "").strip()
    if env and env != "auto":
        return env
    if config is None:
        from ray_tpu_torch.core.config import RuntimeConfig

        config = RuntimeConfig.from_env()
    state = _load_latest(config)
    return state["address"] if state else None


# ------------------------------------------------------------------- rpc
def _call(address: str, method: str, payload=None, timeout: float = 10.0):
    from ray_tpu_torch.core.rpc import RpcClient

    async def _go():
        cli = RpcClient(address, connect_timeout=timeout)
        try:
            return await cli.call(method, payload or {})
        finally:
            await cli.close()

    return asyncio.run(_go())


# ------------------------------------------------------------- subcommands
def cmd_start(args) -> int:
    from ray_tpu_torch.core import node_launcher
    from ray_tpu_torch.core.config import RuntimeConfig

    if args.node_ip:
        os.environ["RT_NODE_IP"] = args.node_ip
    config = RuntimeConfig.from_env()
    resources = json.loads(args.resources) if args.resources else None

    if args.head and args.address:
        print("error: pass --head OR --address, not both", file=sys.stderr)
        return 2
    pids: List[int] = []
    if args.head:
        session = args.session or (f"session_{int(time.time())}_"
                                   f"{os.getpid()}_{os.urandom(3).hex()}")
        proc, ctl_addr = node_launcher.start_controller(
            config, session, port=args.port)
        pids.append(proc.pid)
    else:
        if not args.address:
            print("error: need --head or --address=<head_host:port>",
                  file=sys.stderr)
            return 2
        ctl_addr = args.address
        pong = _call(ctl_addr, "ping")
        session = pong["session"]

    agent_proc, agent_addr, node_id = node_launcher.start_node_agent(
        config, session, ctl_addr,
        num_cpus=args.num_cpus, num_gpus=args.num_gpus,
        custom_resources=resources, is_head=args.head,
        tag="head" if args.head else f"join-{os.getpid()}")
    pids.append(agent_proc.pid)

    client_addr = None
    if args.head and args.client_server_port >= 0:
        # rt:// remote-driver listener (ref: Ray Client's default port
        # 10001 on the head; util/client/server/proxier.py).
        import subprocess as _sp

        cs_proc = _sp.Popen(
            [sys.executable, "-u", "-m", "ray_tpu_torch.client.server",
             "--address", ctl_addr,
             "--port", str(args.client_server_port)],
            stdout=_sp.PIPE, stderr=_sp.DEVNULL)
        # A hung child that never prints the port line must not hang
        # `rt start`: poll the pipe fd so the 30s deadline applies even
        # mid-line, then fall through to the warning path.
        import selectors as _selectors

        sel = _selectors.DefaultSelector()
        sel.register(cs_proc.stdout, _selectors.EVENT_READ)
        deadline = time.time() + 30
        buf = ""
        eof = False
        while time.time() < deadline:
            if not sel.select(timeout=max(0.0, deadline - time.time())):
                break  # deadline expired with no output
            chunk = os.read(cs_proc.stdout.fileno(), 4096).decode(
                "utf-8", "replace")
            if not chunk:
                eof = True  # child closed stdout
                break
            buf += chunk
            # Parse only newline-terminated lines; a read can race the
            # child's write mid-line, and a partial "...PORT=10" must
            # not become the advertised port.
            *lines, buf = buf.split("\n")
            for line in lines:
                if line.startswith("RT_CLIENT_SERVER_PORT="):
                    host = ctl_addr.rsplit(":", 1)[0]
                    client_addr = (
                        f"rt://{host}:{line.split('=')[1].strip()}")
                    break
            if client_addr is not None:
                break
        if client_addr is None and eof and \
                buf.startswith("RT_CLIENT_SERVER_PORT="):
            # Child closed stdout right after an unterminated port line
            # — still a valid announcement.  ONLY on EOF: on deadline
            # expiry the child may be mid-write and the buffer could
            # hold a truncated port.
            host = ctl_addr.rsplit(":", 1)[0]
            client_addr = f"rt://{host}:{buf.split('=')[1].strip()}"
        sel.close()
        if client_addr is None:
            print("warning: rt:// client server failed to start",
                  file=sys.stderr)
            cs_proc.terminate()
        else:
            pids.append(cs_proc.pid)

    _record(config, session, address=ctl_addr, pids=pids, head=args.head)

    if args.head:
        print(f"Started head node.\n"
              f"  controller: {ctl_addr}\n"
              f"  node agent: {agent_addr} ({node_id[:12]})\n\n"
              f"Join other machines with:\n"
              f"  python -m ray_tpu_torch.scripts.cli start "
              f"--address={ctl_addr}\n\n"
              f"Connect a driver with:\n"
              f"  ray_tpu_torch.init(address=\"{ctl_addr}\")  "
              f"# or address=\"auto\" on this machine"
              + (f"\n\nConnect a REMOTE driver (laptop) with:\n"
                 f"  ray_tpu_torch.init(address=\"{client_addr}\")"
                 if client_addr else ""))
    else:
        print(f"Joined cluster at {ctl_addr}.\n"
              f"  node agent: {agent_addr} ({node_id[:12]})")
    # Machine-readable trailer: the cluster launcher (`rt up`, the SSH
    # node provider) parses these from the remote command's output.
    print(f"RT_ADDRESS={ctl_addr}")
    print(f"RT_SESSION={session}")
    print(f"RT_NODE_ID={node_id}")
    print(f"RT_PIDS={','.join(str(p) for p in pids)}")
    if args.block:
        try:
            while agent_proc.poll() is None:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        return agent_proc.returncode or 0
    return 0


def cmd_status(args) -> int:
    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found (no --address and no local "
              "session state).", file=sys.stderr)
        return 1
    pong = _call(address, "ping")
    nodes = _call(address, "list_nodes")
    print(f"Cluster {pong['session']} @ {address}")
    alive = [n for n in nodes if n["alive"]]
    print(f"Nodes: {len(alive)} alive / {len(nodes)} total")
    for n in nodes:
        state = "ALIVE" if n["alive"] else "DEAD "
        if n["alive"] and n.get("draining"):
            state = "DRAIN"
        head = " (head)" if n.get("is_head") else ""
        res = ", ".join(f"{k}={v:g}" for k, v in
                        sorted(n.get("resources", {}).items()))
        avail = ", ".join(f"{k}={v:g}" for k, v in
                          sorted(n.get("available", {}).items()))
        nid = n["node_id"]
        nid = nid.hex() if hasattr(nid, "hex") else str(nid)
        print(f"  {state} {nid[:12]} @ {n['agent_addr']}{head}")
        print(f"         total: {res or '-'}")
        print(f"         avail: {avail or '-'}")
        pool = n.get("worker_pool") or {}
        if pool.get("target"):
            print(f"         pool:  {pool.get('idle', 0)}/"
                  f"{pool['target']} warm worker(s) idle  "
                  f"(adopted {pool.get('adoptions', 0)}, "
                  f"cold spawns {pool.get('cold_spawns', 0)})")
    return 0


def cmd_stop(args) -> int:
    from ray_tpu_torch.core.config import RuntimeConfig

    config = RuntimeConfig.from_env()
    state = _load_latest(config)
    if state is None:
        print("No local cluster state.", file=sys.stderr)
        return 1
    if state.get("head") and not args.local_only:
        try:
            _call(state["address"], "cluster_shutdown", timeout=5.0)
        except Exception:
            pass  # controller may already be gone; fall through to kill
    deadline = time.time() + 10.0
    for pid in state.get("pids", []):
        try:
            os.kill(pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            continue
    killed = 0
    for pid in state.get("pids", []):
        while time.time() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            try:
                os.kill(pid, signal.SIGKILL)
                killed += 1
            except (ProcessLookupError, PermissionError):
                pass
    try:
        os.remove(_state_path(config, state["session"]))
        os.remove(_latest_path(config))
    except OSError:
        pass
    print(f"Stopped {len(state.get('pids', []))} local process(es)"
          + (f" ({killed} force-killed)" if killed else "") + ".")
    return 0


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state as state_api

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    entity = args.entity
    fns = {
        "tasks": lambda: state_api.list_tasks(
            state=args.state or None, limit=args.limit, address=address),
        "actors": lambda: state_api.list_actors(address=address),
        "nodes": lambda: state_api.list_nodes(address=address),
        "objects": lambda: state_api.list_objects(
            limit=args.limit, address=address),
        "jobs": lambda: state_api.list_jobs(address=address),
        "placement-groups": lambda: state_api.list_placement_groups(
            address=address),
        "leases": lambda: state_api.list_leases(address=address),
    }
    rows = fns[entity]()
    if entity == "leases" and args.format != "json":
        # Ledger -> one row per lease + a demand/pending summary line
        # per node (the agent's view: owner, depth, idle age).
        flat = []
        for ledger in rows:
            nid = str(ledger.get("node_id", "?"))[:12]
            if ledger.get("error"):
                print(f"{nid}: {ledger['error']}", file=sys.stderr)
                continue
            for lease in ledger.get("leases", []):
                flat.append({"node": nid, **{
                    k: v for k, v in lease.items()
                    if not isinstance(v, (dict, list))}})
            n_pend = len(ledger.get("pending", []))
            n_dem = len(ledger.get("demand", []))
            if n_pend or n_dem:
                print(f"{nid}: {n_pend} queued lease request(s), "
                      f"demand vector {n_dem} entry(ies)")
        rows = flat
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=repr))
        return 0
    if not rows:
        print(f"(no {entity})")
        return 0
    cols = sorted({k for r in rows for k in r
                   if not isinstance(r[k], (dict, list))})
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))
    return 0


def cmd_timeline(args) -> int:
    """Chrome-trace export.  Default: driver-local task events only;
    ``--cluster``: the unified cluster timeline (task events + the
    cross-process span plane + MFU/goodput/serve counter tracks +
    flow arrows); ``--summary``: per-step critical path text instead
    of a file.  Load exports at https://ui.perfetto.dev or
    chrome://tracing."""
    from ray_tpu_torch.util import state as state_api

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    if args.summary:
        from ray_tpu_torch.util.timeline import render_summary

        sys.stdout.write(render_summary(
            state_api.timeline_summary(address=address)))
        return 0
    if args.cluster:
        trace = state_api.cluster_timeline(args.out, address=address)
    else:
        trace = state_api.timeline(args.out, address=address)
    print(f"Wrote {len(trace)} trace events to {args.out}")
    return 0


def cmd_profile(args) -> int:
    """On-demand profiler capture on live workers.  ``--torch`` runs a
    torch.profiler capture on every worker that has torch loaded and
    prints each Chrome trace with its device kernel count (the paths
    are also recorded in the controller telemetry feed)."""
    from ray_tpu_torch.util import state as state_api

    if not args.torch:
        print("error: pass --torch (sampling profiles are served via "
              "/api/profile on the dashboard)", file=sys.stderr)
        return 2
    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    # Workers clamp the capture to 120s; clamp here too so the
    # reported window matches what was actually captured.
    if args.duration > 120.0:
        print("note: capture window clamped to 120s", file=sys.stderr)
        args.duration = 120.0
    results = state_api.torch_profile(
        duration_s=args.duration, node_id=args.node or None,
        force=args.force, address=address)
    if not results:
        print("(no live workers found)")
        return 1
    captured = 0
    for r in results:
        nid = str(r.get("node_id", "?"))[:12]
        if r.get("ok"):
            captured += 1
            n_kernels = sum((r.get("kernels") or {}).values())
            print(f"  {nid} pid={r['pid']:<8} {r['path']} "
                  f"({n_kernels} device kernel(s))")
        else:
            print(f"  {nid} pid={r['pid']:<8} skipped: "
                  f"{r.get('error')}")
    print(f"{captured}/{len(results)} worker(s) captured "
          f"({args.duration:.1f}s window)")
    return 0 if captured else 1


def cmd_trace(args) -> int:
    """Request-scoped tracing: with an id (prefix ok), print one
    request's cross-process hop chain — proxy ingress, admission
    wait, each failover attempt (replica + breaker state), replica
    execution, and the engine's waiting/prefill/decode phases — with
    the TTFT breakdown and dominant phase.  Without an id, list the
    slowest-request exemplars in the current window."""
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util.reqtrace import render_trace

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    if not args.request_id:
        r = state_api.request_exemplars(address=address)
        rows = r.get("exemplars") or []
        if args.format == "json":
            print(json.dumps(r, indent=2, default=repr))
            return 0
        if not rows:
            print("(no request exemplars in the window — serve "
                  "traffic records ingress spans automatically)")
            return 0
        print(f"slowest requests (last {r.get('window_s', 0):.0f}s "
              f"window, slowest first):")
        for rec in rows:
            print(f"  {rec['request_id']:<18} "
                  f"{rec['duration_s'] * 1e3:9.1f}ms  "
                  f"{rec.get('deployment', '?'):<16} "
                  f"{rec.get('status_class', '?')}")
        print("\ninspect one with: rt trace <request_id>")
        return 0
    trace = state_api.request_trace(args.request_id, address=address)
    if args.format == "json":
        print(json.dumps(trace, indent=2, default=repr))
        return 0 if trace.get("found") else 1
    if trace.get("ambiguous"):
        print(f"request id prefix {args.request_id!r} is ambiguous: "
              f"{', '.join(trace['ambiguous'])}", file=sys.stderr)
        return 1
    sys.stdout.write(render_trace(trace))
    return 0 if trace.get("found") else 1


def cmd_slo(args) -> int:
    """SLO / error-budget plane: every declared objective (plus the
    default availability objective for deployments with traffic)
    evaluated from metrics history with multi-window burn rates —
    the `rt doctor` SLO findings' data, rendered as a report."""
    from ray_tpu_torch.util import slo as slo_mod

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    rep = slo_mod.report(address=address)
    if args.format == "json":
        print(json.dumps(rep, indent=2, default=repr))
    else:
        sys.stdout.write(slo_mod.render_text(rep))
    worst = rep.get("worst")
    return 1 if worst in ("exhausted", "fast_burn") else 0


def cmd_doctor(args) -> int:
    """Aggregated cluster health diagnosis: dead-owner leases,
    never-idle nodes, infeasible placement groups, hung collectives
    (naming the op and missing ranks), stuck tasks, stragglers,
    autoscaler decision gaps, recent flight dumps — each finding with
    an explanation and the suggested next probe."""
    from ray_tpu_torch.util import doctor as doctor_mod

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    diag = doctor_mod.cluster_diagnosis(
        address=address, run_dir=getattr(args, "run_dir", "") or None)
    if args.format == "json":
        print(json.dumps(diag, indent=2, default=repr))
    else:
        sys.stdout.write(doctor_mod.render_text(diag))
    critical = any(f.get("severity") == "critical"
                   for f in diag.get("findings", []))
    return 1 if critical else 0


def cmd_perf(args) -> int:
    """Performance introspection plane: roofline position
    (achieved vs attainable FLOP/s at the program's arithmetic
    intensity), step decomposition, per-mesh-axis collective
    byte/time shares, compile events, and device-memory watermarks —
    assembled from the rt_xla_* gauges that harvested train steps and
    engine programs publish (util/xprof.py).  Peaks are those of the
    GPU NVML names: the CLI loads no torch."""
    from ray_tpu_torch.core.resources import nvml_device_name
    from ray_tpu_torch.util import xprof as xprof_mod

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    rep = xprof_mod.cluster_report(address=address,
                                   device_name=nvml_device_name())
    if args.format == "json" or getattr(args, "json", False):
        print(json.dumps(rep, indent=2, default=repr))
    else:
        sys.stdout.write(xprof_mod.render_report(rep))
    return 0


def cmd_hotpath(args) -> int:
    """Control-plane hot-path decomposition: where the mean sampled
    task's end-to-end latency goes, phase by phase (submit wakeup,
    lease wait, send transit, worker queue, exec, reply flush/transit,
    finalize), with per-phase p50/p99 across the cluster's sampled
    records.  `--diff a.json b.json` compares two saved snapshots
    offline (no cluster needed)."""
    from ray_tpu_torch.util import hotpath as hotpath_mod

    if getattr(args, "diff", None):
        path_a, path_b = args.diff
        try:
            with open(path_a) as f:
                snap_a = json.load(f)
            with open(path_b) as f:
                snap_b = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot: {e}", file=sys.stderr)
            return 1
        d = hotpath_mod.diff_snapshots(snap_a, snap_b)
        if args.format == "json" or getattr(args, "json", False):
            print(json.dumps(d, indent=2))
        else:
            sys.stdout.write(hotpath_mod.render_diff(d))
        return 0

    from ray_tpu_torch.util import state as state_mod

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    snap = state_mod.hotpath(address=address)
    if args.format == "json" or getattr(args, "json", False):
        print(json.dumps(snap, indent=2, default=repr))
    else:
        sys.stdout.write(hotpath_mod.render_text(snap))
    return 0


def cmd_checkpoint_verify(args) -> int:
    """Offline integrity check of one checkpoint directory: commit
    status, manifest sanity, per-shard-file checksums, and slice
    coverage of every leaf — the operator's answer to "can this run
    actually resume from here?".  Exits non-zero on a torn or corrupt
    directory (no cluster needed)."""
    from ray_tpu_torch.util.checkpoint_fs import verify_checkpoint

    report = verify_checkpoint(args.dir)
    if args.format == "json":
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    status = "OK (committed)" if report["ok"] else (
        "CORRUPT" if report["committed"] else "NOT COMMITTED (torn)")
    if report.get("aside"):
        status += (" — aside copy from an interrupted re-save swap; "
                   "if its final name is missing, `mv` it back to "
                   "recover" if report["ok"] else "")
    print(f"{report['path']}: {status}")
    if report.get("sharded"):
        mesh = report.get("mesh") or {}
        mesh_s = "x".join(f"{k}={v}" for k, v in mesh.items()) or "?"
        print(f"  sharded: world={report.get('world_size')} "
              f"mesh[{mesh_s}]  {report['leaves']} leaves in "
              f"{report['files']} shard file(s), "
              f"{report['bytes']} bytes")
    for err in report["errors"]:
        print(f"  error: {err}")
    if not report["ok"]:
        print("  resume will skip this directory and fall back to "
              "the previous committed checkpoint.")
    return 0 if report["ok"] else 1


def cmd_checkpoint_list(args) -> int:
    """List every checkpoint_* entry of a run directory with its
    commit status — committed, torn, or in-flight staging."""
    from ray_tpu_torch.util.checkpoint_fs import scan_run_dir

    entries = scan_run_dir(args.run_dir)
    if args.format == "json":
        print(json.dumps(entries, indent=2))
        return 0
    if not entries:
        print(f"no checkpoint_* entries in {args.run_dir}")
        return 0
    for e in entries:
        if e.get("old"):
            # Aside copy from a re-save swap; "RECOVERABLE" means its
            # content is committed and can be renamed back if the
            # final name never re-appeared (rt doctor flags that).
            state = ("aside (RECOVERABLE)" if e.get("recoverable")
                     else "aside")
        else:
            state = ("staging" if e["tmp"]
                     else "committed" if e["committed"] else "TORN")
        print(f"  {e['name']:<28} {state}")
    return 0


def cmd_drain(args) -> int:
    """Gracefully drain a node (the operator's preemption notice): the
    agent stops accepting leases, queued work is redirected to live
    peers, training gangs on the node see ``train.interrupted()`` and
    checkpoint-on-notice, and the autoscaler starts a replacement —
    all before the node actually goes away."""
    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    payload = {"node_id": args.node, "reason": args.reason,
               "if_idle": args.if_idle}
    if args.grace > 0:
        payload["grace_s"] = args.grace
    r = _call(address, "drain_node", payload)
    if not r.get("ok"):
        if r.get("busy"):
            print(f"not drained: node is busy "
                  f"({r.get('leases', '?')} active lease(s)); "
                  f"drop --if-idle to drain anyway", file=sys.stderr)
        else:
            print(f"error: {r.get('error', 'drain failed')}",
                  file=sys.stderr)
        return 1
    import datetime

    deadline = r.get("deadline") or 0.0
    when = datetime.datetime.fromtimestamp(deadline).strftime(
        "%H:%M:%S") if deadline else "?"
    print(f"node {r.get('node_id', args.node)[:12]} is DRAINING "
          f"(deadline {when}, {max(deadline - time.time(), 0):.0f}s "
          f"of grace)")
    print("watch it with: rt doctor; rt status")
    return 0


def cmd_explain(args) -> int:
    """Scheduler explainability for one task: the full transition
    chain (queued -> lease_requested -> pipelined/granted -> running
    -> finished/requeued) with reason tags — why the task landed
    where it did."""
    from ray_tpu_torch.util import state as state_api

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    r = state_api.explain_task(args.task_id, address=address)
    if not r.get("ok"):
        print(f"error: {r.get('error')}", file=sys.stderr)
        return 1
    rec = r["task"]
    if args.format == "json":
        print(json.dumps(rec, indent=2, default=repr))
        return 0
    print(f"task {rec.get('task_id')}  {rec.get('name', '?')} "
          f"[{rec.get('state', '?')}]")
    meta = []
    if rec.get("node_id"):
        meta.append(f"node={str(rec['node_id'])[:12]}")
    if rec.get("worker_pid"):
        meta.append(f"worker_pid={rec['worker_pid']}")
    if rec.get("error"):
        meta.append(f"error={rec['error']}")
    if meta:
        print("  " + "  ".join(meta))
    # Stored (arrival) order, NOT sorted by timestamp: owner-side
    # scheduling events and worker-side execution events carry
    # different host clocks, and each plane flushes internally
    # ordered — a raw-ts sort would let a skewed worker clock print
    # RUNNING before PIPELINED.
    chain = list(rec.get("transitions") or [])
    if not chain:
        print("  (no transitions recorded)")
        return 0
    t0 = chain[0][0]
    for ts, state, detail in chain:
        extras = "  ".join(f"{k}={v}" for k, v in
                           sorted((detail or {}).items()))
        print(f"  +{ts - t0:8.3f}s  {state:<16} {extras}")
    return 0


def cmd_metrics(args) -> int:
    from ray_tpu_torch.util import state as state_api

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    sys.stdout.write(state_api.metrics_text(address=address))
    return 0


def cmd_telemetry(args) -> int:
    """Training telemetry plane: cluster goodput summary, per-step
    train series, collective latency/bandwidth, serve ingress, and
    flight-recorder dumps from dead workers."""
    from ray_tpu_torch.util import telemetry as telemetry_mod

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    summary = telemetry_mod.cluster_summary(address=address)
    if args.format == "json":
        print(json.dumps(summary, indent=2, default=repr))
        return 0
    sys.stdout.write(telemetry_mod.render_text(summary))
    return 0


def cmd_jobs(args) -> int:
    """The multi-tenant job plane: every submitted job with priority,
    quota, live resource usage, state, and submission time — the "who
    is paying for this cluster" view (prefix-match job ids like
    `rt explain` does)."""
    from ray_tpu_torch.util import state as state_api

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    rows = state_api.jobs_overview(args.job_id or None, address=address)
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=repr))
        return 0
    if not rows:
        print("(no submitted jobs)" + (f" matching {args.job_id!r}"
                                       if args.job_id else ""))
        return 0

    def _res(d):
        return ",".join(f"{k}={v:g}" for k, v in sorted(d.items())) \
            if d else "-"

    now = time.time()
    table = []
    for r in rows:
        age = now - r["submitted"] if r.get("submitted") else 0.0
        state = r.get("state", "?")
        if r.get("preempting"):
            state += "(PREEMPTING)"
        table.append({
            "job_id": r["job_id"], "pri": r.get("priority", 0),
            "state": state, "quota": _res(r.get("quota")),
            "usage": _res(r.get("usage")),
            "submitted": f"{age:.0f}s ago",
            "entrypoint": (r.get("entrypoint") or "")[:48]})
    cols = ["job_id", "pri", "state", "quota", "usage", "submitted",
            "entrypoint"]
    widths = {c: max(len(c), *(len(str(t[c])) for t in table))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for t in table:
        print("  ".join(str(t[c]).ljust(widths[c]) for c in cols))
    return 0


def _job_client(address: str):
    import ray_tpu_torch
    from ray_tpu_torch.job import JobSubmissionClient

    addr = resolve_address(address=address)
    if not addr:
        print("No running cluster found.", file=sys.stderr)
        raise SystemExit(1)
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(address=addr)
    return JobSubmissionClient(addr)


def cmd_job(args) -> int:
    try:
        return _cmd_job_inner(args)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 1
    except (ValueError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _cmd_job_inner(args) -> int:
    client = _job_client(args.address)
    if args.job_command == "submit":
        renv = {}
        if args.working_dir:
            renv["working_dir"] = args.working_dir
        if args.env:
            bad = [kv for kv in args.env if "=" not in kv]
            if bad:
                print(f"error: --env needs K=V form, got {bad}",
                      file=sys.stderr)
                return 2
            renv["env_vars"] = dict(kv.split("=", 1) for kv in args.env)
        ep = args.entrypoint
        if ep[:1] == ["--"]:
            ep = ep[1:]
        if not ep:
            print("error: no entrypoint given", file=sys.stderr)
            return 2
        quota = None
        if args.quota:
            try:
                quota = json.loads(args.quota)
            except json.JSONDecodeError as e:
                print(f"error: --quota must be JSON "
                      f"(e.g. '{{\"CPU\": 4}}'): {e}", file=sys.stderr)
                return 2
        job_id = client.submit_job(
            entrypoint=" ".join(ep),
            submission_id=args.id or None,
            runtime_env=renv or None,
            priority=args.priority,
            quota=quota)
        print(f"Submitted {job_id}")
        if args.wait:
            st = client.wait_until_finished(job_id,
                                            timeout=args.timeout)
            sys.stdout.write(client.get_job_logs(job_id))
            print(f"Job {job_id}: {st.status} {st.message}")
            return 0 if st.status == "SUCCEEDED" else 1
        return 0
    if args.job_command == "status":
        st = client.get_job_status(args.id)
        print(f"{st.job_id}: {st.status}"
              + (f" ({st.message})" if st.message else ""))
        return 0 if st.status != "FAILED" else 1
    if args.job_command == "logs":
        sys.stdout.write(client.get_job_logs(args.id))
        return 0
    if args.job_command == "stop":
        ok = client.stop_job(args.id)
        print("stopped" if ok else "not running")
        return 0
    if args.job_command == "list":
        for st in client.list_jobs():
            print(f"{st.job_id}  {st.status:<10} {st.entrypoint}")
        return 0
    return 2


def cmd_logs(args) -> int:
    """Fetch worker/actor logs from node agents (ref:
    dashboard/modules/log/ + `ray logs`); works for dead workers (the
    log file outlives the process)."""
    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    if args.job:
        args.id = args.job
        args.job_command = "logs"
        return _cmd_job_inner(args)
    nodes = [n for n in _call(address, "list_nodes") if n["alive"]]

    def _nid_hex(n):
        nid = n["node_id"]
        return nid.hex() if hasattr(nid, "hex") else str(nid)

    if args.node:
        nodes = [n for n in nodes
                 if _nid_hex(n).startswith(args.node)]
    worker_sel = args.worker
    pid_sel = args.pid
    if args.actor:
        actors = _call(address, "list_actors")
        match = None
        for a in actors:
            aid = a["actor_id"]
            aid = aid.hex() if hasattr(aid, "hex") else str(aid)
            if a.get("name") == args.actor or aid.startswith(args.actor):
                match = a
                break
        if match is None:
            print(f"no actor matching {args.actor!r}", file=sys.stderr)
            return 1
        nid = match["node_id"]
        nid = nid.hex() if hasattr(nid, "hex") else str(nid)
        nodes = [n for n in nodes if _nid_hex(n) == nid]
        # The agent resolves the worker by actor's worker address pid —
        # list workers on that node and find the actor.
        for n in nodes:
            r = _call(n["agent_addr"], "list_workers")
            aid_hex = (match["actor_id"].hex()
                       if hasattr(match["actor_id"], "hex")
                       else str(match["actor_id"]))
            for w in r["workers"]:
                if w.get("actor_id") == aid_hex:
                    worker_sel = w["worker_id"]
    if not worker_sel and pid_sel is None:
        # Listing mode: show available logs.
        for n in nodes:
            r = _call(n["agent_addr"], "list_worker_logs")
            for rec in r["logs"]:
                print(f"{_nid_hex(n)[:12]} pid={rec['pid']:<8} "
                      f"{rec['state']:<8} "
                      f"worker={str(rec['worker_id'])[:12]} "
                      f"{rec['size']}B")
        return 0
    for n in nodes:
        req = {"max_bytes": args.tail * 200}
        if worker_sel:
            req["worker_id"] = worker_sel
        if pid_sel is not None:
            req["pid"] = pid_sel
        r = _call(n["agent_addr"], "read_worker_log", req)
        if r.get("ok"):
            lines = r["text"].splitlines()
            for line in lines[-args.tail:]:
                print(line)
            return 0
    print("worker not found on any node", file=sys.stderr)
    return 1


def cmd_up(args) -> int:
    from ray_tpu_torch.autoscaler import commands as _commands

    state = _commands.up(args.spec, no_autoscaler=args.no_autoscaler,
                         no_workers=args.no_workers)
    print(f"Cluster {state['cluster_name']} is up.\n"
          f"  address: {state['address']}\n"
          f"  session: {state['session']}\n"
          f"  workers launched: {len(state.get('launched', {}))}"
          + ("\n  autoscaler: running on head"
             if state.get("autoscaler") else ""))
    print(f"RT_ADDRESS={state['address']}")
    return 0


def cmd_down(args) -> int:
    from ray_tpu_torch.autoscaler import commands as _commands

    _commands.down(args.spec)
    print("Cluster torn down.")
    return 0


def cmd_exec(args) -> int:
    from ray_tpu_torch.autoscaler import commands as _commands

    for out in _commands.exec_cluster(args.spec, args.cmd,
                                      all_nodes=args.all_nodes):
        print(out, end="" if out.endswith("\n") else "\n")
    return 0


def cmd_autoscale(args) -> int:
    from ray_tpu_torch.autoscaler import commands as _commands

    _commands.run_autoscaler(args.spec, args.address)
    return 0


def cmd_dashboard(args) -> int:
    from ray_tpu_torch.dashboard import run_dashboard

    address = resolve_address(address=args.address)
    if not address:
        print("No running cluster found.", file=sys.stderr)
        return 1
    print(f"dashboard for {address} on http://0.0.0.0:{args.port}")
    run_dashboard(address, args.port)
    return 0


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rt", description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start a head node or join a cluster")
    sp.add_argument("--head", action="store_true",
                    help="start the controller + head agent here")
    sp.add_argument("--address", default="",
                    help="controller address to join (host:port)")
    sp.add_argument("--port", type=int, default=DEFAULT_PORT,
                    help=f"controller port for --head "
                         f"(default {DEFAULT_PORT}, 0 = ephemeral)")
    sp.add_argument("--node-ip", default="",
                    help="address this node advertises (default: auto)")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--resources", default="",
                    help='custom resources JSON, e.g. \'{"slice": 1}\'')
    sp.add_argument("--session", default="",
                    help="session name override (head only)")
    sp.add_argument("--block", action="store_true",
                    help="stay in the foreground until the agent exits")
    sp.add_argument("--client-server-port", type=int, default=-1,
                    help="start an rt:// remote-driver listener on this"
                         " port (0 = ephemeral; default: disabled; the"
                         " reference's convention is 10001)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("status", help="show cluster nodes and resources")
    sp.add_argument("--address", default="",
                    help="controller address (default: local state)")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("stop", help="stop locally-started processes")
    sp.add_argument("--local-only", action="store_true",
                    help="kill local processes without cluster shutdown")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("list", help="state API listings")
    sp.add_argument("entity", choices=["tasks", "actors", "nodes",
                                       "objects", "jobs",
                                       "placement-groups", "leases"])
    sp.add_argument("--address", default="")
    sp.add_argument("--state", default="",
                    help="tasks only: RUNNING|FINISHED|FAILED")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--format", choices=["table", "json"],
                    default="table")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("timeline",
                        help="export a Chrome-trace/Perfetto timeline")
    sp.add_argument("--out", default="timeline.json")
    sp.add_argument("--cluster", action="store_true",
                    help="merged cluster timeline: task events + "
                         "cross-process spans + counter tracks + "
                         "flow arrows")
    sp.add_argument("--summary", action="store_true",
                    help="print the per-step critical path (slowest "
                         "rank + dominant wait) instead of a file")
    sp.add_argument("--address", default="")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("profile",
                        help="on-demand profiler capture on workers")
    sp.add_argument("--torch", action="store_true",
                    help="torch.profiler capture on workers with torch "
                         "loaded (Chrome traces)")
    sp.add_argument("--duration", type=float, default=3.0,
                    help="capture window seconds (default 3)")
    sp.add_argument("--node", default="", help="node id prefix filter")
    sp.add_argument("--force", action="store_true",
                    help="import torch into workers that have not "
                         "loaded it yet")
    sp.add_argument("--address", default="")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("trace",
                        help="follow one request ingress->decode "
                             "(no id: list slowest exemplars)")
    sp.add_argument("request_id", nargs="?", default="",
                    help="request id (prefix ok; from the "
                         "X-RT-Request-Id response header)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("slo",
                        help="SLO / error-budget report (burn rates, "
                             "budget consumed, p99 vs target)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.set_defaults(fn=cmd_slo)

    sp = sub.add_parser("perf",
                        help="perf introspection (roofline, step "
                             "decomposition, per-axis collective "
                             "shares, compiles, device memory)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.add_argument("--json", action="store_true",
                    help="shorthand for --format json (scripted "
                         "consumption in bench/CI)")
    sp.set_defaults(fn=cmd_perf)

    sp = sub.add_parser("hotpath",
                        help="control-plane hot-path phase "
                             "decomposition (where sampled task "
                             "latency goes: lease wait, transit, "
                             "worker queue, exec, reply)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.add_argument("--json", action="store_true",
                    help="shorthand for --format json (save a "
                         "snapshot for later --diff)")
    sp.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two saved --json snapshots: "
                         "per-phase mean deltas A -> B")
    sp.set_defaults(fn=cmd_hotpath)

    sp = sub.add_parser("doctor",
                        help="aggregated cluster health diagnosis "
                             "(hung collectives, dead-owner leases, "
                             "stuck tasks, stragglers, ...)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.add_argument("--run-dir", default="",
                    help="also scan this training run directory for "
                         "torn/uncommitted checkpoint dirs")
    sp.set_defaults(fn=cmd_doctor)

    sp = sub.add_parser("checkpoint",
                        help="inspect/verify checkpoint directories "
                             "(sharded manifest + checksums)")
    csub = sp.add_subparsers(dest="ckpt_command", required=True)
    c = csub.add_parser("verify",
                        help="validate a checkpoint dir: commit "
                             "status, manifest, per-file checksums, "
                             "slice coverage")
    c.add_argument("dir", help="checkpoint directory")
    c.add_argument("--format", choices=["text", "json"],
                   default="text")
    c.set_defaults(fn=cmd_checkpoint_verify)
    c = csub.add_parser("list",
                        help="list checkpoint_* entries in a run dir "
                             "with commit status")
    c.add_argument("run_dir", help="training run directory")
    c.add_argument("--format", choices=["text", "json"],
                   default="text")
    c.set_defaults(fn=cmd_checkpoint_list)

    sp = sub.add_parser("drain",
                        help="gracefully drain a node (stop leases, "
                             "checkpoint-on-notice, start a "
                             "replacement) before it goes away")
    sp.add_argument("node", help="node id (hex prefix ok)")
    sp.add_argument("--reason", default="operator drain")
    sp.add_argument("--grace", type=float, default=0.0,
                    help="drain deadline seconds from now (default: "
                         "RT_PREEMPTION_GRACE_S)")
    sp.add_argument("--if-idle", action="store_true",
                    help="refuse if the node holds leases or queued "
                         "work (the autoscaler's mode)")
    sp.add_argument("--address", default="")
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser("explain",
                        help="scheduling transition chain of one "
                             "task (why it landed where it did)")
    sp.add_argument("task_id", help="task id (prefix ok)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.set_defaults(fn=cmd_explain)

    sp = sub.add_parser("metrics",
                        help="print Prometheus metrics exposition")
    sp.add_argument("--address", default="")
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("telemetry",
                        help="training telemetry: goodput, MFU, "
                             "collectives, flight recorder")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["text", "json"],
                    default="text")
    sp.set_defaults(fn=cmd_telemetry)

    sp = sub.add_parser("dashboard", help="serve the web dashboard")
    sp.add_argument("--address", default="")
    sp.add_argument("--port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("jobs",
                        help="multi-tenant job plane: priority, quota, "
                             "usage, state per submitted job")
    sp.add_argument("job_id", nargs="?", default="",
                    help="job id prefix filter (optional)")
    sp.add_argument("--address", default="")
    sp.add_argument("--format", choices=["table", "json"],
                    default="table")
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("logs",
                        help="fetch worker/actor logs from node agents")
    sp.add_argument("--worker", default="",
                    help="worker id hex (prefix ok)")
    sp.add_argument("--pid", type=int, default=None)
    sp.add_argument("--actor", default="",
                    help="actor name or id prefix")
    sp.add_argument("--job", default="", help="job id (job logs)")
    sp.add_argument("--node", default="", help="node id prefix filter")
    sp.add_argument("--tail", type=int, default=200,
                    help="lines from the end (default 200)")
    sp.add_argument("--address", default="")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("up", help="launch a cluster from a YAML spec")
    sp.add_argument("spec", help="cluster YAML (see autoscaler/"
                                 "cluster_spec.py for the schema)")
    sp.add_argument("--no-autoscaler", action="store_true",
                    help="don't start the scaling loop on the head")
    sp.add_argument("--no-workers", action="store_true",
                    help="head only; skip min_workers bring-up")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down an `rt up` cluster")
    sp.add_argument("spec")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("exec",
                        help="run a shell command on cluster hosts")
    sp.add_argument("spec")
    sp.add_argument("cmd", help="shell command to run")
    sp.add_argument("--all-nodes", action="store_true",
                    help="run on every known host, not just the head")
    sp.set_defaults(fn=cmd_exec)

    sp = sub.add_parser("autoscale",
                        help="run the scaling loop for a YAML cluster "
                             "(normally started on the head by rt up)")
    sp.add_argument("spec")
    sp.add_argument("--address", required=True,
                    help="controller address")
    sp.set_defaults(fn=cmd_autoscale)

    sp = sub.add_parser("job", help="submit and manage cluster jobs")
    jsub = sp.add_subparsers(dest="job_command", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="shell command (prefix with -- )")
    j.add_argument("--id", default="")
    j.add_argument("--address", default="")
    j.add_argument("--working-dir", default="")
    j.add_argument("--env", action="append", default=[],
                   metavar="K=V")
    j.add_argument("--priority", type=int, default=0,
                   help="job priority (higher wins gang admission and "
                        "may preempt lower-priority jobs; default 0)")
    j.add_argument("--quota", default="",
                   help="per-job resource caps as JSON, e.g. "
                        "'{\"CPU\": 4, \"TPU\": 8}'")
    j.add_argument("--wait", action="store_true",
                   help="block until the job finishes; print its logs")
    j.add_argument("--timeout", type=float, default=3600)
    j.set_defaults(fn=cmd_job)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("id")
        j.add_argument("--address", default="")
        j.set_defaults(fn=cmd_job)
    j = jsub.add_parser("list")
    j.add_argument("--address", default="")
    j.set_defaults(fn=cmd_job)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
