"""Minimal cluster dashboard: HTTP views over the state API + metrics.

Role-equivalent to the reference's dashboard head (ref:
python/ray/dashboard/ — head.py + http_server_head.py + module REST
endpoints), reduced to the operations core: one HTTP server that any
machine can point at the controller, serving JSON state endpoints, the
Prometheus exposition, and a self-refreshing HTML overview.  The
heavyweight per-node agent/reporter tree is deliberately absent — node
stats already flow through agent heartbeats into controller metrics.

The routes, their query arguments, status codes and bodies are the JAX
package's (``ray_tpu/dashboard``), served by a stdlib ``asyncio``
HTTP/1.1 server (``util/http11.py``, shared with the serve ingress)
instead of aiohttp.  The process imports no torch.

Run: ``rt dashboard [--address ...] [--port 8265]`` or
``python -m ray_tpu_torch.dashboard``.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Awaitable, Callable, Dict, Optional
from urllib.parse import parse_qsl

from ..util.http11 import (MAX_HEAD, TEXT, BadRequest, Response,
                           encode_response, json_response, read_body,
                           read_request)

_HTML = "text/html; charset=utf-8"
_SVG = "image/svg+xml; charset=utf-8"

_PAGE = """<!DOCTYPE html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; background: #fafafa; }
 h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.4em; }
 table { border-collapse: collapse; margin-top: .4em; }
 td, th { border: 1px solid #ccc; padding: 3px 9px; font-size: .85em;
          text-align: left; }
 th { background: #eee; }
 .ALIVE, .FINISHED, .SUCCEEDED, .RUNNING { color: #0a7a0a; }
 .DEAD, .FAILED, .ERRORED { color: #c02020; }
</style></head>
<body>
<h1>ray_tpu_torch cluster</h1>
<div id="root">loading…</div>
<script>
async function grab(p) { return (await fetch(p)).json(); }
function table(rows, cols) {
  if (!rows.length) return "<i>(none)</i>";
  let h = "<table><tr>" + cols.map(c => `<th>${c}</th>`).join("") +
          "</tr>";
  for (const r of rows)
    h += "<tr>" + cols.map(c => {
      const v = r[c] === undefined ? "" : r[c];
      return `<td class="${v}">${typeof v === "object" ?
              JSON.stringify(v) : v}</td>`; }).join("") + "</tr>";
  return h + "</table>";
}
async function refresh() {
  const [nodes, actors, tasks, jobs] = await Promise.all([
    grab("/api/nodes"), grab("/api/actors"),
    grab("/api/tasks?limit=50"), grab("/api/jobs")]);
  document.getElementById("root").innerHTML =
    "<h2>Nodes</h2>" + table(nodes, ["node_id", "agent_addr", "alive",
                                     "draining", "drain_reason",
                                     "is_head", "resources",
                                     "available"]) +
    "<h2>Actors</h2>" + table(actors, ["actor_id", "class_name",
                                       "state", "name", "node_id"]) +
    "<h2>Recent tasks</h2>" + table(tasks, ["name", "state", "kind",
                                            "node_id", "worker_pid",
                                            "error"]) +
    "<h2>Jobs</h2>" + table(jobs.jobs || [], ["job_id", "priority",
                                              "state", "quota", "usage",
                                              "entrypoint"]) +
    "<h2>Drivers</h2>" + table(jobs.drivers || [],
                               ["job_id", "driver", "alive"]) +
    `<p><a href="/metrics">/metrics</a> (Prometheus) · ` +
    `<a href="/timeseries">/timeseries</a> (utilization) · ` +
    `<a href="/api/telemetry?format=text">/api/telemetry</a> ` +
    `(goodput/MFU) · ` +
    `<a href="/api/doctor?format=text">/api/doctor</a> (health) · ` +
    `<a href="/api/perf?format=text">/api/perf</a> (roofline) · ` +
    `<a href="/api/hotpath?format=text">/api/hotpath</a> ` +
    `(control-plane phases) · ` +
    `<a href="/api/slo?format=text">/api/slo</a> (error budgets) · ` +
    `<a href="/api/trace">/api/trace</a> (slow requests) · ` +
    `<a href="/api/timeline">/api/timeline</a> (Perfetto trace)</p>`;
}
refresh(); setInterval(refresh, 3000);
</script></body></html>
"""


Handler = Callable[[Dict[str, str]], Awaitable[Response]]


def _text(text: str, content_type: str = TEXT) -> Response:
    return Response(200, text.encode(), content_type)


def _json(data: Any) -> Response:
    # repr() for what JSON cannot hold (ids, enums), as the JAX routes do.
    return json_response(json.loads(json.dumps(data, default=repr)))


def create_app(address: Optional[str] = None) -> Dict[str, Handler]:
    """The route table: path -> async handler of the query arguments
    (the first value of each key)."""
    from ..util import state as state_api

    async def call(fn, **kw):
        # State calls are synchronous (they spin their own event loop /
        # runtime io thread) — keep them off the server's loop.
        return await asyncio.get_event_loop().run_in_executor(
            None, lambda: fn(address=address, **kw))

    async def index(_q):
        return _text(_PAGE, _HTML)

    async def nodes(_q):
        return _json(await call(state_api.list_nodes))

    async def actors(_q):
        return _json(await call(state_api.list_actors))

    async def tasks(q):
        return _json(await call(state_api.list_tasks,
                                limit=int(q.get("limit", 100))))

    async def jobs(q):
        """/api/jobs — the multi-tenant job plane: per-job priority,
        quota, live resource usage, state, submission time (plus the
        internal driver registrations under "drivers").  ``?job=``
        prefix-filters like `rt jobs`."""
        overview = await call(state_api.jobs_overview,
                              job_id=q.get("job") or None)
        drivers = await call(state_api.list_jobs)
        return _json({"jobs": overview, "drivers": drivers})

    async def objects(_q):
        return _json(await call(state_api.list_objects))

    async def metrics(_q):
        return _text(await call(state_api.metrics_text))

    async def telemetry(q):
        """/api/telemetry — the training telemetry plane: cluster
        goodput summary, per-step train series, collective latency,
        serve ingress, flight-recorder dumps (`rt telemetry` JSON)."""
        from ..util import telemetry as telemetry_mod

        summary = await call(telemetry_mod.cluster_summary)
        if q.get("format") == "text":
            return _text(telemetry_mod.render_text(summary))
        return _json(summary)

    async def doctor(q):
        """/api/doctor — the aggregated health diagnosis (`rt doctor`
        JSON).  ?format=text renders the CLI report."""
        from ..util import doctor as doctor_mod

        diag = await call(doctor_mod.cluster_diagnosis)
        if q.get("format") == "text":
            return _text(doctor_mod.render_text(diag))
        return _json(diag)

    async def perf(q):
        """/api/perf — the performance introspection report (`rt perf`
        JSON): roofline position, step decomposition, per-axis
        collective shares, compile events, device-memory watermarks.
        ?format=text renders the CLI report.  Peaks are those of the
        GPU NVML names (this process loads no torch)."""
        from ..core.resources import nvml_device_name
        from ..util import xprof as xprof_mod

        rep = await call(xprof_mod.cluster_report,
                         device_name=nvml_device_name())
        if q.get("format") == "text":
            return _text(xprof_mod.render_report(rep))
        return _json(rep)

    async def hotpath(q):
        """/api/hotpath — the control-plane hot-path phase
        decomposition (`rt hotpath` JSON).  ?format=text renders the
        CLI report."""
        from ..util import hotpath as hotpath_mod

        snap = await call(state_api.hotpath)
        if q.get("format") == "text":
            return _text(hotpath_mod.render_text(snap))
        return _json(snap)

    async def slo(q):
        """/api/slo — the SLO / error-budget report (`rt slo` JSON).
        ?format=text renders the CLI report."""
        from ..util import slo as slo_mod

        rep = await call(slo_mod.report)
        if q.get("format") == "text":
            return _text(slo_mod.render_text(rep))
        return _json(rep)

    async def trace(q):
        """/api/trace?id=<request_id> — one request's cross-process
        hop chain (`rt trace` JSON); without ?id, the slowest-request
        exemplar listing."""
        rid = q.get("id")
        if rid:
            return _json(await call(state_api.request_trace,
                                    request_id=rid))
        return _json(await call(state_api.request_exemplars))

    async def timeline(q):
        """/api/timeline — the unified cluster timeline as Chrome-trace
        JSON; ?summary=1 returns the per-step critical-path summary
        instead (`rt timeline --summary`)."""
        if q.get("summary", "").lower() not in ("", "0", "false", "no"):
            return _json(await call(state_api.timeline_summary))
        return _json(await call(state_api.cluster_timeline))

    async def timeseries_json(q):
        return _json(await call(state_api.metrics_history,
                                source=q.get("source")))

    async def timeseries(_q):
        """Per-node utilization over time, server-rendered SVG."""
        hist = await call(state_api.metrics_history)
        parts = ["<html><head><meta http-equiv=refresh content=5>"
                 "<title>rt timeseries</title></head><body>"
                 "<h1>Node utilization</h1>"]
        plots = [("rt_node_cpu_util", "CPU util", 1.0),
                 ("rt_node_mem_util", "Memory util", 1.0),
                 ("rt_node_object_store_bytes{kind=used}",
                  "Object store bytes", None),
                 ("rt_node_leases_active", "Active leases", None)]
        for src in sorted(hist):
            rows = hist[src]
            # Only sources that carry node-utilization gauges.
            if not rows or not any(
                    k.startswith("rt_node_") for k in rows[-1][1]):
                continue
            parts.append(f"<h2>{src}</h2><table>")
            for key, label, y_max in plots:
                series = [vals.get(key, 0.0) for _ts, vals in rows]
                parts.append(
                    f"<tr><td>{label}</td><td>"
                    f"{_sparkline(series, y_max=y_max)}</td></tr>")
            parts.append("</table>")
        parts.append('<p><a href="/">back</a> · '
                     '<a href="/api/timeseries">json</a></p>'
                     "</body></html>")
        return _text("".join(parts), _HTML)

    def _sel(q):
        kw: Dict[str, Any] = {}
        if q.get("worker"):
            kw["worker_id"] = q["worker"]
        if q.get("pid"):
            kw["pid"] = int(q["pid"])
        if q.get("node"):
            kw["node_id"] = q["node"]
        return kw

    async def logs(q):
        """/api/logs — inventory; /api/logs?worker=..|pid=.. — tail."""
        kw = _sel(q)
        if "worker_id" in kw or "pid" in kw:
            return _text(await call(state_api.get_log, **kw))
        return _json(await call(state_api.list_logs, **kw))

    async def stack(q):
        """/api/stack?worker=..|pid=.. — live thread dump."""
        return _text(await call(state_api.stack_worker, **_sel(q)))

    async def profile(q):
        """/api/profile?worker=..&duration=2 — sampling profile of a
        live worker as an SVG flamegraph; &format=folded for the raw
        stacks."""
        from ..util.profiling import render_flamegraph_svg

        kw = _sel(q)
        folded = await call(state_api.profile_worker,
                            duration_s=float(q.get("duration", 2.0)),
                            **kw)
        if q.get("format") == "folded":
            return _text("\n".join(f"{k} {v}" for k, v in folded.items()))
        return _text(render_flamegraph_svg(
            folded, title=f"worker {kw.get('worker_id') or kw.get('pid')}"),
            _SVG)

    return {"/": index, "/api/nodes": nodes, "/api/actors": actors,
            "/api/tasks": tasks, "/api/jobs": jobs,
            "/api/objects": objects, "/api/logs": logs,
            "/api/stack": stack, "/api/profile": profile,
            "/metrics": metrics, "/api/doctor": doctor,
            "/api/perf": perf, "/api/hotpath": hotpath,
            "/api/telemetry": telemetry, "/api/timeline": timeline,
            "/api/slo": slo, "/api/trace": trace,
            "/timeseries": timeseries,
            "/api/timeseries": timeseries_json}


def _sparkline(points, width=420, height=48, y_max=None):
    """Server-rendered SVG polyline — no JS chart dependency."""
    if not points:
        return "<svg/>"
    top = y_max if y_max is not None else max(max(points), 1e-9) * 1.05
    n = max(len(points) - 1, 1)
    coords = " ".join(
        f"{i * width / n:.1f},"
        f"{height - min(v / top, 1.0) * height:.1f}"
        for i, v in enumerate(points))
    return (f'<svg width="{width}" height="{height}" '
            f'style="background:#f6f6f6">'
            f'<polyline points="{coords}" fill="none" '
            f'stroke="#06c" stroke-width="1.5"/>'
            f'<text x="2" y="12" font-size="10">'
            f'last={points[-1]:.3g} max={max(points):.3g}</text>'
            f"</svg>")


async def _respond(app: Dict[str, Handler], method: str, path: str,
                   query: str) -> Response:
    """Route one request as aiohttp's router does: GET (and HEAD) on a
    known path, 405 for another method there, 404 elsewhere, 500 when
    the handler raises."""
    handler = app.get(path)
    if handler is None:
        return Response(404, b"404: Not Found", TEXT)
    if method not in ("GET", "HEAD"):
        resp = Response(405, b"405: Method Not Allowed", TEXT)
        resp.headers["Allow"] = "GET,HEAD"
        return resp
    q: Dict[str, str] = {}
    for k, v in parse_qsl(query, keep_blank_values=True):
        q.setdefault(k, v)      # the first value of a key
    try:
        return await handler(q)
    except Exception:  # noqa: BLE001 — a handler fault answers 500
        return Response(500, b"500 Internal Server Error\n\n"
                         b"Server got itself in trouble", TEXT)


def _connection(app: Dict[str, Handler]):
    async def handle(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        """Requests in order (HTTP/1.1 keep-alive) until the client
        closes or asks to."""
        try:
            while True:
                req = None
                try:
                    req = await read_request(reader)
                    if req is None:
                        return
                    await read_body(req, reader, writer)
                except BadRequest as e:
                    resp, keep = Response(e.status, str(e).encode(),
                                          TEXT), False
                else:
                    resp = await _respond(app, req.method, req.path,
                                          req.query)
                    keep = req.keep_alive
                data = encode_response(resp, keep)
                if req is not None and req.method == "HEAD":
                    data = data[:len(data) - len(resp.body)]
                writer.write(data)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.CancelledError):
            return
        finally:
            try:
                writer.close()
            except Exception:
                pass

    return handle


async def start_server(address: Optional[str] = None, port: int = 8265,
                       host: str = "0.0.0.0") -> asyncio.AbstractServer:
    """Start serving on the running loop; the bound port is
    ``server.sockets[0].getsockname()[1]``."""
    return await asyncio.start_server(_connection(create_app(address)),
                                      host, port, limit=MAX_HEAD)


def run_dashboard(address: Optional[str] = None, port: int = 8265,
                  host: str = "0.0.0.0") -> None:
    async def _serve():
        server = await start_server(address, port, host)
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
