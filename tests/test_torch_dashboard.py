"""The port's dashboard (stdlib ``asyncio`` HTTP/1.1) against the JAX
package's (aiohttp) over one recorded cluster state.

A live port cluster runs a task and a named actor; both dashboards then
serve every route once against it while every controller and node-agent
reply their state calls receive is recorded (JAX's state module is
routed to the same live cluster).  The cluster goes away, both
packages' state calls replay the recording, and every route is fetched
again from both servers: the status codes, content types and JSON keys
must be equal, and the bodies too where they hold no time of their own.
Unknown paths answer 404 and other methods 405 in both.  The dashboard
process of the port imports no torch (tests/test_torch_isolation.py).
"""

import asyncio
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

ROUTES = ["/", "/api/nodes", "/api/actors", "/api/tasks",
          "/api/tasks?limit=5", "/api/jobs", "/api/jobs?job=nope",
          "/api/objects", "/api/logs", "/api/logs?pid={pid}",
          "/api/stack?pid={pid}", "/api/profile?pid={pid}&duration=0.2",
          "/api/profile?pid={pid}&duration=0.2&format=folded",
          "/metrics", "/api/doctor", "/api/doctor?format=text",
          "/api/perf", "/api/perf?format=text", "/api/hotpath",
          "/api/hotpath?format=text", "/api/telemetry",
          "/api/telemetry?format=text", "/api/timeline",
          "/api/timeline?summary=1", "/api/slo", "/api/slo?format=text",
          "/api/trace", "/api/trace?id=nope", "/timeseries",
          "/api/timeseries", "/api/timeseries?source=nope", "/api/nope"]


def _serve_jax(address):
    from aiohttp import web

    from ray_tpu.dashboard import create_app

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(create_app(address))
    holder = {}

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        holder["port"] = site._server.sockets[0].getsockname()[1]
        loop.run_forever()

    threading.Thread(target=serve, daemon=True).start()
    return loop, holder


def _serve_port(address):
    from ray_tpu_torch.dashboard import start_server

    loop = asyncio.new_event_loop()
    holder = {}

    def serve():
        asyncio.set_event_loop(loop)
        server = loop.run_until_complete(
            start_server(address, port=0, host="127.0.0.1"))
        holder["port"] = server.sockets[0].getsockname()[1]
        loop.run_forever()

    threading.Thread(target=serve, daemon=True).start()
    return loop, holder


def _fetch(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _both(address, pid):
    servers = {"jax": _serve_jax(address), "port": _serve_port(address)}
    deadline = time.time() + 30
    while not all("port" in h for _l, h in servers.values()):
        assert time.time() < deadline
        time.sleep(0.05)
    out = {}
    try:
        for name, (_loop, holder) in servers.items():
            out[name] = {r: _fetch(holder["port"], r.format(pid=pid))
                         for r in ROUTES}
            out[name]["POST /api/nodes"] = _fetch(holder["port"],
                                                  "/api/nodes", "POST")
    finally:
        for loop, _h in servers.values():
            loop.call_soon_threadsafe(loop.stop)
    return out


# Keys the port's reports name for the GPU by design: the xprof report's
# peak table names the device where JAX's names the TPU generation.
RENAMED = {"gen": "device"}


def _keys(body):
    """The JSON key structure: dict keys, recursively, and the keys of
    a list's first element."""
    if isinstance(body, dict):
        return {RENAMED.get(k, k): _keys(v)
                for k, v in sorted(body.items())}
    if isinstance(body, list):
        return [_keys(body[0])] if body else []
    return type(body).__name__


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import ray_tpu.util.state as jax_state
    import ray_tpu_torch
    import ray_tpu_torch.util.state as port_state

    saved_env = os.environ.get("RT_SESSION_DIR_ROOT")
    os.environ["RT_SESSION_DIR_ROOT"] = str(tmp_path_factory.mktemp("dash"))
    real_call, real_agent = port_state._call, port_state._agent_call
    saved = {m: (m._call, m._agent_call) for m in (jax_state, port_state)}
    tape = {}

    def key(*a):
        return json.dumps(a, sort_keys=True, default=repr)

    def rec_call(method, payload=None, address=None):
        out = real_call(method, payload, address)
        tape.setdefault(key("c", method, payload), out)
        return out

    def rec_agent(agent_addr, method, payload=None):
        out = real_agent(agent_addr, method, payload)
        tape.setdefault(key("a", agent_addr, method, payload), out)
        return out

    def play_call(method, payload=None, address=None):
        return tape[key("c", method, payload)]

    def play_agent(agent_addr, method, payload=None):
        return tape[key("a", agent_addr, method, payload)]

    rt = ray_tpu_torch.init(mode="cluster", num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def work():
            return 1

        @ray_tpu_torch.remote
        class Keeper:
            def pid(self):
                return os.getpid()

        k = Keeper.options(name="dash_keeper").remote()
        pid = ray_tpu_torch.get(k.pid.remote(), timeout=60)
        assert ray_tpu_torch.get(work.remote(), timeout=60) == 1
        deadline = time.time() + 30
        while not any(t.get("name", "").endswith("work")
                      for t in port_state.list_tasks()):
            assert time.time() < deadline
            time.sleep(0.3)
        for m in (jax_state, port_state):
            m._call, m._agent_call = rec_call, rec_agent
        live = _both(rt.controller_addr, pid)
        address = rt.controller_addr
    finally:
        ray_tpu_torch.shutdown()
        for m, (c, a) in saved.items():
            m._call, m._agent_call = c, a
    try:
        for m in (jax_state, port_state):
            m._call, m._agent_call = play_call, play_agent
        replay = _both(address, pid)
    finally:
        for m, (c, a) in saved.items():
            m._call, m._agent_call = c, a
        if saved_env is None:
            os.environ.pop("RT_SESSION_DIR_ROOT", None)
        else:
            os.environ["RT_SESSION_DIR_ROOT"] = saved_env
    return {"live": live, "replay": replay, "pid": pid}


@pytest.mark.parametrize("route", ROUTES + ["POST /api/nodes"])
def test_route_matches_jax(served, route):
    port = served["replay"]["port"][route]
    jax = served["replay"]["jax"][route]
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    if port[1].startswith("application/json"):
        assert _keys(json.loads(port[2])) == _keys(json.loads(jax[2]))
    elif route != "/":      # the page names its package
        assert (port[0], len(port[2]) > 0) == (jax[0], len(jax[2]) > 0)


def test_routes_answer_on_the_live_cluster(served):
    """Against the live cluster every route but the unknown path and
    the POST answers 200 in both servers, and shows the cluster."""
    for name in ("jax", "port"):
        got = served["live"][name]
        codes = {r: got[r][0] for r in ROUTES}
        assert codes.pop("/api/nope") == 404
        assert set(codes.values()) == {200}, (name, codes)
        assert got["POST /api/nodes"][0] == 405
    port = served["live"]["port"]
    assert b"ray_tpu_torch cluster" in port["/"][2]
    nodes = json.loads(port["/api/nodes"][2])
    assert len(nodes) == 1 and nodes[0]["alive"]
    actors = json.loads(port["/api/actors"][2])
    assert any(a.get("name") == "dash_keeper" for a in actors)
    assert b"rt_nodes_alive" in port["/metrics"][2]
    telemetry = json.loads(port["/api/telemetry"][2])
    assert {"goodput", "train", "collectives", "serve",
            "flight"} <= set(telemetry)
    assert b"Goodput" in port["/api/telemetry?format=text"][2]
    assert port["/api/profile?pid={pid}&duration=0.2"][2].startswith(
        b"<svg")
    assert b"thread" in port["/api/stack?pid={pid}"][2]


def test_replayed_bodies_equal_where_timeless(served):
    """The same recorded state renders the same bodies in both servers
    (routes whose body carries the time of the request are left out)."""
    timed = {"/", "/api/doctor", "/api/doctor?format=text", "/api/perf",
             "/api/perf?format=text", "/api/hotpath",
             "/api/hotpath?format=text", "/api/telemetry",
             "/api/telemetry?format=text", "/api/slo",
             "/api/slo?format=text", "/api/profile?pid={pid}&duration=0.2",
             "/api/timeline", "/api/jobs", "/api/logs"}
    port, jax = served["replay"]["port"], served["replay"]["jax"]
    assert {port[r][0] for r in ROUTES if r != "/api/nope"} == {200}
    same = [r for r in ROUTES if r not in timed and port[r][2] == jax[r][2]]
    assert same == [r for r in ROUTES if r not in timed]
