"""The port's serve plane against the JAX package's.

The cases of ``tests/test_serve.py`` run as programs through
``ray_tpu.serve`` and ``ray_tpu_torch.serve``, each package on one
cluster of its own (cluster mode, 8 CPUs), the JAX one shut down before
the port's starts: function and class deployments, composition, load
spread over replicas, scaling, request autoscaling up and down, the
config push and the zero-RPC router, streaming over the handle, an
async handler awaiting an actor, one proxy per node, admission control
(the typed error at the handle, 429 at the proxy).  Then the
ingresses: the same raw HTTP/1.1 requests go to the JAX package's
aiohttp proxy and the port's asyncio-streams proxy (deadline 504, a
client disconnect mid-stream among them), and the same gRPC calls to
both gRPC proxies.  The failure cases (healing, failover, user errors,
stream interruption) are in ``test_torch_serve_resilience.py``.

Each case returns plain values (results, status codes, content types,
bodies, NDJSON frames; generated request ids masked) and raises where
``tests/test_serve.py`` asserts; the two packages' records must be
equal.  A last test runs the port's serve in a cluster where
``import grpc`` fails.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _until(cond, timeout: float, what: str, every: float = 0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(every)
    raise TimeoutError(what)


# ----------------------------------------------------------- programs
@case
def function_deployment(rt, serve, pkg):
    @serve.deployment
    def square(x):
        return {"sq": x["v"] ** 2}

    handle = serve.run(square.bind(), route_prefix="/square")
    out = rt.get(handle.remote({"v": 7}))
    assert out == {"sq": 49}
    return out


@case
def class_deployment_with_state(rt, serve, pkg):
    @serve.deployment(num_replicas=1)
    class Greeter:
        def __init__(self, greeting):
            self.greeting = greeting
            self.count = 0

        def __call__(self, payload):
            self.count += 1
            return f"{self.greeting}, {payload['name']}! (#{self.count})"

    handle = serve.run(Greeter.bind("Hello"), route_prefix="/greet")
    out = [rt.get(handle.remote({"name": n})) for n in "AB"]
    assert out == ["Hello, A! (#1)", "Hello, B! (#2)"]
    return out


@case
def model_composition(rt, serve, pkg):
    @serve.deployment(name="featurizer")
    class Featurizer:
        def __call__(self, payload):
            return {"feat": payload["x"] * 10}

    @serve.deployment(name="head_model")
    class Head:
        def __init__(self, featurizer):
            self.featurizer = featurizer

        def __call__(self, payload):
            m = importlib.import_module(pkg)
            feat = m.get(self.featurizer.remote(payload))
            return {"pred": feat["feat"] + 1}

    handle = serve.run(Head.bind(Featurizer.bind()),
                       route_prefix="/compose")
    out = rt.get(handle.remote({"x": 4}))
    assert out == {"pred": 41}
    return out


@case
def load_spread_over_replicas(rt, serve, pkg):
    @serve.deployment(num_replicas=2, name="pids")
    def which(_payload):
        return os.getpid()

    handle = serve.run(which.bind(), route_prefix="/pids")
    pids = {rt.get(handle.remote({})) for _ in range(12)}
    assert len(pids) == 2
    return len(pids)


@case
def scaling(rt, serve, pkg):
    @serve.deployment(name="scaled", num_replicas=1)
    def noop(_p):
        return 1

    serve.run(noop.bind(), route_prefix="/scaled")
    out = [serve.status()["scaled"]["replicas"], serve.scale("scaled", 3),
           serve.status()["scaled"]["replicas"], serve.scale("scaled", 1)]
    assert out == [1, 3, 3, 1]
    return out


@case
def request_autoscaling(rt, serve, pkg):
    @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
        upscale_delay_s=0.5, downscale_delay_s=2.0))
    def slow(x):
        time.sleep(0.4)
        return x

    handle = serve.run(slow.bind(), route_prefix="/slow")
    ctl = rt.get_actor(serve.CONTROLLER_NAME)
    start = len(rt.get(ctl.get_replicas.remote("slow")))
    stop = time.time() + 25
    peak, inflight = 1, []
    while time.time() < stop and peak < 2:
        inflight = [r for r in inflight if not rt.wait([r], timeout=0)[0]]
        while len(inflight) < 6:
            inflight.append(handle.remote(1))
        peak = max(peak, len(rt.get(ctl.get_replicas.remote("slow"))))
        time.sleep(0.3)
    assert peak >= 2, "never scaled up under load"
    rt.get(inflight)
    _until(lambda: len(rt.get(ctl.get_replicas.remote("slow"))) == 1,
           60, "never scaled back down", every=0.5)
    return [start, peak >= 2, 1]


@case
def config_push_and_local_router(rt, serve, pkg):
    @serve.deployment(num_replicas=1, name="pushy")
    def echo(x):
        if x != 7:
            time.sleep(1.0)   # still in flight when the counts are read
        return x

    handle = serve.run(echo.bind())
    first = rt.get(handle.remote(7), timeout=60)
    replicas0 = len(handle._replicas)
    serve.scale("pushy", 3)
    _until(lambda: len(handle._replicas) == 3, 3.0,
           "push update never arrived", every=0.05)
    refs = [handle.remote(i) for i in range(6)]
    counted = sum(handle._inflight.values()) > 0
    got = rt.get(refs, timeout=60)
    _until(lambda: sum(handle._inflight.values()) == 0, 10,
           "in-flight counts never drained", every=0.1)
    return [first, replicas0, len(handle._replicas), counted, got]


@case
def streaming_over_handle(rt, serve, pkg):
    @serve.deployment(name="streamer")
    def streamer(payload):
        for i in range(payload["n"]):
            yield {"i": i, "sq": i * i}

    @serve.deployment(name="single")
    def single(payload):
        return {"one": 1}

    handle = serve.run(streamer.bind(), route_prefix="/stream")
    items = list(handle.stream({"n": 150}))
    assert items == [{"i": i, "sq": i * i} for i in range(150)]
    h2 = serve.run(single.bind(), route_prefix="/single")
    return [items, list(h2.stream({}))]


@case
def async_handler_awaits_actor(rt, serve, pkg):
    class Doubler:
        def double(self, x):
            return x * 2

    doubler = rt.remote(Doubler).options(name="svc_doubler",
                                         num_cpus=0).remote()

    @serve.deployment(name="asyncdep")
    async def handler(payload):
        m = importlib.import_module(pkg)
        ref = m.get_actor("svc_doubler").double.remote(payload["v"])
        return {"doubled": await ref}

    handle = serve.run(handler.bind(), route_prefix="/async")
    out = rt.get(handle.remote({"v": 21}), timeout=60)
    rt.kill(doubler)
    assert out == {"doubled": 42}
    return out


@case
def one_proxy_per_node(rt, serve, pkg):
    @serve.deployment(num_replicas=1, name="multi_ingress")
    def hello(x):
        return {"got": x}

    serve.run(hello.bind(), route_prefix="/hello")
    ports = serve.start_http_proxies()
    out = []
    for port in ports.values():
        reply = _until(lambda: _post_json(port, "/hello", {"x": 1}), 30,
                       "route never reached the proxy")
        out.append(reply)
    assert out and all(r == (200, {"result": {"got": {"x": 1}}})
                       for r in out)
    return out


# ------------------------------------------------------------ ingress
def _raw_http(port: int, request: bytes, close_after: int = 0):
    """Send raw bytes; return (status, headers, body bytes) with a
    chunked body de-chunked.  ``close_after``: read that many NDJSON
    lines of a streamed body, then close the socket."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(request)
        f = s.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        while True:
            line = f.readline().decode("latin-1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        if "chunked" in headers.get("transfer-encoding", ""):
            body, lines = b"", 0
            while True:
                size = int(f.readline().strip(), 16)
                if size == 0:
                    f.readline()
                    break
                body += f.read(size)
                f.readline()
                lines = body.count(b"\n")
                if close_after and lines >= close_after:
                    break
        else:
            body = f.read(int(headers.get("content-length", 0)))
    return status, headers, body


def _post_json(port, path, payload):
    status, _, body = _raw_http(port, _req("POST", path, json.dumps(
        payload).encode()))
    if status == 404:
        return None
    return status, json.loads(body)


def _req(method, path, body=b"", headers=None, chunked=False):
    head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1",
            "Connection: close"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    if chunked:
        head.append("Transfer-Encoding: chunked")
        mid = len(body) // 2
        body = b"".join(b"%x\r\n%s\r\n" % (len(p), p)
                        for p in (body[:mid], body[mid:]) if p) + b"0\r\n\r\n"
    elif body or method == "POST":
        head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _first_line(text: str) -> str:
    return text.strip().splitlines()[0] if text.strip() else text


def _record(reply, sent_rid=None):
    """Status, content type, body (JSON or NDJSON frames), request id;
    a minted id is masked to its length and error texts to their first
    line (a remote traceback's paths differ between the packages)."""
    status, headers, body = reply
    ctype = headers.get("content-type", "")
    if "ndjson" in ctype:
        data = [json.loads(ln) for ln in body.decode().splitlines()]
        for fr in data:
            err = fr.get("__rt_stream_error__") if isinstance(fr, dict) \
                else None
            if err:
                err["message"] = _first_line(err["message"])
    elif "json" in ctype:
        data = json.loads(body)
        if isinstance(data, dict) and "error" in data:
            data["error"] = _first_line(data["error"])
    else:
        data = body.decode()
    rid = headers.get("x-rt-request-id")
    if sent_rid is None and rid:
        rid = f"<minted, {len(rid)} chars>"
    return [status, ctype, data, rid]


@case
def http_ingress(rt, serve, pkg):
    """Raw HTTP/1.1 requests against ``serve.start_http_proxy``: a
    JSON POST, a GET with a query, a text body, an unknown route, a
    chunked request body, a streaming deployment (chunked NDJSON), a
    stream that fails mid-way and one that fails before its first
    frame, ``X-RT-Timeout-S`` (504), a result that is not JSON, and a
    client's request id (sanitized, echoed)."""

    @serve.deployment(name="adder")
    def add(payload):
        return {"sum": payload["a"] + payload["b"]}

    @serve.deployment(name="echo")
    def echo(payload):
        return {"echo": payload}

    @serve.deployment(name="httpstream")
    def gen(payload):
        for i in range(int((payload or {}).get("n", 5))):
            yield {"chunk": i}

    @serve.deployment(name="midfail")
    def midfail(payload):
        yield {"chunk": 0}
        raise ValueError("mid-stream explosion")

    @serve.deployment(name="earlyfail")
    def earlyfail(payload):
        raise KeyError("before the first frame")
        yield {"never": True}

    @serve.deployment(name="sleepy")
    def sleepy(x):
        time.sleep(5.0)
        return x

    @serve.deployment(name="opaque")
    def opaque(x):
        return {1, 2, 3}

    for dep, prefix in ((add, "/add"), (echo, "/echo"),
                        (gen, "/gen"), (midfail, "/midfail"),
                        (earlyfail, "/earlyfail"), (sleepy, "/sleepy"),
                        (opaque, "/opaque")):
        serve.run(dep.bind(), name=prefix, route_prefix=prefix)
    port = serve.start_http_proxy()
    # The proxy learns routes through the config push.
    _until(lambda: _post_json(port, "/opaque", {}), 30,
           "routes never reached the proxy")
    js = {"Content-Type": "application/json"}
    body = json.dumps({"a": 2, "b": 40}).encode()
    requests = [
        ("json post", _req("POST", "/add", body, js), None),
        ("get query", _req("GET", "/echo?x=1&y=two&x=3&empty="), None),
        ("text body", _req("POST", "/echo", b"not json"), None),
        ("nested path", _req("POST", "/echo/deeper/path", b"[1, 2]"),
         None),
        ("unknown route", _req("GET", "/nope"), None),
        ("chunked body", _req("POST", "/add", body, js, chunked=True),
         None),
        ("stream", _req("POST", "/gen", b'{"n": 6}', js), None),
        ("stream query", _req("GET", "/gen?n=3"), None),
        ("stream fails mid-way", _req("POST", "/midfail", b"{}", js),
         None),
        ("stream fails first", _req("POST", "/earlyfail", b"{}", js),
         None),
        ("deadline", _req("POST", "/sleepy", b"{}",
                          {**js, "X-RT-Timeout-S": "0.5"}), None),
        ("not json result", _req("POST", "/opaque", b"{}", js), None),
        ("request id", _req("POST", "/add", body,
                            {**js, "X-RT-Request-Id": "client id #7!"}),
         "client id #7!"),
        ("stream request id", _req("GET", "/gen?n=2",
                                   headers={"X-RT-Request-Id": "s-1"}),
         "s-1"),
    ]
    out = {}
    for name, raw, rid in requests:
        out[name] = _record(_raw_http(port, raw), rid)
    assert out["json post"][:3] == [200, "application/json; charset=utf-8",
                                    {"result": {"sum": 42}}]
    assert out["unknown route"][0] == 404
    assert out["deadline"][0] == 504
    assert out["stream"][2] == [{"chunk": i} for i in range(6)]
    assert out["request id"][3] == "clientid7"
    return out


@case
def http_disconnect(rt, serve, pkg):
    """A client that closes its socket after 4 frames of a stream: the
    proxy counts the request as a client disconnect (status class 4xx,
    never a server error), the replica's stream ends and the proxy
    serves the next request."""
    telemetry = importlib.import_module(pkg + ".util.telemetry")

    @serve.deployment(name="longgen", num_replicas=1)
    def longgen(payload):
        for i in range(int((payload or {}).get("n", 40))):
            time.sleep(0.05)
            yield {"i": i}

    handle = serve.run(longgen.bind(), route_prefix="/long")
    port = serve.start_http_proxy()
    _until(lambda: _raw_http(port, _req("GET", "/long?n=1"))[0] != 404,
           30, "route never reached the proxy")
    status, _, body = _raw_http(port, _req("GET", "/long"), close_after=4)
    frames = [json.loads(ln) for ln in body.decode().splitlines()][:4]

    def classes():
        got = telemetry.cluster_summary()["serve"].get(
            "status_classes", {}).get("longgen", {})
        return got if got.get("4xx") else None

    counted = _until(classes, 30, "the disconnect was never counted",
                     every=0.5)
    handle._ensure_fresh()
    rep = handle._replicas[0]
    _until(lambda: rt.get(rep.open_streams.remote(), timeout=30) == 0,
           20, "the replica's stream never ended", every=0.2)
    after = _record(_raw_http(port, _req("GET", "/long?n=2")))
    return [status, frames, counted, after]


@case
def admission_shed_over_http(rt, serve, pkg):
    """Overload beyond ``serve_max_queued`` sheds with the typed error
    at the handle and with 429 at a proxy whose handles queue one
    request (``RT_SERVE_MAX_QUEUED=1`` in its process)."""
    res = importlib.import_module(pkg + ".serve.resilience")
    ctl_mod = importlib.import_module(pkg + ".serve.controller")
    proxy_mod = importlib.import_module(pkg + ".serve.proxy")

    @serve.deployment(num_replicas=1, name="narrow",
                      max_ongoing_requests=1)
    def narrow(x):
        time.sleep(0.8)
        return x

    serve.run(narrow.bind(), route_prefix="/narrow")
    os.environ["RT_SERVE_MAX_QUEUED"] = "1"
    try:
        handle = ctl_mod.DeploymentHandle("narrow")  # snapshots config
    finally:
        del os.environ["RT_SERVE_MAX_QUEUED"]

    def burst(one):
        outcomes, threads = [], []
        for i in range(6):
            th = threading.Thread(target=lambda i=i: outcomes.append(
                one(i)))
            th.start()
            threads.append(th)
            time.sleep(0.05)
        for th in threads:
            th.join(60)
        return outcomes

    def via_handle(i):
        try:
            handle.call(i, timeout_s=20)
            return "ok"
        except res.RequestShedError:
            return "shed"
        except Exception as e:  # noqa: BLE001
            return repr(e)

    class QueueOneProxy(proxy_mod.HTTPProxy):
        def __init__(self, port):
            os.environ["RT_SERVE_MAX_QUEUED"] = "1"
            super().__init__(port)

    proxy = rt.remote(QueueOneProxy).options(
        num_cpus=0, max_concurrency=32).remote(0)
    port = rt.get(proxy.port.remote())
    _until(lambda: _post_json(port, "/narrow", 0), 30,
           "route never reached the proxy")
    out = []
    for outcomes in (burst(via_handle),
                     burst(lambda i: _post_json(port, "/narrow", i)[0])):
        kinds = sorted(set(outcomes), key=str)
        assert len(kinds) == 2 and all(outcomes.count(k) >= 2
                                       for k in kinds), outcomes
        out.append(kinds)
    rt.kill(proxy)
    return out


@case
def grpc_ingress(rt, serve, pkg):
    """``Call`` and ``CallStream`` of the generic
    ``ray_tpu.serve.Ingress`` service, by deployment and by route, the
    request id trailer and NOT_FOUND."""
    import grpc

    @serve.deployment(name="grpc_target")
    def target(payload):
        return {"echo": payload}

    @serve.deployment(name="grpc_stream")
    def streamy(payload):
        for i in range(int(payload["n"])):
            yield {"i": i}

    serve.run(target.bind(), name="t", route_prefix="/grpc-t")
    serve.run(streamy.bind(), name="s", route_prefix="/grpc-s")
    port = serve.start_grpc_proxy()
    ident = lambda b: b  # noqa: E731
    out = {}
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        call = channel.unary_unary(
            "/ray_tpu.serve.Ingress/Call",
            request_serializer=ident, response_deserializer=ident)
        stream = channel.unary_stream(
            "/ray_tpu.serve.Ingress/CallStream",
            request_serializer=ident, response_deserializer=ident)
        out["by deployment"] = json.loads(call(json.dumps(
            {"deployment": "grpc_target",
             "payload": {"hello": "grpc"}}).encode(), timeout=60))
        out["by route"] = _until(lambda: json.loads(call(json.dumps(
            {"route": "/grpc-t", "payload": 5}).encode(), timeout=60)),
            30, "route never reached the gRPC proxy")
        resp, c = call.with_call(
            json.dumps({"deployment": "grpc_target",
                        "payload": 1}).encode(), timeout=60,
            metadata=(("rt-request-id", "grpc id 9"),))
        out["request id"] = [json.loads(resp),
                             dict(c.trailing_metadata())]
        out["stream"] = [json.loads(m) for m in stream(json.dumps(
            {"deployment": "grpc_stream", "payload": {"n": 4}}).encode(),
            timeout=60)]
        for name, req in (("not found", {"route": "/nope"}),
                          ("unary of a stream",
                           {"deployment": "grpc_stream",
                            "payload": {"n": 1}})):
            try:
                call(json.dumps(req).encode(), timeout=30)
                out[name] = None
            except grpc.RpcError as e:
                out[name] = e.code().name
        try:
            call(b"not json", timeout=30)
        except grpc.RpcError as e:
            out["not json"] = e.code().name
    assert out["stream"] == [{"i": i} for i in range(4)]
    assert out["not found"] == "NOT_FOUND"
    return out


# ------------------------------------------------------------- driver
def _run_all(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    serve = importlib.import_module(pkg + ".serve")
    rt.init(mode="cluster", num_cpus=8)
    out = {}
    try:
        for name, fn in CASES.items():
            try:
                out[name] = fn(rt, serve, pkg)
            except Exception as e:  # noqa: BLE001 — recorded, compared
                out[name] = ("raised", repr(e)[:2000])
            finally:
                for dep in list(serve.status()):
                    serve.delete(dep)
    finally:
        serve.shutdown()
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def results():
    return {pkg: _run_all(pkg) for pkg in PACKAGES}


@pytest.mark.parametrize("name", list(CASES))
def test_serve_program_matches_jax(results, name):
    jax_out, port_out = (results[pkg][name] for pkg in PACKAGES)
    assert not (isinstance(jax_out, tuple) and jax_out[:1] == ("raised",)), \
        jax_out
    assert port_out == jax_out


def test_serve_runs_where_grpc_is_missing(tmp_path):
    """In a cluster where ``import grpc`` fails (a shadowing package
    first on every process's path), ``serve`` and its HTTP ingress
    import and serve, and ``start_grpc_proxy`` raises ImportError
    naming grpcio."""
    shim = tmp_path / "shim" / "grpc"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('No module named grpc (test shim)')\n")
    script = textwrap.dedent(f"""
        import json, socket, sys, time
        import ray_tpu_torch as rt
        from ray_tpu_torch import serve
        rt.init(mode="cluster", num_cpus=2)
        try:
            @serve.deployment(name="adder")
            def add(p):
                return {{"sum": p["a"] + p["b"]}}
            serve.run(add.bind(), route_prefix="/add")
            port = serve.start_http_proxy()
            req = (b"POST /add HTTP/1.1\\r\\nHost: x\\r\\nConnection: close"
                   b"\\r\\nContent-Length: 13\\r\\n\\r\\n"
                   b'{{"a":1,"b":2}}')
            for _ in range(100):
                with socket.create_connection(("127.0.0.1", port)) as s:
                    s.sendall(req)
                    reply = b""
                    while chunk := s.recv(65536):
                        reply += chunk
                if b" 404 " not in reply.split(b"\\r\\n")[0]:
                    break
                time.sleep(0.3)
            print("HTTP", reply.split(b"\\r\\n\\r\\n", 1)[1].decode())
            try:
                serve.start_grpc_proxy()
                print("GRPC started")
            except ImportError as e:
                print("GRPC ImportError", e)
            print("LOADED", [m for m in sys.modules
                             if m.split(".")[0] in ("grpc", "aiohttp")])
        finally:
            serve.shutdown()
            rt.shutdown()
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path / "shim"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert 'HTTP {"result": {"sum": 3}}' in lines, out.stdout
    assert any(ln.startswith("GRPC ImportError") and "grpcio" in ln
               for ln in lines), out.stdout
    assert "LOADED []" in lines, out.stdout
