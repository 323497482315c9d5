"""The port's ``rt://`` remote driver against the JAX package's.

tests/test_client_mode.py's programs through both packages' relays: a
cluster and a ``ClientServer`` in this process per package (JAX's
first), each program a thin-client driver in a fresh interpreter that
connects with ``init(address="rt://...")``.  The programs: the core
semantics (tasks with ref arguments, actors and named actors, put/get of
numpy arrays, wait, kill, cancel, resources), two drivers that share a
named actor but not their refs, error propagation with the remote
traceback and a get timeout, and a disconnected driver's actors reaped.
Their printed results must be equal.  The port alone also carries a
bf16 tensor through the relay bit for bit (it crosses packed as host
bytes, so the session host never initialises CUDA).  An unreachable
``rt://`` address raises the same error in both packages.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")

SEMANTICS = r"""
import importlib, json, sys
import numpy as np
pkg, addr = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
rt.init(address=addr)
out = {}

@rt.remote
def add(a, b):
    return a + b

@rt.remote
def total(arr):
    return float(arr.sum())

x = rt.put(np.arange(10, dtype=np.float32))
out["task_ref_arg"] = rt.get(total.remote(x), timeout=120)
out["chain"] = rt.get(add.remote(add.remote(1, 2), 3), timeout=120)
out["many"] = rt.get([add.remote(i, i) for i in range(20)], timeout=120)
big = np.random.default_rng(0).standard_normal((256, 1024))
out["put_get_big"] = bool(np.array_equal(rt.get(rt.put(big)), big))
ready, pending = rt.wait([add.remote(1, 1) for _ in range(4)],
                         num_returns=4, timeout=60)
out["wait"] = (len(ready), len(pending))

class Counter:
    def __init__(self, start):
        self.n = start
    def inc(self, by=1):
        self.n += by
        return self.n

c = rt.remote(Counter).options(name="client_counter").remote(10)
out["actor"] = [rt.get(c.inc.remote(), timeout=60) for _ in range(3)]
out["named"] = rt.get(rt.get_actor("client_counter").inc.remote(5),
                      timeout=60)
rt.kill(c)
try:
    rt.get(c.inc.remote(), timeout=60)
    out["killed"] = "no error"
except Exception as e:
    out["killed"] = type(e).__name__

@rt.remote
def sleeper():
    import time
    time.sleep(60)

ref = sleeper.remote()
rt.cancel(ref, force=True)
try:
    rt.get(ref, timeout=60)
    out["cancel"] = "no error"
except Exception as e:
    out["cancel"] = type(e).__name__
out["cpus"] = rt.cluster_resources().get("CPU")
out["nodes"] = len(rt.nodes())
rt.shutdown()
print("RESULT " + json.dumps(out))
"""

TWO_DRIVERS = r"""
import importlib, sys, time
pkg, addr, role = sys.argv[1], sys.argv[2], sys.argv[3]
rt = importlib.import_module(pkg)
rt.init(address=addr)

@rt.remote
def who(x):
    return x * 2

refs = [who.remote(i) for i in range(8)]
assert rt.get(refs, timeout=120) == [2 * i for i in range(8)]

class Counter:
    def __init__(self):
        self.n = 0
    def bump(self):
        self.n += 1
        return self.n

if role == "creator":
    c = rt.remote(Counter).options(name="shared_counter",
                                   num_cpus=0).remote()
    assert rt.get(c.bump.remote(), timeout=60) == 1
    print("CREATOR_OK", flush=True)
    sys.stdin.readline()    # alive until the peer is done
else:
    deadline = time.time() + 30
    c = None
    while time.time() < deadline:
        try:
            c = rt.get_actor("shared_counter")
            break
        except ValueError:
            time.sleep(0.5)
    assert c is not None, "named actor never appeared across clients"
    print("PEER_OK", rt.get(c.bump.remote(), timeout=60), flush=True)
rt.shutdown()
"""

ERRORS = r"""
import importlib, sys
pkg, addr = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
rt.init(address=addr)

@rt.remote
def boom():
    raise ValueError("client-visible failure")

try:
    rt.get(boom.remote(), timeout=120)
    raise SystemExit("no error raised")
except ValueError as e:
    assert "client-visible failure" in str(e)
    assert "Remote traceback" in str(e), str(e)[:500]

@rt.remote
def slow():
    import time
    time.sleep(30)

try:
    rt.get(slow.remote(), timeout=1.0)
    raise SystemExit("no timeout raised")
except rt.GetTimeoutError:
    pass
print("ERRORS_OK", flush=True)
rt.shutdown()
"""

HOLDER = r"""
import importlib, os, sys
pkg, addr = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
rt.init(address=addr)

class Holder:
    def pid(self):
        return os.getpid()

actors = [rt.remote(Holder).remote() for _ in range(3)]
pids = rt.get([a.pid.remote() for a in actors], timeout=120)
assert len(set(pids)) == 3
print("HOLDING", flush=True)
rt.shutdown()
"""

AVAIL = r"""
import importlib, sys
pkg, addr = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
rt.init(address=addr)
print("AVAIL", rt.available_resources().get("CPU", 0))
rt.shutdown()
"""

TENSOR = r"""
import sys
import torch
import ray_tpu_torch as rt
rt.init(address=sys.argv[2])
gen = torch.Generator().manual_seed(11)
t = torch.randn(64, 1024, 32, generator=gen).to(torch.bfloat16)

@rt.remote
def twice(x):
    return x * 2

back = rt.get(rt.put(t), timeout=120)
doubled = rt.get(twice.remote(t), timeout=120)
print("TENSOR", back.dtype, torch.equal(back.view(torch.int16),
                                        t.view(torch.int16)),
      torch.equal(doubled.view(torch.int16), (t * 2).view(torch.int16)))
rt.shutdown()
"""


def _run(code, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))


def _programs(pkg: str) -> dict:
    import importlib

    Cluster = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    ClientServer = importlib.import_module(f"{pkg}.client").ClientServer
    EventLoopThread = importlib.import_module(
        f"{pkg}.core.rpc").EventLoopThread
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    io = EventLoopThread("client-server")
    server = ClientServer(cluster.address, host="127.0.0.1")
    io.run(server.start())
    addr = f"rt://127.0.0.1:{server.port}"
    out = {}
    try:
        p = _run(SEMANTICS, pkg, addr)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT ")]
        assert line, p.stdout[-3000:]
        out["semantics"] = json.loads(line[0][len("RESULT "):])

        creator = subprocess.Popen(
            [sys.executable, "-c", TWO_DRIVERS, pkg, addr, "creator"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = creator.stdout.readline()
            lines.append(line)
            if "CREATOR_OK" in line or not line:
                break
        peer = _run(TWO_DRIVERS, pkg, addr, "peer")
        creator.stdin.write("\n")
        creator.stdin.flush()
        creator.wait(timeout=120)
        out["two_drivers"] = (any("CREATOR_OK" in ln for ln in lines),
                              peer.returncode,
                              re.findall(r"PEER_OK \d+", peer.stdout),
                              creator.returncode)

        p = _run(ERRORS, pkg, addr)
        out["errors"] = (p.returncode, "ERRORS_OK" in p.stdout)

        def avail():
            q = _run(AVAIL, pkg, addr, timeout=120)
            m = re.search(r"AVAIL ([\d.]+)", q.stdout)
            assert m, q.stdout[-1500:]
            return float(m.group(1))

        baseline, deadline = 0.0, time.time() + 60
        while time.time() < deadline and baseline < 8.0:
            baseline = avail()
            time.sleep(0.5)
        p = _run(HOLDER, pkg, addr)
        recovered, deadline = 0.0, time.time() + 60
        while time.time() < deadline:
            recovered = avail()
            if recovered >= baseline:
                break
            time.sleep(1.0)
        out["reaped"] = (baseline, p.returncode, "HOLDING" in p.stdout,
                         recovered)
        if pkg == "ray_tpu_torch":
            p = _run(TENSOR, pkg, addr)
            out["tensor"] = re.findall(r"TENSOR .*", p.stdout) \
                or [p.stdout[-2000:]]
    finally:
        io.run(server.stop())
        cluster.shutdown()
    return out


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    saved = os.environ.get("RT_SESSION_DIR_ROOT")
    out = {}
    try:
        for pkg in PACKAGES:
            os.environ["RT_SESSION_DIR_ROOT"] = str(
                tmp_path_factory.mktemp(pkg))
            out[pkg] = _programs(pkg)
    finally:
        if saved is None:
            os.environ.pop("RT_SESSION_DIR_ROOT", None)
        else:
            os.environ["RT_SESSION_DIR_ROOT"] = saved
    return out


@pytest.mark.parametrize("key", ["semantics", "two_drivers", "errors",
                                 "reaped"])
def test_client_programs_match_jax(programs, key):
    assert programs["ray_tpu_torch"][key] == programs["ray_tpu"][key]


def test_client_program_values(programs):
    port = programs["ray_tpu_torch"]
    sem = port["semantics"]
    assert sem["task_ref_arg"] == 45.0 and sem["chain"] == 6
    assert sem["many"] == [2 * i for i in range(20)]
    assert sem["put_get_big"] is True and sem["wait"] == [4, 0]
    assert sem["actor"] == [11, 12, 13] and sem["named"] == 18
    assert sem["killed"] == "ActorDiedError"
    assert sem["cancel"] == "TaskError(TaskCancelledError)"
    assert sem["cpus"] == 8.0 and sem["nodes"] == 1
    assert port["two_drivers"] == (True, 0, ["PEER_OK 2"], 0)
    assert port["errors"] == (0, True)
    baseline, rc, holding, recovered = port["reaped"]
    assert baseline == 8.0 and rc == 0 and holding
    assert recovered >= baseline


def test_bf16_tensor_through_the_relay(programs):
    assert programs["ray_tpu_torch"]["tensor"] == \
        ["TENSOR torch.bfloat16 True True"]


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unreachable_address_raises_like_jax(pkg, monkeypatch):
    """Both packages' ClientRuntime raise the RPC layer's RpcError (a
    ConnectionError) naming the address and leave no runtime behind;
    the connect timeout is cut from 30 s to 1 s for the test."""
    import importlib

    rt = importlib.import_module(pkg)
    client_runtime = importlib.import_module(f"{pkg}.client.runtime")
    rpc = importlib.import_module(f"{pkg}.core.rpc")
    real = client_runtime.RpcClient
    monkeypatch.setattr(client_runtime, "RpcClient",
                        lambda addr, **kw: real(addr, **{
                            **kw, "connect_timeout": 1.0}))
    port = _closed_port()
    with pytest.raises(rpc.RpcError) as ei:
        rt.init(address=f"rt://127.0.0.1:{port}")
    assert isinstance(ei.value, ConnectionError)
    assert str(ei.value).startswith(f"cannot connect to 127.0.0.1:{port}: ")
    assert not rt.is_initialized()
