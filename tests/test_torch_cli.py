"""The port's ``rt`` CLI (``python -m ray_tpu_torch``) and
``init(address="auto")`` against the JAX package's.

One flow per package (JAX's first), each with its own session root:
``start`` without a role is refused; ``start --head`` (one accelerator:
``--num-tpus 1`` / ``--num-gpus 1``) and a second node joining by
address; ``status``; a driver in a fresh interpreter connects with
``init(address="auto")`` and runs a task on the joined node, one on the
accelerator and a put; ``list nodes`` / ``list tasks`` / ``list
leases``; ``drain`` of the joined node, which ``status`` and ``doctor``
then show, and which turns into the critical stale-drain finding (and
``doctor``'s exit code 1) once its grace has passed; ``timeline
--summary``; ``stop``, after which ``status`` finds no cluster and no
process of the session lives.  The port's numbers are held to JAX's;
JAX's pid-spread check (tests/test_cli.py) is not taken as reference,
its tasks land on one worker (ROADMAP Queue 3).  ``init`` with an
unreachable ``rt://`` address raises the RPC layer's connection error in
both packages (the job, launcher, dashboard and client commands have
their own files: tests/test_torch_jobs.py, test_torch_autoscaler.py,
test_torch_dashboard.py, test_torch_client.py).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")

DRIVER = r"""
import importlib, json, os, sys
pkg = sys.argv[1]
acc, var = (("num_tpus", "TPU_VISIBLE_CHIPS") if pkg == "ray_tpu"
            else ("num_gpus", "CUDA_VISIBLE_DEVICES"))
rt = importlib.import_module(pkg)
rt.init(address="auto")

@rt.remote(resources={"joiner": 1})
def on_joiner():
    return "joined"

@rt.remote(**{acc: 1})
def on_accelerator():
    return os.environ.get(var)

out = {"joiner": rt.get(on_joiner.remote(), timeout=120),
       "accelerator": rt.get(on_accelerator.remote(), timeout=120),
       "put": rt.get(rt.put(41), timeout=60) + 1,
       "resources": sorted(rt.cluster_resources())}
rt.shutdown()
print("DRIVER " + json.dumps(out))
"""


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie has exited; only its parent's wait is missing.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def _flow(pkg: str, root: Path) -> dict:
    env = dict(os.environ, RT_SESSION_DIR_ROOT=str(root),
               PYTHONPATH=str(ROOT))
    env.pop("RT_ADDRESS", None)

    def rt(*args, timeout=90):
        return subprocess.run([sys.executable, "-m", pkg, *args],
                              capture_output=True, text=True, env=env,
                              timeout=timeout, cwd=root)

    acc = "--num-tpus" if pkg == "ray_tpu" else "--num-gpus"
    key = "TPU" if pkg == "ray_tpu" else "GPU"
    out = {}
    r = rt("start")
    out["no_role"] = (r.returncode, "--head or --address" in r.stderr)
    r = rt("start", "--head", "--port", "0", "--num-cpus", "2", acc, "1")
    assert r.returncode == 0, r.stderr + r.stdout
    trailer = dict(ln.split("=", 1) for ln in r.stdout.splitlines()
                   if ln.startswith("RT_"))
    address = trailer["RT_ADDRESS"]
    out["head_pids"] = len(trailer["RT_PIDS"].split(","))
    out["not_loopback"] = not address.startswith("127.")
    pids = [int(p) for p in trailer["RT_PIDS"].split(",")]
    try:
        r = rt("start", "--address", address, "--num-cpus", "1",
               "--resources", json.dumps({"joiner": 1}))
        assert r.returncode == 0, r.stderr + r.stdout
        trailer = dict(ln.split("=", 1) for ln in r.stdout.splitlines()
                       if ln.startswith("RT_"))
        joiner = trailer["RT_NODE_ID"]
        pids += [int(p) for p in trailer["RT_PIDS"].split(",")]
        r = rt("status")
        out["status"] = (r.returncode,
                         "Nodes: 2 alive / 2 total" in r.stdout,
                         "(head)" in r.stdout,
                         f"total: CPU=2, {key}=1" in r.stdout)
        d = subprocess.run([sys.executable, "-c", DRIVER, pkg],
                           capture_output=True, text=True, env=env,
                           timeout=240, cwd=root)
        line = [ln for ln in d.stdout.splitlines()
                if ln.startswith("DRIVER ")]
        assert line, d.stdout + d.stderr
        out["driver"] = json.loads(line[0][len("DRIVER "):])
        r = rt("list", "nodes", "--format", "json")
        nodes = json.loads(r.stdout)
        out["nodes"] = sorted((n["alive"], n["resources"].get(key, 0.0),
                               n["resources"].get("joiner", 0.0))
                              for n in nodes)
        # Task records reach the controller on the workers' and the
        # owner's flush cadence: read until both tasks show FINISHED.
        deadline = time.monotonic() + 30
        while True:
            r = rt("list", "tasks", "--format", "json")
            states = {(t.get("name", "").split(".")[-1], t.get("state"))
                      for t in json.loads(r.stdout)
                      if "on_" in t.get("name", "")}
            done = {n for n, st in states if st == "FINISHED"}
            if len(done) == 2 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        out["tasks"] = sorted(done)
        r = rt("list", "leases")
        out["leases_rc"] = r.returncode
        r = rt("timeline", "--summary")
        out["timeline_rc"] = r.returncode

        # A grace that outlasts the status and doctor reads below on a
        # loaded host, then the wait for it to go stale.
        r = rt("drain", joiner[:12], "--grace", "8", "--reason",
               "maintenance")
        out["drain"] = (r.returncode, "DRAINING" in r.stdout)
        r = rt("status")
        out["status_drain"] = "DRAIN" in r.stdout
        r = rt("doctor", "--format", "json")
        findings = json.loads(r.stdout)["findings"]
        out["draining_named"] = any(
            f["check"] == "draining_node" and joiner[:12] in f["summary"]
            for f in findings)
        deadline = time.monotonic() + 30
        while True:
            r = rt("doctor", "--format", "json")
            stale = [f for f in json.loads(r.stdout)["findings"]
                     if f["check"] == "stale_drain"
                     and joiner[:12] in f["summary"]]
            if stale or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        out["stale_drain"] = (r.returncode,
                              [f["severity"] for f in stale])
    finally:
        r = rt("stop")
        out["stop_rc"] = r.returncode
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    out["left_alive"] = [p for p in pids if _alive(p)]
    out["status_after_stop"] = rt("status").returncode
    return out


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    return {pkg: _flow(pkg, tmp_path_factory.mktemp(pkg))
            for pkg in PACKAGES}


@pytest.mark.parametrize("key", [
    "no_role", "head_pids", "not_loopback", "status", "driver", "nodes",
    "tasks", "leases_rc", "timeline_rc", "drain", "status_drain",
    "draining_named", "stale_drain", "stop_rc", "left_alive",
    "status_after_stop"])
def test_cli_flow_matches_jax(flows, key):
    port, jax = flows["ray_tpu_torch"][key], flows["ray_tpu"][key]
    if key == "driver":
        # The accelerator's resource name differs by design.
        jax = dict(jax, resources=[("GPU" if r == "TPU" else r)
                                   for r in jax["resources"]])
    assert port == jax


def test_cli_flow_values(flows):
    port = flows["ray_tpu_torch"]
    assert port["no_role"] == (2, True)
    assert port["status"] == (0, True, True, True)
    assert port["driver"]["joiner"] == "joined"
    assert port["driver"]["accelerator"] == "0"
    assert port["driver"]["put"] == 42
    assert "GPU" in port["driver"]["resources"]
    assert port["nodes"] == [(True, 0.0, 1.0), (True, 1.0, 0.0)]
    assert port["tasks"] == ["on_accelerator", "on_joiner"]
    assert port["drain"] == (0, True) and port["status_drain"]
    assert port["draining_named"] is True
    assert port["stale_drain"] == (1, ["critical"])
    assert port["stop_rc"] == 0 and port["status_after_stop"] == 1
    assert port["left_alive"] == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_init_auto_without_a_cluster_and_rt_scheme(pkg, tmp_path,
                                                   monkeypatch):
    import importlib
    import socket

    rt = importlib.import_module(pkg)
    client_runtime = importlib.import_module(f"{pkg}.client.runtime")
    rpc = importlib.import_module(f"{pkg}.core.rpc")
    monkeypatch.setenv("RT_SESSION_DIR_ROOT", str(tmp_path))
    monkeypatch.delenv("RT_ADDRESS", raising=False)
    with pytest.raises(ConnectionError, match="no running cluster"):
        rt.init(address="auto")
    # The client's 30 s connect timeout, cut to 1 s for the test.
    real = client_runtime.RpcClient
    monkeypatch.setattr(client_runtime, "RpcClient", lambda addr, **kw:
                        real(addr, **{**kw, "connect_timeout": 1.0}))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(rpc.RpcError, match=f"cannot connect to "
                       f"127.0.0.1:{port}"):
        rt.init(address=f"rt://127.0.0.1:{port}")
    assert not rt.is_initialized()


def test_profile_takes_torch_not_jax(tmp_path):
    env = dict(os.environ, RT_SESSION_DIR_ROOT=str(tmp_path),
               PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "profile"],
                       capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 2 and "--torch" in r.stderr
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "profile",
                        "--jax"], capture_output=True, text=True, env=env,
                       timeout=60)
    assert r.returncode == 2 and "unrecognized arguments" in r.stderr
