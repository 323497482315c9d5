"""The port's autoscaler and cluster launcher against the JAX package's.

- The cases of tests/test_autoscaler.py on the port's
  ``AutoscalingCluster`` (demand-driven scale-up for tasks, placement
  groups and a multi-GPU slice, idle scale-down, ``max_workers``), with
  JAX's bars.  The cluster runs with ``RT_GPUS_PER_HOST=4``, so every
  agent that is not told its GPUs would detect four: the head and the
  CPU nodes pass ``GPU: 0`` and stay GPU-free, and the slice's agent
  leases ids 0-3 to its task as ``CUDA_VISIBLE_DEVICES``.
- tests/test_cluster_launcher.py's units against JAX's functions in
  process: ``parse_cluster_spec`` on the same spec with ``TPU`` and
  ``tpu_slices`` renamed (every field equal but the start commands'
  module name), its validation errors, ``split_slice_resources``, and
  the command runners' shapes (subprocess, SSH argv, pod fan-out).
- One ``rt up`` / ``rt exec`` / ``rt down`` run of the port's CLI with
  ``provider.type: subprocess``: a head, a min worker, the head-side
  scaling loop (``rt autoscale``) adopting it, and a two-host GPU slice
  launched atomically through the provider.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu.autoscaler import cluster_spec as jax_spec
from ray_tpu.autoscaler import command_runner as jax_runner
from ray_tpu.autoscaler import remote_provider as jax_remote
from ray_tpu_torch.autoscaler import AutoscalingCluster, NodeType
from ray_tpu_torch.autoscaler import cluster_spec as port_spec
from ray_tpu_torch.autoscaler import command_runner as port_runner
from ray_tpu_torch.autoscaler import remote_provider as port_remote

ROOT = Path(__file__).resolve().parent.parent


def _wait(pred, timeout=90, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.5)
    raise TimeoutError(f"timed out waiting for {what}")


# ------------------------------------------------- the scaling loop
@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    saved = {k: os.environ.get(k) for k in ("RT_GPUS_PER_HOST",
                                            "RT_SESSION_DIR_ROOT")}
    os.environ.update(RT_GPUS_PER_HOST="4", RT_SESSION_DIR_ROOT=str(
        tmp_path_factory.mktemp("autoscaler")))
    c = AutoscalingCluster(
        node_types=[
            NodeType("cpu2", {"CPU": 2, "GPU": 0}, min_workers=0,
                     max_workers=2),
            NodeType("gpu-slice", {"GPU": 4, "CPU": 1},
                     min_workers=0, max_workers=1),
        ],
        head_resources={"CPU": 1, "GPU": 0},
        idle_timeout_s=2.0,
        update_interval_s=0.25,
    )
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_head_takes_no_gpu_it_was_not_given(cluster):
    assert "GPU" not in ray_tpu_torch.cluster_resources()
    assert ray_tpu_torch.cluster_resources()["CPU"] == 1.0


def test_scale_up_for_infeasible_task_then_idle_down(cluster):
    @ray_tpu_torch.remote(num_cpus=2)
    def big():
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    pid, visible = ray_tpu_torch.get(big.remote(), timeout=120)
    assert pid > 0 and visible == ""
    assert len(cluster.provider.non_terminated_nodes()) >= 1
    _wait(lambda: len(cluster.provider.non_terminated_nodes()) == 0,
          what="idle node termination")


def test_scale_up_for_placement_group(cluster):
    from ray_tpu_torch.util import placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy

    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=120)  # needs a fresh cpu2 node
    assert len(cluster.provider.non_terminated_nodes()) >= 1

    @ray_tpu_torch.remote(num_cpus=2)
    def inside():
        return "pg-ran"

    ref = inside.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg)).remote()
    assert ray_tpu_torch.get(ref, timeout=60) == "pg-ran"
    remove_placement_group(pg)
    _wait(lambda: len(cluster.provider.non_terminated_nodes()) == 0,
          what="post-PG idle termination")


def test_scale_up_gpu_slice(cluster):
    @ray_tpu_torch.remote(num_gpus=4)
    def on_slice():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(on_slice.remote(), timeout=120) == "0,1,2,3"
    types = {cluster.provider.node_type_of(p)
             for p in cluster.provider.non_terminated_nodes()}
    assert "gpu-slice" in types
    gpus = sorted(n["Resources"].get("GPU", 0.0)
                  for n in ray_tpu_torch.nodes() if n["Alive"])
    assert gpus[-1] == 4.0 and gpus.count(4.0) == 1
    _wait(lambda: len(cluster.provider.non_terminated_nodes()) == 0,
          what="slice idle termination", timeout=120)


def test_max_workers_respected(cluster):
    # Demands that would need 3 cpu2 nodes; cap is 2.
    @ray_tpu_torch.remote(num_cpus=2)
    def slowish():
        time.sleep(2)
        return 1

    refs = [slowish.remote() for _ in range(3)]
    _wait(lambda: len(cluster.provider.non_terminated_nodes()) >= 1,
          what="scale-up start")
    peak = 0
    deadline = time.time() + 240
    while time.time() < deadline:
        n = len([p for p in cluster.provider.non_terminated_nodes()
                 if cluster.provider.node_type_of(p) == "cpu2"])
        peak = max(peak, n)
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                     timeout=0.1)
        if len(done) == len(refs):
            break
    assert sum(ray_tpu_torch.get(refs, timeout=120)) == 3
    assert peak <= 2, f"launched {peak} cpu2 nodes, cap is 2"


# ---------------------------------------------- launcher units vs JAX
def _raw(pkg: str):
    """One spec, written for either package: ``TPU``/``tpu_slices`` for
    JAX, ``GPU``/``gpu_slices`` for the port."""
    acc = "TPU" if pkg == "jax" else "GPU"
    return {
        "cluster_name": "x",
        "provider": {"type": "ssh", "head_host": "h0",
                     "worker_hosts": {"w": ["h1", "h2"]},
                     f"{acc.lower()}_slices": {"s": [["a", "b"],
                                                     ["c", "d"]]},
                     "head_port": 7000},
        "auth": {"ssh_user": "ubuntu", "ssh_private_key": "~/k.pem",
                 "ssh_port": 2222},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1}},
            "w": {"resources": {"CPU": 4}, "min_workers": 1,
                  "max_workers": 2, "setup_commands": "echo w"},
            "s": {"resources": {acc: 8, "slice-8": 1},
                  "max_workers": 2, "hosts_per_slice": 2},
        },
        "file_mounts": {"/remote/a": "/local/a"},
        "setup_commands": ["echo all"],
        "worker_setup_commands": "echo worker",
        "env": {"K": "V"},
        "idle_timeout_s": 30,
    }


def _plain(spec, pkg):
    d = dataclasses.asdict(spec)
    acc = "TPU" if pkg == "jax" else "GPU"
    d["slices"] = d.pop(f"{acc.lower()}_slices")
    for t in d["node_types"].values():
        t["resources"] = {("ACC" if k == acc else k): v
                          for k, v in t["resources"].items()}
        for k in ("accelerator_type", "runtime_version", "machine_type",
                  "source_image", "spot"):
            t.pop(k, None)
    for k in ("head_start_command", "worker_start_command"):
        d[k] = d[k].replace("ray_tpu_torch.", "PKG.").replace(
            "ray_tpu.", "PKG.")
    return d


def test_parse_cluster_spec_matches_jax():
    jax = jax_spec.parse_cluster_spec(_raw("jax"))
    port = port_spec.parse_cluster_spec(_raw("port"))
    assert _plain(port, "port") == _plain(jax, "jax")
    assert port.env["RT_AUTOSCALING_ENABLED"] == "1"
    assert port.hosts_for("s") == [["a", "b"], ["c", "d"]]
    assert port.runner_type() == jax.runner_type() == "ssh"
    assert port.render_start(port.worker_start_command, address="h:1",
                             resources={"GPU": 4.0}) == \
        ("python -m ray_tpu_torch.scripts.cli start --address h:1 "
         "--resources '{\"GPU\": 4.0}'")
    assert port.worker_types()[0].name == "w"


ERRORS = {
    "missing_key": lambda r: {"cluster_name": "x"},
    "bad_provider": lambda r: {**r, "provider": {"type": "aws"}},
    "no_hosts": lambda r: {**r, "provider": {"type": "ssh",
                                             "head_host": "h0"}},
    "slice_length": lambda r: {**r, "provider": {
        **r["provider"], "SLICES": {"s": [["a", "b", "c"]]}}},
    "head_type": lambda r: {**r, "head_node_type": "nope"},
    "gcp_needs_zone": lambda r: {**r, "provider": {"type": "gcp",
                                                   "project_id": "p"}},
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_spec_validation_errors_match_jax(case):
    msgs = {}
    for pkg, mod in (("jax", jax_spec), ("port", port_spec)):
        raw = ERRORS[case](_raw(pkg))
        prov = raw.get("provider", {})
        if "SLICES" in prov:
            prov[f"{'tpu' if pkg == 'jax' else 'gpu'}_slices"] = \
                prov.pop("SLICES")
        with pytest.raises(ValueError) as ei:
            mod.parse_cluster_spec(raw)
        msgs[pkg] = str(ei.value).replace("tpu_slices", "SLICES").replace(
            "gpu_slices", "SLICES")
    assert msgs["port"] == msgs["jax"]


def test_split_slice_resources_matches_jax():
    jax = jax_remote.split_slice_resources(
        {"TPU": 8.0, "CPU": 16.0, "slice-v5e-8": 1.0}, 2)
    port = port_remote.split_slice_resources(
        {"GPU": 8.0, "CPU": 16.0, "slice-v5e-8": 1.0}, 2)
    assert port[0] == {"GPU": 4.0, "CPU": 8.0, "slice-v5e-8": 1.0}
    assert port[1] == {"GPU": 4.0, "CPU": 8.0}
    rename = [{("TPU" if k == "GPU" else k): v for k, v in s.items()}
              for s in port]
    assert rename == jax


def test_subprocess_runner_matches_jax(tmp_path):
    out = {}
    for pkg, mod in (("jax", jax_runner), ("port", port_runner)):
        r = mod.SubprocessCommandRunner()
        res = [r.run("echo hello").strip(),
               r.run("echo $RT_TEST_VAR", env={"RT_TEST_VAR": "42"}).strip()]
        with pytest.raises(mod.CommandRunnerError) as ei:
            r.run("echo boom; exit 3")
        res.append((ei.value.returncode, ei.value.output.strip()))
        src = tmp_path / f"{pkg}.txt"
        src.write_text("data")
        dst = tmp_path / pkg / "sub" / "b.txt"
        r.put(str(src), str(dst))
        r.put(str(dst), str(dst))   # onto itself: a no-op
        res.append(dst.read_text())
        out[pkg] = res
    assert out["port"] == out["jax"] == ["hello", "42", (3, "boom"), "data"]


def test_ssh_runner_command_shapes_match_jax(monkeypatch):
    """The ssh/rsync argv for run and put, captured, not executed."""
    seen = {}
    for pkg, mod in (("jax", jax_runner), ("port", port_runner)):
        calls = []

        def fake_run(argv, **kw):
            calls.append(argv)
            return subprocess.CompletedProcess(argv, 0, "ok\n")

        monkeypatch.setattr(mod.subprocess, "run", fake_run)
        monkeypatch.setattr(mod.shutil, "which", lambda _n: "/bin/rsync")
        r = mod.SSHCommandRunner("10.0.0.5", user="ubuntu",
                                 key_file="/keys/k.pem", port=2222)
        assert r.run("echo hi", env={"A": "1 2"}) == "ok\n"
        r.put("/local/file", "~/dir/file")
        r.run_background("sleep 9", log_file="/tmp/x.log")
        seen[pkg] = (r._ssh_base(), r._target(), calls)
    assert seen["port"] == seen["jax"]
    base, target, calls = seen["port"]
    assert base[0] == "ssh" and "2222" in base and "/keys/k.pem" in base
    assert target == "ubuntu@10.0.0.5"
    assert calls[0][-1] == "A='1 2' echo hi"
    assert calls[1][-1] == "mkdir -p ~/dir" and calls[2][0] == "rsync"


def test_pod_runner_fans_out_like_jax():
    out = {}
    for pkg, mod, var in (("jax", jax_runner, "RT_TPU_WORKER_ID"),
                          ("port", port_runner, "RT_GPU_WORKER_ID")):
        pod = mod.PodCommandRunner(
            [mod.SubprocessCommandRunner(f"h{i}") for i in range(3)])
        outs = pod.run_per_host(
            f"echo ${var}", per_host_env=[{var: str(i)} for i in range(3)])
        with pytest.raises(mod.CommandRunnerError):
            pod.run_per_host(f"test ${var} != 1",
                             per_host_env=[{var: str(i)}
                                           for i in range(3)])
        out[pkg] = ([o.strip() for o in outs], pod.host)
    assert out["port"] == out["jax"] == (["0", "1", "2"], "h0,h1,h2")


# ------------------------------------------- rt up / exec / down (CLI)
def _alive_nodes(address):
    import asyncio

    from ray_tpu_torch.core.rpc import RpcClient

    async def go():
        cli = RpcClient(address, tag="test")
        try:
            return await asyncio.wait_for(cli.call("list_nodes", {}), 10.0)
        finally:
            await cli.close()

    return [n for n in asyncio.run(go()) if n["alive"]]


def _alive(pid):
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except (ProcessLookupError, OSError):
        return False


def test_rt_up_exec_down(tmp_path, monkeypatch):
    from ray_tpu_torch.autoscaler import commands
    from ray_tpu_torch.autoscaler.cluster_spec import load_cluster_spec
    from ray_tpu_torch.autoscaler.remote_provider import RemoteNodeProvider

    monkeypatch.setenv("RT_SESSION_DIR_ROOT", str(tmp_path))
    name = f"uptest_{os.getpid()}"
    spec = {
        "cluster_name": name,
        "provider": {"type": "subprocess", "head_port": 0},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1, "GPU": 0}},
            "cpu_worker": {"resources": {"CPU": 1, "GPU": 0},
                           "min_workers": 1, "max_workers": 2},
            "gpu_slice": {"resources": {"GPU": 8, "slice-h100-16": 1},
                          "min_workers": 0, "max_workers": 1,
                          "hosts_per_slice": 2},
        },
        "env": {"PYTHONPATH": str(ROOT)},
        "idle_timeout_s": 600,
    }
    path = tmp_path / "cluster.yaml"
    path.write_text(json.dumps(spec))   # JSON is YAML
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def rt(*args):
        return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                              capture_output=True, text=True, env=env,
                              timeout=180, cwd=tmp_path)

    r = rt("up", str(path))
    assert r.returncode == 0, r.stderr + r.stdout
    address = [ln.split("=", 1)[1] for ln in r.stdout.splitlines()
               if ln.startswith("RT_ADDRESS=")][0]
    assert "autoscaler: running on head" in r.stdout
    state = commands.load_cluster_state(name)
    head_pids = state["head_pids"]
    try:
        assert len(state["launched"]) == 1
        _wait(lambda: len(_alive_nodes(address)) >= 2, 60, "min worker")
        # The head's scaling loop came up and adopted the min worker.
        log = commands.autoscaler_log(load_cluster_spec(str(path)))
        _wait(lambda: os.path.exists(log) and os.path.getsize(log) > 0,
              30, "autoscaler log")
        time.sleep(2.0)
        assert len(_alive_nodes(address)) == 2
        r = rt("exec", str(path), "echo from-head")
        assert r.returncode == 0 and r.stdout.strip() == "from-head", \
            r.stderr
        r = rt("exec", str(path), "--all-nodes", "echo node")
        assert r.stdout.split() == ["node", "node"], r.stderr
        # A two-host GPU slice, launched atomically: GPUs split, the
        # slice label on host 0.
        provider = RemoteNodeProvider(load_cluster_spec(str(path)), address)
        pid = provider.create_node("gpu_slice",
                                   {"GPU": 8, "slice-h100-16": 1})
        _wait(lambda: len(_alive_nodes(address)) >= 4, 60, "slice hosts")
        gpu = [n for n in _alive_nodes(address) if n["resources"].get("GPU")]
        assert [n["resources"]["GPU"] for n in gpu] == [4.0, 4.0]
        assert sum(1 for n in gpu
                   if n["resources"].get("slice-h100-16")) == 1
        provider.terminate_node(pid)
        _wait(lambda: len(_alive_nodes(address)) == 2, 60, "slice exit")
    finally:
        r = rt("down", str(path))
    assert r.returncode == 0 and "torn down" in r.stdout, r.stderr
    _wait(lambda: not any(_alive(p) for p in head_pids), 30, "head exit")
    assert commands.load_cluster_state(name) is None
    ps = subprocess.run(["pgrep", "-f", f"rt_cluster_{name}"],
                        capture_output=True, text=True)
    assert ps.stdout.strip() == "", "the head's scaling loop survived"
