"""The port's GPU-VM provider (``autoscaler/gcp_provider.py``) against a
stub Compute Engine surface — hermetic 0 -> N -> 0.

Modelled on tests/test_gcp_provider.py's ``FakeTpuApi``: instances go
PROVISIONING -> RUNNING after a short delay, zone operations complete,
deletes remove instances, and a Spot VM can be marked TERMINATED
(preempted).  The stub is the provider's transport, so no request
leaves the process: every URL it sees is checked to be the stub's own
base or the metadata server's token URL, which the stub answers too.
The agents the provider bootstraps are real: ``provider.bootstrap_runner:
subprocess`` starts them on this machine, joining one port cluster.
"""

import asyncio
import json
import os
import re
import threading
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import commands as rt_commands
from ray_tpu_torch.autoscaler.cluster_spec import parse_cluster_spec
from ray_tpu_torch.autoscaler.gcp_provider import (METADATA_TOKEN_URL,
                                                   ComputeApi, GcpApiError,
                                                   GCPGpuNodeProvider)
from ray_tpu_torch.core.rpc import RpcClient

ROOT = Path(__file__).resolve().parent.parent
BASE = "https://compute.stub.invalid/compute/v1"


class FakeCompute:
    """In-memory Compute Engine zone: the provider's transport."""

    def __init__(self, ready_delay=0.2, op_delay=0.1, page_size=2):
        self.instances = {}        # name -> dict
        self.ops = {}              # op name -> done_at
        self.bodies = []           # insert request bodies
        self.auth = []             # Authorization headers seen
        self.urls = []
        self.ready_delay = ready_delay
        self.op_delay = op_delay
        self.page_size = page_size
        self.create_calls = 0
        self.delete_calls = 0
        self.lock = threading.RLock()
        self._n = 0

    def _op(self, kind):
        with self.lock:
            self._n += 1
            name = f"op-{self._n}"
        self.ops[name] = time.time() + self.op_delay
        return {"name": name, "status": "RUNNING", "operationType": kind}

    def _tick(self, inst):
        if inst["status"] == "PROVISIONING" and \
                time.time() >= inst["ready_at"]:
            inst["status"] = "RUNNING"
            inst["networkInterfaces"] = [
                {"networkIP": f"10.0.0.{len(self.instances) + 1}"}]
        return {k: v for k, v in inst.items() if k != "ready_at"}

    def __call__(self, method, url, headers, body):
        self.urls.append(url)
        if url == METADATA_TOKEN_URL:
            assert headers.get("Metadata-Flavor") == "Google"
            return 200, json.dumps({"access_token": "vm-token"}).encode()
        assert url.startswith(BASE + "/projects/p/zones/z/"), url
        self.auth.append(headers.get("Authorization"))
        path = url[len(BASE) + len("/projects/p/zones/z/"):]
        with self.lock:
            return self._route(method, path, body)

    def _reply(self, code, obj):
        return code, json.dumps(obj).encode()

    def _route(self, method, path, body):
        if method == "POST" and path == "instances":
            req = json.loads(body)
            self.bodies.append(req)
            if req["name"] in self.instances:
                return self._reply(409, {"error": "alreadyExists"})
            self.create_calls += 1
            self.instances[req["name"]] = {
                "name": req["name"], "status": "PROVISIONING",
                "labels": req.get("labels") or {},
                "machineType": req["machineType"],
                "ready_at": time.time() + self.ready_delay}
            return self._reply(200, self._op("insert"))
        m = re.fullmatch(r"operations/([\w-]+)", path)
        if method == "GET" and m:
            done_at = self.ops.get(m.group(1))
            if done_at is None:
                return self._reply(404, {"error": "no such op"})
            return self._reply(200, {
                "name": m.group(1),
                "status": "DONE" if time.time() >= done_at else "RUNNING"})
        m = re.fullmatch(r"instances(\?pageToken=(\d+))?", path)
        if method == "GET" and m:
            start = int(m.group(2) or 0)
            names = sorted(self.instances)
            page = names[start:start + self.page_size]
            out = {"items": [self._tick(self.instances[n]) for n in page]}
            if start + self.page_size < len(names):
                out["nextPageToken"] = str(start + self.page_size)
            return self._reply(200, out)
        m = re.fullmatch(r"instances/([\w-]+)", path)
        if m:
            name = m.group(1)
            if name not in self.instances:
                return self._reply(404, {"error": "notFound"})
            if method == "GET":
                return self._reply(200, self._tick(self.instances[name]))
            if method == "DELETE":
                self.delete_calls += 1
                del self.instances[name]
                return self._reply(200, self._op("delete"))
        return self._reply(404, {"error": f"bad path {path}"})

    def preempt(self, name):
        with self.lock:
            self.instances[name]["status"] = "TERMINATED"


def _raw_spec(**provider):
    return {
        "cluster_name": "gputest",
        "provider": {"type": "gcp", "project_id": "p", "zone": "z",
                     "api_base": BASE, "access_token": "tok",
                     "bootstrap_runner": "subprocess",
                     "poll_interval_s": 0.05, "create_timeout_s": 30,
                     "head_port": 0, "head_host": "localhost",
                     **provider},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1}},
            "h100": {"resources": {"CPU": 1, "GPU": 1},
                     "min_workers": 0, "max_workers": 2,
                     "machine_type": "a3-highgpu-1g", "spot": True},
        },
        "env": {"PYTHONPATH": str(ROOT)},
        "idle_timeout_s": 600,
    }


@pytest.fixture
def fake(monkeypatch):
    """The stub replaces the HTTP layer of every ComputeApi made here,
    also those that rt_commands builds."""
    from ray_tpu_torch.autoscaler import gcp_provider

    fake = FakeCompute()
    monkeypatch.setattr(gcp_provider, "urllib_transport", fake)
    yield fake
    assert all(u.startswith(BASE) or u == METADATA_TOKEN_URL
               for u in fake.urls)


@pytest.fixture(scope="module")
def address(tmp_path_factory):
    """One port head (CPU only) the stub's VMs join; scalable, so its
    agent holds infeasible demand for the scaling loop."""
    root = tmp_path_factory.mktemp("gpu_provider")
    saved = {k: os.environ.get(k) for k in ("RT_AUTOSCALING_ENABLED",
                                            "RT_SESSION_DIR_ROOT")}
    os.environ.update(RT_AUTOSCALING_ENABLED="1",
                      RT_SESSION_DIR_ROOT=str(root))
    rt = ray_tpu_torch.init(mode="cluster", num_cpus=1, num_gpus=0)
    yield rt.controller_addr
    ray_tpu_torch.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _alive_nodes():
    return [n for n in ray_tpu_torch.nodes() if n["Alive"]]


def _until(pred, timeout=60, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.2)
    raise TimeoutError(what)


# ----------------------------------------------------------- API client
def test_api_client_create_wait_list_delete(fake):
    spec = parse_cluster_spec(_raw_spec())
    api = ComputeApi("p", "z", api_base=BASE, access_token="tok",
                     transport=fake)
    names = [f"n-{i}" for i in range(3)]
    for n in names:
        op = api.create_instance(api.instance_body(
            n, spec.node_types["h100"], {"rt-cluster": "gputest"}))
        assert api.wait_operation(op, timeout=10, poll_s=0.05)["status"] \
            == "DONE"
    _until(lambda: api.get_instance("n-0")["status"] == "RUNNING", 10)
    assert api.get_instance("n-0")["networkInterfaces"][0]["networkIP"]
    # Three instances over pages of two.
    assert sorted(i["name"] for i in api.list_instances()) == names
    for n in names:
        api.wait_operation(api.delete_instance(n), timeout=10, poll_s=0.05)
    with pytest.raises(GcpApiError) as ei:
        api.get_instance("n-0")
    assert ei.value.status == 404
    assert set(fake.auth) == {"Bearer tok"}


def test_instance_body_is_an_h100_vm_spot_where_asked(fake):
    raw = _raw_spec()
    raw["available_node_types"]["ondemand"] = {
        "resources": {"GPU": 1}, "machine_type": "a3-highgpu-1g",
        "source_image": "projects/p/global/images/img"}
    spec = parse_cluster_spec(raw)
    api = ComputeApi("p", "z", api_base=BASE, transport=fake)
    spot = api.instance_body("a", spec.node_types["h100"])
    assert spot["machineType"] == "zones/z/machineTypes/a3-highgpu-1g"
    assert spot["scheduling"] == {
        "onHostMaintenance": "TERMINATE", "automaticRestart": False,
        "provisioningModel": "SPOT", "instanceTerminationAction": "STOP"}
    plain = api.instance_body("b", spec.node_types["ondemand"])
    assert plain["scheduling"] == {"onHostMaintenance": "TERMINATE",
                                   "automaticRestart": True}
    assert plain["disks"][0]["initializeParams"]["sourceImage"] == \
        "projects/p/global/images/img"
    # Without a token the VM's service-account token is used.
    api.list_instances()
    assert fake.auth[-1] == "Bearer vm-token"
    assert METADATA_TOKEN_URL in fake.urls


def test_queued_resources_are_rejected_at_parse():
    with pytest.raises(ValueError, match="no queued resources"):
        parse_cluster_spec(_raw_spec(use_queued_resources=True))
    assert parse_cluster_spec(_raw_spec(use_queued_resources=False))
    raw = _raw_spec()
    del raw["provider"]["zone"]
    with pytest.raises(ValueError, match="provider.zone"):
        parse_cluster_spec(raw)


def test_machine_type_is_required(fake):
    raw = _raw_spec()
    del raw["available_node_types"]["h100"]["machine_type"]
    provider = GCPGpuNodeProvider(parse_cluster_spec(raw), "h:1")
    with pytest.raises(ValueError, match="machine_type"):
        provider.create_node("h100", {"GPU": 1})
    assert fake.create_calls == 0


# ------------------------------------------------- provider + autoscaler
def test_provider_creates_bootstraps_and_deletes(fake, address):
    provider = GCPGpuNodeProvider(parse_cluster_spec(_raw_spec()), address)
    pid = provider.create_node("h100", {"CPU": 1, "GPU": 1})
    assert fake.create_calls == 1
    assert provider.non_terminated_nodes() == [pid]
    assert provider.node_cluster_id(pid)
    assert provider.node_type_of(pid) == "h100"
    _until(lambda: len(_alive_nodes()) >= 2, what="agent registration")
    gpus = [n["Resources"].get("GPU", 0) for n in _alive_nodes()]
    assert sorted(gpus) == [0, 1.0]
    provider.terminate_node(pid)
    assert fake.delete_calls == 1 and fake.instances == {}
    assert provider.non_terminated_nodes() == []
    _until(lambda: len(_alive_nodes()) == 1, what="agent exit")


def _drive(scaler, address, predicate, max_iters=200):
    async def go():
        scaler._cli = RpcClient(address, tag="gpu-scaler")
        try:
            for _ in range(max_iters):
                r = await scaler.update()
                if predicate(r):
                    return r
                await asyncio.sleep(0.2)
        finally:
            await scaler._cli.close()
        return None

    return asyncio.new_event_loop().run_until_complete(go())


def test_autoscaler_zero_to_n_to_zero(fake, address):
    """Demand appears -> the provider creates a GPU VM -> its agent
    joins and the task runs on its GPU -> idle -> the VM is deleted."""
    scaler = rt_commands.autoscaler_from_spec(
        parse_cluster_spec(_raw_spec()), address)
    scaler.config.idle_timeout_s = 2.0

    @ray_tpu_torch.remote(num_gpus=1)
    def on_gpu():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    ref = on_gpu.remote()
    r = _drive(scaler, address, lambda r: bool(r["launched"]))
    assert r is not None, "autoscaler never launched"
    assert fake.create_calls == 1
    assert ray_tpu_torch.get(ref, timeout=120) == "0"
    del ref
    _drive(scaler, address,
           lambda r: not scaler.provider.non_terminated_nodes())
    assert scaler.provider.non_terminated_nodes() == []
    assert fake.delete_calls >= 1 and fake.instances == {}
    # The decision ring names the launch (a second one may follow while
    # the head's pending-demand report lags the first node's lease).
    assert r["launched"][0] in [p for d in scaler.decisions
                                for p in d["launched"]]


def test_preempted_vm_is_reaped_and_replaced(fake, address):
    """A Spot VM the cloud reports TERMINATED is untracked and deleted
    and its agent killed; the next GPU demand launches a replacement."""
    scaler = rt_commands.autoscaler_from_spec(
        parse_cluster_spec(_raw_spec()), address)

    @ray_tpu_torch.remote(num_gpus=1)
    def on_gpu():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    ref = on_gpu.remote()
    r = _drive(scaler, address, lambda r: bool(r["launched"]))
    first = r["launched"][0]
    assert ray_tpu_torch.get(ref, timeout=120) == "0"
    node = scaler.provider._nodes[first]
    agent_pids = [p for ps in node.pids_by_host.values() for p in ps]
    assert agent_pids
    fake.preempt(first)
    r = _drive(scaler, address, lambda r: bool(r["preempted"]))
    assert r["preempted"] == [first] and r["launched"] == []
    assert first not in fake.instances
    assert scaler.provider.non_terminated_nodes() == []
    _until(lambda: not any(_pid_alive(p) for p in agent_pids),
           what="preempted agent exit")
    assert any(d["preempted"] == [first] for d in scaler.decisions)
    ref = on_gpu.remote()
    r = _drive(scaler, address, lambda r: bool(r["launched"]))
    assert r["launched"][0] != first
    assert ray_tpu_torch.get(ref, timeout=120) == "0"
    for pid in scaler.provider.non_terminated_nodes():
        scaler.provider.terminate_node(pid)
    assert fake.instances == {}


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except (ProcessLookupError, OSError):
        return False


def test_adoption_after_a_restart(fake, address):
    """A second provider (the head's scaling loop after `rt up`, or a
    restart) adopts the launched VM from the state record instead of
    launching another, terminates it, and mints distinct names."""
    spec = parse_cluster_spec(_raw_spec())
    p1 = GCPGpuNodeProvider(spec, address)
    pid = p1.create_node("h100", {"CPU": 1, "GPU": 1})
    node = p1._nodes[pid]
    record = {pid: {"node_type": "h100", "unit": node.unit,
                    "node_ids": node.node_ids,
                    "pids_by_host": node.pids_by_host}}
    p2 = GCPGpuNodeProvider(spec, address)
    p2.adopt(json.loads(json.dumps(record)))
    assert p2.non_terminated_nodes() == [pid]
    assert p2.node_cluster_id(pid) == p1.node_cluster_id(pid)
    pid2 = p2.create_node("h100", {"CPU": 1, "GPU": 1})
    assert pid2 != pid and len(fake.instances) == 2
    p2.terminate_node(pid)
    p2.terminate_node(pid2)
    assert fake.instances == {}


def test_create_failure_deletes_capacity(fake, address):
    raw = _raw_spec(create_timeout_s=1.0)
    fake.ready_delay = 30.0   # stuck in PROVISIONING past the timeout
    provider = GCPGpuNodeProvider(parse_cluster_spec(raw), address)
    with pytest.raises(TimeoutError):
        provider.create_node("h100", {"CPU": 1, "GPU": 1})
    assert fake.instances == {}, "stuck VM leaked"
    assert provider.non_terminated_nodes() == []


def test_down_sweeps_unrecorded_cluster_vms(fake):
    api = ComputeApi("p", "z", api_base=BASE, access_token="tok",
                     transport=fake)
    t = parse_cluster_spec(_raw_spec()).node_types["h100"]
    for name, labels in (("gputest-h100-dead-7", {"rt-cluster": "gputest"}),
                         ("other-cluster-vm", {"rt-cluster": "elsewhere"}),
                         ("gputest-demo-h100-1",
                          {"rt-cluster": "gputest-demo"}),
                         ("gputest-legacy-unlabeled-2", None)):
        body = api.instance_body(name, t, labels)
        if labels is None:
            del body["labels"]
        api.create_instance(body)
    provider = GCPGpuNodeProvider(parse_cluster_spec(_raw_spec()), "h:1")
    assert sorted(provider.cleanup_cluster_capacity()) == [
        "gputest-h100-dead-7", "gputest-legacy-unlabeled-2"]
    assert sorted(fake.instances) == ["gputest-demo-h100-1",
                                      "other-cluster-vm"]
