"""The port's runtime (``ray_tpu_torch.core``) against the JAX package's.

The same programs run through ``ray_tpu`` and ``ray_tpu_torch``, in
local and in cluster mode, each runtime shut down before the other
starts; the parity is equal values and the same error classes by name.
Then the accelerator ledger (JAX ``num_tpus=2`` with
``TPU_VISIBLE_CHIPS`` against the port's ``num_gpus=2`` with
``CUDA_VISIBLE_DEVICES``, explicit counts on the CPU), placement groups
on a two-node ``cluster_utils.Cluster``, GPU detection, tensors through
the object store, the vendored pickler with ``cloudpickle`` absent, and
what a fresh worker imports.
"""

import importlib
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _error(e: BaseException):
    return (type(e).__name__, [c.__name__ for c in type(e).__mro__
                               if c.__module__ != "builtins"][1:3])


def _programs(rt, pkg: str, mode: str) -> dict:
    """The shared programs; every value is plain Python."""
    out = {}

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def total(refs):
        m = importlib.import_module(pkg)
        return sum(m.get(refs))

    out["nested"] = rt.get(total.remote([inc.remote(i) for i in range(4)]))
    out["chained"] = rt.get(double.remote(inc.remote(double.remote(3))))
    arr = np.arange(12.0).reshape(3, 4)
    out["put"] = rt.get(rt.put(arr)).tolist()
    out["put_refs_in_task"] = rt.get(total.remote([rt.put(1), rt.put(2)]))
    out["lambda"] = rt.get(rt.remote(lambda x: x * 3).remote(5))

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start
            self.seen = []

        def add(self, k):
            self.n += k
            self.seen.append(k)
            return self.n

        def order(self):
            return self.seen

    c = Counter.remote(10)
    out["actor_values"] = rt.get([c.add.remote(k) for k in range(6)])
    out["actor_order"] = rt.get(c.order.remote())
    named = Counter.options(name="parity-counter").remote(100)
    out["named"] = rt.get(rt.get_actor("parity-counter").add.remote(1))

    @rt.remote
    def boom():
        raise ValueError("boom 7")

    try:
        rt.get(boom.remote())
    except Exception as e:  # noqa: BLE001
        out["task_error"] = (_error(e), isinstance(e, ValueError),
                             "boom 7" in str(e),
                             type(e.cause).__name__)
    rt.kill(c)
    deadline = time.monotonic() + 60
    while "after_kill" not in out and time.monotonic() < deadline:
        try:        # a call may still land before the kill does
            rt.get(c.add.remote(1), timeout=60)
            time.sleep(0.1)
        except Exception as e:  # noqa: BLE001
            out["after_kill"] = _error(e)
    rt.kill(named)

    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    out["stream"] = [rt.get(r) for r in gen.remote(5)]
    if mode == "cluster":
        @rt.remote
        def slow(s):
            time.sleep(s)
            return s

        fast, late = inc.remote(1), slow.remote(30.0)
        rt.get(fast, timeout=120)
        ready, rest = rt.wait([fast, late], num_returns=2, timeout=0.5)
        out["wait"] = (ready == [fast], rest == [late])
        try:
            rt.get(late, timeout=0.2)
        except Exception as e:  # noqa: BLE001
            out["get_timeout"] = (_error(e), isinstance(e, TimeoutError))
        rt.cancel(late, force=True)
        try:
            rt.get(late, timeout=60)
        except Exception as e:  # noqa: BLE001
            out["cancelled"] = _error(e)
    return out


def _run(pkg: str, mode: str) -> dict:
    rt = importlib.import_module(pkg)
    rt.init(mode=mode, **({"num_cpus": 4} if mode == "cluster" else {}))
    try:
        return _programs(rt, pkg, mode)
    finally:
        rt.shutdown()


@pytest.fixture(scope="module", params=["local", "cluster"])
def parity(request):
    return {pkg: _run(pkg, request.param) for pkg in PACKAGES}


@pytest.mark.parametrize("key", [
    "nested", "chained", "put", "put_refs_in_task", "lambda",
    "actor_values", "actor_order", "named", "task_error", "after_kill",
    "stream", "wait", "get_timeout", "cancelled"])
def test_programs_agree_with_the_jax_runtime(parity, key):
    jax_out, port_out = parity["ray_tpu"], parity["ray_tpu_torch"]
    assert (key in jax_out) == (key in port_out)
    if key in jax_out:
        assert port_out[key] == jax_out[key]


def test_programs_give_the_expected_values(parity):
    out = parity["ray_tpu_torch"]
    assert out["nested"] == 10 and out["chained"] == 14
    assert out["actor_order"] == list(range(6))
    assert out["task_error"][1:] == (True, True, "ValueError")
    assert out["after_kill"][0] == "ActorDiedError"
    assert out["stream"] == [0, 10, 20, 30, 40]


# ------------------------------------------------------ accelerator ledger
class _Holder:
    def ids(self):
        import os

        return (os.environ.get("TPU_VISIBLE_CHIPS"),
                os.environ.get("CUDA_VISIBLE_DEVICES"))


def _leases_returned(pkg: str) -> None:
    """Wait until the agent holds no lease: the owner has handed back the
    lease it kept for reuse (``lease_keepalive_s``)."""
    state = importlib.import_module(pkg + ".util.state")
    deadline = time.monotonic() + 30
    while any(n["leases"] for n in state.list_leases()):
        assert time.monotonic() < deadline, state.list_leases()
        time.sleep(0.02)


def _ledger(pkg: str) -> dict:
    """Lease sequences on a node with 2 accelerators.  The port runs
    without prestarted workers, so a lease adopts a worker that served
    an earlier one or starts a new one.  (The JAX agent keeps its pool:
    without it a later lease adopts a worker that still carries an
    earlier lease's TPU_VISIBLE_CHIPS.)"""
    rt = importlib.import_module(pkg)
    key = "num_tpus" if pkg == "ray_tpu" else "num_gpus"
    var = 0 if pkg == "ray_tpu" else 1
    config = {} if pkg == "ray_tpu" else {"worker_prestart": 0}
    rt.init(mode="cluster", num_cpus=6, config=config, **{key: 2})
    out = {}
    try:
        one = rt.remote(**{key: 1})(_Holder)
        a, b = one.remote(), one.remote()
        out["first_two"] = [rt.get(h.ids.remote(), timeout=120)[var]
                            for h in (a, b)]
        c = one.remote()
        pending = c.ids.remote()
        out["third_pending"] = rt.wait([pending], timeout=1.0)[0] == []
        rt.kill(a)
        out["third_after_kill"] = rt.get(pending, timeout=120)[var]
        rt.kill(b)
        rt.kill(c)
        d = rt.remote(**{key: 2})(_Holder).remote()
        out["two_after_release"] = rt.get(d.ids.remote(), timeout=120)[var]
        rt.kill(d)

        @rt.remote(**{key: 1})
        def on_lease():
            import os

            return os.getpid(), (os.environ.get("TPU_VISIBLE_CHIPS"),
                                 os.environ.get("CUDA_VISIBLE_DEVICES"))

        @rt.remote
        def after_lease():
            import os

            return os.getpid(), (os.environ.get("TPU_VISIBLE_CHIPS"),
                                 os.environ.get("CUDA_VISIBLE_DEVICES"))

        pid, seen = rt.get(on_lease.remote(), timeout=120)
        out["task_lease"] = seen[var]
        _leases_returned(pkg)
        later = [rt.get(after_lease.remote(), timeout=120)
                 for _ in range(4)]
        out["reused_pid"] = any(p == pid for p, _s in later)
        out["later_vars"] = sorted({s[var] or "" for _p, s in later})
        _leases_returned(pkg)
        # The other way round: a lease for the other id finds only
        # workers bound elsewhere (CPU work, id 1) idle.
        pid_other, seen = rt.get(on_lease.remote(), timeout=120)
        out["gpu_after_cpu"] = (
            pid_other in {p for p, _s in later} | {pid}, seen[var])
        _leases_returned(pkg)
        pid_again, seen = rt.get(on_lease.remote(), timeout=120)
        out["same_ids_reuse"] = (pid_again == pid, seen[var])
        _leases_returned(pkg)
        # The halves run in workers of an env of their own: the JAX
        # agent would otherwise hand them a pooled worker that still
        # carries an earlier lease's TPU_VISIBLE_CHIPS (under load, its
        # fresh workers not ready yet).
        half = rt.remote(**{key: 0.5}, runtime_env={
            "env_vars": {"LEDGER_HALVES": "1"}})(_Holder)
        e, f = half.remote(), half.remote()
        out["halves"] = [rt.get(h.ids.remote(), timeout=120)[var]
                         for h in (e, f)]
        rt.kill(e)
        rt.kill(f)
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def ledgers():
    return {pkg: _ledger(pkg) for pkg in PACKAGES}


@pytest.mark.parametrize("key", ["first_two", "third_pending",
                                 "third_after_kill", "two_after_release",
                                 "task_lease"])
def test_accelerator_ids_follow_the_jax_ledger(ledgers, key):
    assert ledgers["ray_tpu_torch"][key] == ledgers["ray_tpu"][key]


def test_the_ledger_sequence(ledgers):
    port = ledgers["ray_tpu_torch"]
    assert port["first_two"] == ["0", "1"]
    assert port["third_pending"] is True
    assert port["third_after_kill"] == "0"
    # Freed ids go back on the end of the free list, as chips do.
    assert port["two_after_release"] == "1,0"


def test_two_half_gpus_share_one_id(ledgers):
    """The port puts both shares on one id; the JAX ledger gives a
    fractional TPU lease no chip at all (the variable stays unset)."""
    assert ledgers["ray_tpu_torch"]["halves"] == ["0", "0"]
    assert ledgers["ray_tpu"]["halves"] == [None, None]


def test_a_gpu_leased_worker_is_never_reused(ledgers):
    """CUDA keeps the devices it saw at initialisation, so the port
    binds a worker to the GPU ids of its first lease: CPU leases run in
    other workers and see an empty CUDA_VISIBLE_DEVICES.  (The JAX
    agent may return such a worker to its pool, where it keeps its
    TPU_VISIBLE_CHIPS.)"""
    port = ledgers["ray_tpu_torch"]
    assert port["task_lease"] == "1"
    assert port["reused_pid"] is False
    assert port["later_vars"] == [""]


def test_a_worker_is_reused_only_for_the_same_gpu_ids(ledgers):
    """A lease for id 0 after CPU work and an id-1 lease starts a new
    worker rather than adopt one bound elsewhere (CUDA there already saw
    no GPU, or GPU 1); the next id-1 lease adopts the id-1 worker warm."""
    port = ledgers["ray_tpu_torch"]
    assert port["gpu_after_cpu"] == (False, "0")
    assert port["same_ids_reuse"] == (True, "1")


# ------------------------------------------------------- placement groups
def _placement(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    cu = importlib.import_module(pkg + ".cluster_utils")
    util = importlib.import_module(pkg + ".util")
    c = cu.Cluster(head_node_args={"num_cpus": 2})
    c.add_node(num_cpus=2)
    out = {}
    try:
        rt.init(address=c.address)
        c.wait_for_nodes()

        @rt.remote(num_cpus=1)
        def where():
            import os

            return os.environ["RT_NODE_ID"]

        for strategy in ("PACK", "SPREAD", "STRICT_SPREAD"):
            pg = util.placement_group([{"CPU": 1}, {"CPU": 1}],
                                      strategy=strategy)
            assert pg.wait(60)
            nodes = pg.bundle_to_node()
            ran = [rt.get(where.options(
                scheduling_strategy=util.PlacementGroupSchedulingStrategy(
                    pg, i)).remote(), timeout=120) for i in range(2)]
            out[strategy] = (len(set(nodes.values())),
                             [ran[i] == nodes[i] for i in range(2)])
            util.remove_placement_group(pg)
            # The next group is placed on a free cluster, as this was.
            deadline = time.monotonic() + 60
            while rt.available_resources().get("CPU") != 4.0 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
    finally:
        rt.shutdown()
        c.shutdown()
    return out


def test_placement_groups_on_two_nodes():
    jax_out, port_out = (_placement(pkg) for pkg in PACKAGES)
    assert port_out == jax_out
    assert port_out["PACK"] == (1, [True, True])
    assert port_out["STRICT_SPREAD"] == (2, [True, True])


# ------------------------------------------------------------- unit tests
def test_gpu_detection_without_torch(tmp_path):
    from ray_tpu_torch.core.resources import detect_gpus

    proc = tmp_path / "gpus"
    proc.mkdir()
    for bus in ("0000:1b:00.0", "0000:43:00.0"):
        (proc / bus).mkdir()
    none = "libnvidia-ml-absent.so"
    assert detect_gpus(str(proc), str(tmp_path / "nv[0-9]*"), env={},
                       nvml_lib=none) == [0, 1]
    for n in ("nv0", "nv1", "nv2"):
        (tmp_path / n).touch()
    assert detect_gpus(str(tmp_path / "none"), str(tmp_path / "nv[0-9]*"),
                       env={}, nvml_lib=none) == [0, 1, 2]
    assert detect_gpus(str(proc), "", env={"CUDA_VISIBLE_DEVICES": "3,5"},
                       nvml_lib=none) == [3, 5]
    assert detect_gpus(str(proc), "", env={"CUDA_VISIBLE_DEVICES": ""},
                       nvml_lib=none) == []
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from ray_tpu_torch.core import resources; "
         "resources.node_resources(); print('torch' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.stdout.strip() == "False", out.stderr


def test_session_root_follows_tmpdir(monkeypatch, tmp_path):
    """Each TMPDIR holds its own sessions (logs, spill, profiles), and
    spawned processes get the resolved root."""
    import tempfile

    from ray_tpu_torch.core.config import RuntimeConfig

    monkeypatch.delenv("RT_SESSION_DIR_ROOT", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = RuntimeConfig.from_env()
    assert cfg.session_dir_root == str(tmp_path / "ray_tpu_torch")
    assert cfg.env_overrides()["RT_SESSION_DIR_ROOT"] == \
        cfg.session_dir_root
    assert RuntimeConfig.from_json(cfg.to_json()).session_dir_root == \
        cfg.session_dir_root


def test_explicit_gpus_override_detection(monkeypatch):
    from ray_tpu_torch.core import resources

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6,7")
    assert resources.node_resources(num_cpus=1).get("GPU") == 3.0
    assert resources.node_resources(num_cpus=1, num_gpus=2).get("GPU") == 2
    assert resources.gpu_ids(2) == [4, 6]
    assert resources.node_resources(num_cpus=1, num_gpus=0).get("GPU") == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert resources.gpu_ids(2) == [0, 1]
    with pytest.raises(ValueError):
        resources.task_resources(num_gpus=1.5)


def test_gpu_ledger_hands_out_ids_like_the_chip_ledger():
    from ray_tpu_torch.core.resources import GpuLedger

    led = GpuLedger([0, 1, 2])
    assert led.take(2) == [0, 1] and led.take(2) is None
    assert led.take(0.5) == [2] and led.take(0.5) == [2]
    assert led.take(0.25) is None
    led.release([0, 1], 2)
    assert led.take(0.25) == [0]
    led.release([2], 0.5)
    led.release([2], 0.5)
    assert led.free == [1, 2]
    led.release([0], 0.25)
    assert led.free == [1, 2, 0] and led.shared == {}


def test_serializing_other_values_leaves_torch_alone():
    code = ("import sys\n"
            "from ray_tpu_torch.core import serialization as s\n"
            "import numpy as np\n"
            "v = s.unpack(s.pack({'a': np.ones(3), 'f': lambda: 1}))\n"
            "print(v['f'](), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.stdout.split() == ["1", "False"], out.stderr


@pytest.fixture(scope="class")
def port_cluster():
    import ray_tpu_torch as rt

    rt.init(mode="cluster", num_cpus=2)
    yield
    rt.shutdown()


@pytest.mark.usefixtures("port_cluster")
class TestOnePortCluster:
    @pytest.mark.parametrize("name", ["float32", "bfloat16", "transposed",
                                      "parameter"])
    def test_tensors_through_the_object_store_bit_equal(self, name):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core import serialization

        gen = torch.Generator().manual_seed(3)
        x = torch.randn(64, 48, generator=gen)
        x = {"float32": x, "bfloat16": x.to(torch.bfloat16),
             "transposed": x.to(torch.bfloat16).t()[::2],
             "parameter": torch.nn.Parameter(x)}[name]
        payload, views = serialization.serialize({"t": x})
        assert len(views) == 1 and len(payload) < 1024   # out of band
        for back in (rt.get(rt.put(x)),
                     rt.get(rt.remote(lambda t: t).remote(x))):
            assert type(back) is type(x) and back.dtype == x.dtype
            assert back.shape == x.shape
            assert back.requires_grad == x.requires_grad
            assert torch.equal(
                back.detach().contiguous().view(torch.uint8),
                x.detach().contiguous().view(torch.uint8))

    def test_fresh_worker_imports_no_torch_jax_or_ray_tpu(self):
        """A worker of its own (a runtime env no other task uses), so no
        earlier task's tensors have pulled torch into it."""
        import ray_tpu_torch as rt

        @rt.remote
        def modules():
            import sys

            return sorted(m for m in sys.modules if m.split(".")[0] in (
                "torch", "jax", "jaxlib", "ray_tpu", "cloudpickle"))

        fresh = modules.options(
            runtime_env={"env_vars": {"FRESH_WORKER": "1"}})
        assert rt.get(fresh.remote(), timeout=120) == []


    def test_actor_creation_values_never_reach_the_control_plane(self):
        """An actor built from a model config that holds a torch dtype:
        its creation values travel as bytes that only the worker
        decodes, so neither the controller nor the node agent maps
        libtorch, and the actor sees an equal config."""
        import ray_tpu_torch as rt

        cfg, holder = _config_holder(rt)
        got_cfg, scale, pid = rt.get(holder.view.remote(), timeout=120)
        assert got_cfg == cfg and got_cfg.dtype is torch.bfloat16
        assert scale.tolist() == [0.0, 1.0, 2.0]
        assert _control_plane_maps_torch(rt) == [False, False]
        assert _maps_torch(pid)
        rt.kill(holder)

    def test_a_restarted_actor_gets_the_same_creation_values(self):
        """Its worker killed once (the actor exits its process) under
        ``max_restarts=1``, the actor comes back
        from the controller's copy of its creation spec with the same
        arguments, and the control plane still has no libtorch."""
        import ray_tpu_torch as rt

        cfg, holder = _config_holder(rt)
        first = rt.get(holder.view.remote(), timeout=120)
        holder.die.remote()
        deadline = time.time() + 120
        while True:
            try:
                again = rt.get(holder.view.remote(), timeout=30)
                if again[2] != first[2]:
                    break
            except rt.RayTpuError:
                pass          # the old instance's death, seen first
            assert time.time() < deadline, "the actor never restarted"
            time.sleep(0.2)
        assert again[0] == cfg and again[0].dtype is torch.bfloat16
        assert again[1].tolist() == [0.0, 1.0, 2.0]
        assert _control_plane_maps_torch(rt) == [False, False]
        rt.kill(holder)


def _config_holder(rt):
    from ray_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(vocab_size=64, n_layer=1, n_head=2, d_model=16,
                     d_ff=32, max_seq=8, dtype=torch.bfloat16)

    @rt.remote(max_restarts=1)
    class Holder:
        def __init__(self, cfg, scale):
            import os

            self.cfg, self.scale, self.pid = cfg, scale, os.getpid()

        def view(self):
            return self.cfg, self.scale, self.pid

        def die(self):
            import os

            os._exit(1)

    return cfg, Holder.remote(cfg, scale=np.arange(3.0))


def _maps_torch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def _control_plane_maps_torch(rt) -> list:
    """Whether the controller and the node agent map libtorch."""
    from ray_tpu_torch.core import runtime as runtime_mod

    control = [p.pid for p in runtime_mod.get_runtime()._procs]
    assert len(control) == 2
    return [_maps_torch(pid) for pid in control]


def test_pickler_without_cloudpickle_installed(tmp_path):
    """Closures, lambdas and ``__main__`` classes reach workers through
    the vendored pickler in a cluster where ``import cloudpickle``
    fails in the driver and in every process it starts."""
    shadow = tmp_path / "shadow" / "cloudpickle"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text(
        "raise ImportError('cloudpickle is not installed here')\n")
    script = tmp_path / "driver.py"
    script.write_text(textwrap.dedent("""
        import ray_tpu_torch as rt

        class Box:
            def __init__(self, v):
                self.v = v

            def twice(self):
                return Box(2 * self.v)

        def make_adder(k):
            return lambda x: x + k

        rt.init(mode="cluster", num_cpus=2)
        try:
            add3 = make_adder(3)

            @rt.remote
            def apply(f, box):
                try:
                    import cloudpickle  # noqa: F401
                    return "importable"
                except ImportError:
                    return f(box.twice().v)

            @rt.remote
            class Holder:
                def __init__(self, box):
                    self.box = box

                def get(self):
                    try:
                        import cloudpickle  # noqa: F401
                        return "importable"
                    except ImportError:
                        return type(self.box).__name__, self.box.v

            got = rt.get(apply.remote(add3, Box(4)), timeout=120)
            held = rt.get(Holder.remote(Box(9)).get.remote(), timeout=120)
            print("RESULT", got, held)
        finally:
            rt.shutdown()
    """))
    env = dict(os.environ, PYTHONPATH=f"{shadow.parent}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=180,
                         env=env)
    assert "RESULT 11 ('Box', 9)" in out.stdout, out.stderr[-3000:]


def test_pool_object_store_raises():
    """The native pool is the port's store now (the JAX package's
    default too); it raises what JAX's raises: FileNotFoundError for an
    object it does not hold, OSError for one its slab cannot take."""
    import ray_tpu_torch as rt

    assert rt.core.config.RuntimeConfig.from_env() \
        .object_store_backend == "pool"
    seen = {}
    for pkg, name in (("ray_tpu", "/rtpool_"), ("ray_tpu_torch",
                                                "/rttpool_")):
        store_mod = importlib.import_module(pkg + ".core.object_store")
        ids = importlib.import_module(pkg + ".core.ids")
        session = f"raises_{os.getpid()}_{os.urandom(3).hex()}"
        store = store_mod.PoolObjectStore(session, 1 << 20)   # 4 MiB slab
        store.SEAL_PRESSURE_TIMEOUT_S = 0.2
        errors = []
        try:
            oid = ids.ObjectID(os.urandom(16))
            for attempt in (lambda: store.get(oid, 8),
                            lambda: store.read_raw(oid, 8),
                            lambda: store.put_raw(oid, bytes(5 << 20)),
                            lambda: store.create_and_seal(
                                oid, np.zeros(5 << 17))):
                try:
                    attempt()
                    errors.append(None)
                except Exception as e:  # noqa: BLE001 — compared below
                    errors.append(type(e).__name__)
            store.put_raw(oid, b"x" * 100)
            store.delete(oid)
            try:
                store.read_raw(oid, 100)
                errors.append(None)
            except FileNotFoundError:
                errors.append("FileNotFoundError")
        finally:
            store.close()
            importlib.import_module(pkg + "._native.shm_pool") \
                .ShmPool.unlink(name + session)
        seen[pkg] = errors
    assert seen["ray_tpu_torch"] == seen["ray_tpu"] == [
        "FileNotFoundError", "FileNotFoundError", "OSError", "OSError",
        "FileNotFoundError"]


def test_later_slices_raise(tmp_path, monkeypatch):
    """What the later slices ported behaves as in the JAX package, where
    a test used to see it raise: an unreachable ``rt://`` address raises
    the RPC layer's connection error, ``rt up`` of a missing spec raises
    FileNotFoundError and ``rt dashboard`` with no cluster exits 1, in
    both packages.  pip/uv envs normalize, ``init(address="auto")``
    looks for the CLI's record (and says when there is none), and an
    actor method binds into a DAG node."""
    import socket

    import ray_tpu
    import ray_tpu.client.runtime as jax_client
    import ray_tpu.core.rpc as jax_rpc
    import ray_tpu_torch as rt
    import ray_tpu_torch.client.runtime as port_client
    import ray_tpu_torch.core.rpc as port_rpc
    from ray_tpu.scripts import cli as jax_cli
    from ray_tpu_torch import runtime_env
    from ray_tpu_torch.dag import ClassMethodNode
    from ray_tpu_torch.scripts import cli

    monkeypatch.setenv("RT_SESSION_DIR_ROOT", str(tmp_path))
    monkeypatch.delenv("RT_ADDRESS", raising=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for pkg, client, rpc in ((ray_tpu, jax_client, jax_rpc),
                             (rt, port_client, port_rpc)):
        real = client.RpcClient     # 1 s, not 30 s, to find it closed
        monkeypatch.setattr(client, "RpcClient", lambda addr, real=real,
                            **kw: real(addr, **{**kw,
                                                "connect_timeout": 1.0}))
        with pytest.raises(rpc.RpcError, match="cannot connect"):
            pkg.init(address=f"rt://127.0.0.1:{port}")
        assert not pkg.is_initialized()
    for main in (jax_cli.main, cli.main):
        with pytest.raises(FileNotFoundError):
            main(["up", str(tmp_path / "cluster.yaml")])
        assert main(["dashboard"]) == 1
    assert runtime_env.normalize({"pip": ["requests"]}) == \
        {"pip": ["requests"]}
    with pytest.raises(ConnectionError, match="no running cluster"):
        rt.init(address="auto")
    assert not rt.is_initialized()
    rt.init(mode="local")
    try:
        @rt.remote
        class A:
            def f(self):
                return 1

        assert isinstance(A.remote().f.bind(), ClassMethodNode)
    finally:
        rt.shutdown()


