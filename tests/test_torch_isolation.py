"""The port stands alone: no JAX and nothing of the JAX package.

``ray_tpu_torch``, ``chip_smoke.py``, the scripts under ``tools/`` and
the card tests (run where JAX is not installed) import ``torch`` and
numpy, never ``jax``/``flax``/``optax`` nor ``ray_tpu`` (a name that ``ray_tpu_torch`` itself starts with, so the
check matches whole dotted prefixes), nor ``msgpack`` (the card machine
lacks it; the port keeps its own codec for flax's layout), nor a
top-level ``cloudpickle`` (the card machine lacks it too; the port
imports its vendored copy as ``ray_tpu_torch._vendor.cloudpickle``),
nor ``aiohttp`` (the port's HTTP ingress is written over ``asyncio``
streams; the card machine has no aiohttp).  ``grpc`` is imported by the
gRPC ingress alone, when it starts.  The runtime's control-plane
modules (controller, node agent, worker entry) and the serve plane but
its LLM binding import no torch either.  Entry points called without a
device run on CUDA or raise.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ray_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "msgpack",
             "cloudpickle", "aiohttp")
# The serve plane's modules (the gRPC ingress imports grpc only inside
# its actor, through ``grpc_proxy.import_grpc``).
SERVE_MODULES = ("serve/__init__.py", "serve/deployment.py",
                 "serve/routes.py", "serve/resilience.py",
                 "serve/controller.py", "serve/proxy.py",
                 "serve/grpc_proxy.py", "testing/__init__.py",
                 "testing/chaos.py", "util/slo.py", "util/telemetry.py",
                 "util/state.py", "util/xprof.py", "llm/serving.py")

# The data and tune libraries.
DATA_TUNE_MODULES = ("data/__init__.py", "data/block.py", "data/context.py",
                     "data/logical.py", "data/dataset.py",
                     "data/aggregate.py", "data/grouped_data.py",
                     "data/iterator.py", "tune/__init__.py",
                     "tune/search.py", "tune/schedulers.py",
                     "tune/tuner.py")

# The operator's path: the native pool, pip/uv envs, channels and DAGs,
# state, doctor and the rt CLI.
OPERATOR_MODULES = ("_native/__init__.py", "_native/shm_pool.py",
                    "runtime_env/pip.py", "runtime_env/pip_bootstrap.py",
                    "runtime_env/uv.py", "runtime_env/uv_bootstrap.py",
                    "experimental/__init__.py", "experimental/channel.py",
                    "dag/__init__.py", "util/doctor.py",
                    "scripts/__init__.py", "scripts/cli.py",
                    "__main__.py")

# The last modules: jobs, the rt:// client, the dashboard (and the
# HTTP/1.1 layer it shares with the serve ingress), the autoscaler and
# launcher, the control-plane benchmarks.
FLEET_MODULES = ("job/__init__.py", "job/supervisor.py", "job/client.py",
                 "client/__init__.py", "client/session_host.py",
                 "client/server.py", "client/runtime.py",
                 "dashboard/__init__.py", "dashboard/__main__.py",
                 "autoscaler/__init__.py", "autoscaler/node_provider.py",
                 "autoscaler/fake_provider.py", "autoscaler/autoscaler.py",
                 "autoscaler/sdk.py", "autoscaler/cluster_spec.py",
                 "autoscaler/command_runner.py",
                 "autoscaler/remote_provider.py", "autoscaler/commands.py",
                 "autoscaler/gcp_provider.py", "util/perf_ledger.py",
                 "util/microbenchmark.py", "util/scale_bench.py",
                 "util/http11.py")

# The RL stack and the graft-entry counterpart.
RL_MODULES = ("rl/__init__.py", "rl/rl_module.py", "rl/convert.py",
              "rl/connectors.py", "rl/learner.py", "rl/actor_manager.py",
              "rl/env_runner.py", "rl/algorithm.py", "rl/multi_agent.py",
              "rl/impala.py", "rl/dqn.py", "rl/sac.py", "rl/offline.py",
              "entry.py")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_matches_whole_prefixes():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.ops.moe")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("ray_tpu_torch") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("target", ["ray_tpu_torch", "chip_smoke.py",
                                    "tools/telemetry_spread.py",
                                    "tools/nccl_check_spread.py",
                                    "tests/test_torch_cuda.py",
                                    *(f"ray_tpu_torch/{m}"
                                      for m in SERVE_MODULES + RL_MODULES
                                      + OPERATOR_MODULES + FLEET_MODULES)])
def test_sources_import_nothing_of_jax_or_ray_tpu(target):
    files = sorted(PKG.rglob("*.py")) if target == "ray_tpu_torch" \
        else [ROOT / target]
    assert files
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert bad == []
    # Inside the package only the gRPC ingress imports grpc (the card
    # script is its client where grpcio is installed).
    grpc = [str(f.relative_to(ROOT)) for f in files
            if f.is_relative_to(PKG)
            for m in _imports(f) if m == "grpc" or m.startswith("grpc.")]
    assert set(grpc) <= {"ray_tpu_torch/serve/grpc_proxy.py"}


def test_import_adds_no_jax_or_ray_tpu_module():
    """Checked as a delta in a fresh interpreter: the image may preload
    jax before any test code runs."""
    code = (
        "import sys\n"
        f"bad = lambda: {{m for m in sys.modules if any(m == f or "
        f"m.startswith(f + '.') for f in {FORBIDDEN!r})}}\n"
        "before = bad()\n"
        "import ray_tpu_torch, ray_tpu_torch.device\n"
        "import ray_tpu_torch.ops, ray_tpu_torch.ops.flash_attention\n"
        "import ray_tpu_torch.models.gpt2, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.models.llama, ray_tpu_torch.train.train_step\n"
        "import ray_tpu_torch.llm, ray_tpu_torch.llm.engine\n"
        "import ray_tpu_torch.llm.kv_cache, ray_tpu_torch.llm.sampling\n"
        "import ray_tpu_torch.llm.serving\n"
        "import ray_tpu_torch.collective, ray_tpu_torch.dryrun\n"
        "import ray_tpu_torch.collective.collective_group.cpu_group\n"
        "import ray_tpu_torch.collective.collective_group.nccl_group\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.mesh\n"
        "import ray_tpu_torch.parallel.sharding\n"
        "import ray_tpu_torch.parallel.partition_rules\n"
        "import ray_tpu_torch.parallel.ring_attention\n"
        "import ray_tpu_torch.parallel.ulysses, ray_tpu_torch.testing\n"
        "import ray_tpu_torch.train.distributed\n"
        "import ray_tpu_torch.ops.moe, ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.parallel.grad_collectives\n"
        "import ray_tpu_torch.util.checkpoint_fs\n"
        "import ray_tpu_torch.util.flax_msgpack\n"
        "import ray_tpu_torch.train.sharded_checkpoint\n"
        "import ray_tpu_torch.train.checkpoint\n"
        "import ray_tpu_torch.util.metrics, ray_tpu_torch.util.spans\n"
        "import ray_tpu_torch.util.flight_recorder\n"
        "import ray_tpu_torch.util.tracing, ray_tpu_torch.util.goodput\n"
        "import ray_tpu_torch.util.reqtrace, ray_tpu_torch.util.timeline\n"
        "import ray_tpu_torch.util.telemetry, ray_tpu_torch.util.xprof\n"
        "import ray_tpu_torch.util.prefetch\n"
        "import ray_tpu_torch.collective.telemetry\n"
        "import ray_tpu_torch.train.config, ray_tpu_torch.train.session\n"
        "import ray_tpu_torch.core.cluster_runtime\n"
        "import ray_tpu_torch.core.local_runtime\n"
        "import ray_tpu_torch.core.controller, ray_tpu_torch.core.node_agent\n"
        "import ray_tpu_torch.core.worker_main, ray_tpu_torch.cluster_utils\n"
        "import ray_tpu_torch.runtime_env, ray_tpu_torch.util.state\n"
        "import ray_tpu_torch.util.placement_group\n"
        "import ray_tpu_torch.train.trainer, ray_tpu_torch.train.v2\n"
        "import ray_tpu_torch.train.backend\n"
        "import ray_tpu_torch.train.worker_group\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.deployment\n"
        "import ray_tpu_torch.serve.routes, ray_tpu_torch.serve.resilience\n"
        "import ray_tpu_torch.serve.controller, ray_tpu_torch.serve.proxy\n"
        "import ray_tpu_torch.serve.grpc_proxy\n"
        "import ray_tpu_torch.testing.chaos, ray_tpu_torch.util.slo\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.dataset\n"
        "import ray_tpu_torch.data.grouped_data, ray_tpu_torch.data.iterator\n"
        "import ray_tpu_torch.tune, ray_tpu_torch.tune.tuner\n"
        "import ray_tpu_torch.rl, ray_tpu_torch.rl.impala\n"
        "import ray_tpu_torch.rl.dqn, ray_tpu_torch.rl.sac\n"
        "import ray_tpu_torch.rl.offline, ray_tpu_torch.rl.multi_agent\n"
        "import ray_tpu_torch.rl.convert, ray_tpu_torch.entry\n"
        "import ray_tpu_torch._native, ray_tpu_torch._native.shm_pool\n"
        "import ray_tpu_torch.runtime_env.pip\n"
        "import ray_tpu_torch.runtime_env.uv\n"
        "import ray_tpu_torch.experimental.channel, ray_tpu_torch.dag\n"
        "import ray_tpu_torch.util.doctor, ray_tpu_torch.scripts.cli\n"
        "import ray_tpu_torch.job, ray_tpu_torch.job.supervisor\n"
        "import ray_tpu_torch.client, ray_tpu_torch.client.session_host\n"
        "import ray_tpu_torch.dashboard, ray_tpu_torch.autoscaler\n"
        "import ray_tpu_torch.autoscaler.commands\n"
        "import ray_tpu_torch.autoscaler.gcp_provider\n"
        "import ray_tpu_torch.util.perf_ledger\n"
        "import ray_tpu_torch.util.microbenchmark\n"
        "import ray_tpu_torch.util.scale_bench\n"
        "from ray_tpu_torch.core import serialization\n"
        "serialization.dumps(lambda: 1)\n"
        "grpc = [m for m in sys.modules if m.split('.')[0] == 'grpc']\n"
        "print(sorted(bad() - before) + grpc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_subpackages_are_covered_by_the_source_scan():
    """The scan above walks every module of the port, the slices that
    came later included."""
    files = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    for module in ("collective/__init__.py", "collective/types.py",
                   "collective/collective_group/cpu_group.py",
                   "collective/collective_group/nccl_group.py",
                   "parallel/mesh.py", "parallel/sharding.py",
                   "parallel/partition_rules.py",
                   "parallel/ring_attention.py", "parallel/ulysses.py",
                   "train/distributed.py", "dryrun.py",
                   "ops/moe.py", "parallel/pipeline.py",
                   "parallel/grad_collectives.py", "util/checkpoint_fs.py",
                   "util/flax_msgpack.py", "train/sharded_checkpoint.py",
                   "train/checkpoint.py", "util/metrics.py",
                   "util/flight_recorder.py", "util/spans.py",
                   "util/tracing.py", "util/goodput.py", "util/reqtrace.py",
                   "util/timeline.py", "util/telemetry.py", "util/xprof.py",
                   "util/prefetch.py", "collective/telemetry.py",
                   "train/config.py", "train/session.py",
                   "core/api.py", "core/cluster_runtime.py",
                   "core/controller.py", "core/node_agent.py",
                   "core/worker_main.py", "core/serialization.py",
                   "core/resources.py", "runtime_env/__init__.py",
                   "cluster_utils.py", "util/placement_group.py",
                   "util/state.py", "train/trainer.py",
                   "train/backend.py", "train/worker_group.py",
                   "train/v2.py", "_vendor/cloudpickle/cloudpickle.py",
                   *SERVE_MODULES, *DATA_TUNE_MODULES, *RL_MODULES,
                   *OPERATOR_MODULES, *FLEET_MODULES):
        assert module in files


def test_data_and_tune_load_no_arrow_pandas_or_cloudpickle():
    """The card machine has no pyarrow, pandas or cloudpickle: the
    libraries import them only inside the functions that need the
    first two, and use the vendored pickler.  Building and running a
    pipeline of dict-of-numpy blocks without a runtime loads none of
    them either (checked as a delta in a fresh interpreter)."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import numpy as np\n"
            "import ray_tpu_torch.data as data, ray_tpu_torch.tune\n"
            "import ray_tpu_torch.data.grouped_data\n"
            "ds = data.Dataset([lambda i=i: {'t': np.full((4, 3), i)}\n"
            "                   for i in range(3)]).map_batches(\n"
            "    lambda b: {'t': b['t'] + 1})\n"
            "assert sum(len(b['t']) for b in ds.iter_batches(\n"
            "    batch_size=5, prefetch_blocks=2)) == 12\n"
            "new = set(sys.modules) - before\n"
            "print(sorted(m for m in new if m.split('.')[0] in "
            "('pyarrow', 'pandas', 'cloudpickle', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_rl_learners_and_multi_agent_runners_load_no_gymnasium():
    """The card machine has no gymnasium, pyarrow or cloudpickle: the
    RL package imports gymnasium only where a gym env is built (the
    single-agent, DQN and SAC runners, ``record_rollouts``), and parquet
    only in the data library's reader and writer.  Every learner and a
    multi-agent runner over a plain ``MultiAgentEnv`` run without them
    (checked as a delta in a fresh interpreter)."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import numpy as np\n"
            "from ray_tpu_torch import rl\n"
            "class Env(rl.MultiAgentEnv):\n"
            "    possible_agents = ['a']\n"
            "    def reset(self, *, seed=None):\n"
            "        return {'a': np.zeros(3, np.float32)}, {}\n"
            "    def step(self, actions):\n"
            "        return ({'a': np.ones(3, np.float32)}, {'a': 1.0},\n"
            "                {'__all__': False}, {'__all__': False}, {})\n"
            "spec = rl.RLModuleSpec(3, 2, (8,))\n"
            "runner = rl.MultiAgentEnvRunner(\n"
            "    Env, rl.MultiRLModuleSpec({'p': spec}), lambda a: 'p')\n"
            "runner.set_weights(runner.multi.get_weights())\n"
            "roll = runner.sample(4)['p']\n"
            "rl.PPOTorchLearner(spec, device='cpu').update_from_batch(roll)\n"
            "rl.ImpalaTorchLearner(spec, device='cpu')\n"
            "rl.DQNTorchLearner(spec, device='cpu')\n"
            "rl.BCTorchLearner(spec, device='cpu')\n"
            "rl.SACTorchLearner(rl.ContinuousModuleSpec(3, 1, (8,)),\n"
            "                   device='cpu')\n"
            "new = set(sys.modules) - before\n"
            "print(sorted(m for m in new if m.split('.')[0] in "
            "('gymnasium', 'pyarrow', 'pandas', 'cloudpickle', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_control_plane_imports_no_torch():
    """The controller, the node agent, a worker before user code runs,
    the serve plane (controller, replicas' wrapper, router, ingresses;
    not its LLM binding), the native pool, the pip/uv bootstraps, the
    channels and DAGs, state, the doctor and the rt CLI never import
    torch (nor jax), as the JAX runtime's never import jax: checked as a
    delta in a fresh interpreter."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import ray_tpu_torch\n"
            "import ray_tpu_torch.core.controller\n"
            "import ray_tpu_torch.core.node_agent\n"
            "import ray_tpu_torch.core.node_launcher\n"
            "import ray_tpu_torch.core.worker_main\n"
            "import ray_tpu_torch.core.cluster_runtime\n"
            "import ray_tpu_torch.serve, ray_tpu_torch.serve.controller\n"
            "import ray_tpu_torch.serve.deployment\n"
            "import ray_tpu_torch.serve.routes\n"
            "import ray_tpu_torch.serve.resilience\n"
            "import ray_tpu_torch.serve.proxy\n"
            "import ray_tpu_torch.serve.grpc_proxy\n"
            "import ray_tpu_torch._native.shm_pool\n"
            "from ray_tpu_torch.core.object_store import PoolObjectStore\n"
            "import ray_tpu_torch.runtime_env.pip\n"
            "import ray_tpu_torch.runtime_env.uv\n"
            "import ray_tpu_torch.experimental.channel\n"
            "import ray_tpu_torch.dag, ray_tpu_torch.util.state\n"
            "import ray_tpu_torch.util.doctor\n"
            "from ray_tpu_torch.scripts import cli\n"
            "cli._build_parser().parse_args(['status'])\n"
            "from ray_tpu_torch.core import resources, serialization\n"
            "resources.node_resources()\n"
            "serialization.unpack(serialization.pack({'a': [1, 2]}))\n"
            "new = set(sys.modules) - before\n"
            "print(sorted(m for m in new if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'cloudpickle')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_fleet_control_plane_imports_no_torch():
    """The client server, the dashboard process and the autoscaler's
    loop with the launcher (``rt up``/``down``/``exec``/``autoscale``)
    never import torch (nor jax, numpy or yaml's absence matters): a
    fresh interpreter starts the client server and the dashboard on
    free ports and answers two dashboard requests that need no cluster,
    builds a scaling loop over the static-pool and GPU-VM providers
    from a parsed spec, parses every CLI verb of this slice, and
    resolves the device peaks that ``/api/perf`` reports (through NVML,
    not torch)."""
    code = (
        "import asyncio, sys, urllib.request\n"
        "before = set(sys.modules)\n"
        "from ray_tpu_torch.client.server import ClientServer\n"
        "from ray_tpu_torch.dashboard import start_server\n"
        "from ray_tpu_torch.autoscaler import commands\n"
        "from ray_tpu_torch.autoscaler.cluster_spec import "
        "parse_cluster_spec\n"
        "from ray_tpu_torch.scripts import cli\n"
        "async def serve():\n"
        "    cs = ClientServer('127.0.0.1:1', host='127.0.0.1')\n"
        "    await cs.start()\n"
        "    srv = await start_server('127.0.0.1:1', 0, '127.0.0.1')\n"
        "    port = srv.sockets[0].getsockname()[1]\n"
        "    codes = []\n"
        "    for path in ('/', '/api/nope'):\n"
        "        def get(path=path):\n"
        "            try:\n"
        "                return urllib.request.urlopen(\n"
        "                    f'http://127.0.0.1:{port}{path}').status\n"
        "            except urllib.error.HTTPError as e:\n"
        "                return e.code\n"
        "        codes.append(await asyncio.to_thread(get))\n"
        "    srv.close(); await cs.stop()\n"
        "    return codes\n"
        "assert asyncio.run(serve()) == [200, 404]\n"
        "for ptype, extra in (('subprocess', {}), ('gcp', {\n"
        "        'project_id': 'p', 'zone': 'z', 'access_token': 't',\n"
        "        'head_host': 'localhost',\n"
        "        'api_base': 'http://127.0.0.1:1'})):\n"
        "    spec = parse_cluster_spec({'cluster_name': 'c',\n"
        "        'provider': {'type': ptype, **extra},\n"
        "        'head_node_type': 'h', 'available_node_types': {\n"
        "            'h': {'resources': {'CPU': 1}},\n"
        "            'g': {'resources': {'GPU': 1}, 'max_workers': 1,\n"
        "                  'machine_type': 'a3-highgpu-1g'}}})\n"
        "    commands.provider_from_spec(spec, '127.0.0.1:1')\n"
        "p = cli._build_parser()\n"
        "for argv in (['up', 'c.yaml'], ['down', 'c.yaml'],\n"
        "             ['exec', 'c.yaml', 'true'], ['dashboard'],\n"
        "             ['autoscale', 'c.yaml', '--address', 'h:1'],\n"
        "             ['job', 'list'], ['logs', '--job', 'x'],\n"
        "             ['start', '--head', '--client-server-port', '0']):\n"
        "    p.parse_args(argv)\n"
        "from ray_tpu_torch.core.resources import nvml_device_name\n"
        "from ray_tpu_torch.util import xprof\n"
        "xprof.build_report({}, device_name=nvml_device_name())\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in "
        "('torch', 'jax', 'numpy', 'cloudpickle')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_device_means_cuda_or_raise(monkeypatch):
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.llm.engine import GenerationEngine
    from ray_tpu_torch.llm.kv_cache import init_cache
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_init
    from ray_tpu_torch.models.llama import Llama, LlamaConfig, llama_init
    from ray_tpu_torch.ops.moe import MoEMLP
    from ray_tpu_torch.train.distributed import setup_distributed_mesh
    from ray_tpu_torch.train.session import TrainSession, iter_device_batches
    from ray_tpu_torch import entry as graft_entry
    from ray_tpu_torch import rl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    cfg, lcfg = GPT2Config.tiny(), LlamaConfig.tiny()
    moe = GPT2Config(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
                     max_seq=16, moe_num_experts=4)
    for entry in (lambda: GPT2(cfg), lambda: gpt2_init(cfg),
                  lambda: GPT2(moe), lambda: MoEMLP(32, 64, 4),
                  lambda: Llama(lcfg), lambda: llama_init(lcfg),
                  lambda: GenerationEngine(model_cfg=cfg),
                  lambda: GenerationEngine(model="llama"),
                  lambda: init_cache(1, 1, 1, 1, 1, torch.float32),
                  lambda: setup_distributed_mesh(rank=0, world=1),
                  lambda: col.init_collective_group(1, 0, backend="nccl"),
                  lambda: iter_device_batches([]),
                  lambda: TrainSession(0, 1, 0, 1, 0, "x")
                  .iter_device_batches([]),
                  lambda: rl.TorchRLModule(rl.RLModuleSpec(3, 2)),
                  lambda: rl.PPOTorchLearner(rl.RLModuleSpec(3, 2)),
                  lambda: rl.LearnerGroup(rl.RLModuleSpec(3, 2),
                                          num_learners=2),
                  lambda: rl.ImpalaTorchLearner(rl.RLModuleSpec(3, 2)),
                  lambda: rl.DQNTorchLearner(rl.RLModuleSpec(3, 2)),
                  lambda: rl.BCTorchLearner(rl.RLModuleSpec(3, 2)),
                  lambda: rl.SACTorchLearner(rl.ContinuousModuleSpec(3, 1)),
                  lambda: rl.MultiTorchRLModule(rl.MultiRLModuleSpec(
                      {"p": rl.RLModuleSpec(3, 2)})),
                  graft_entry.entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_kernel_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch,
                                                         tmp_path):
    from ray_tpu_torch.ops import _kernels

    assert _kernels.source_hash() == _kernels.source_hash()
    assert _kernels.build_dir().parent == PKG / "_build"
    assert "ray_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels._nvcc()


def test_kernel_hash_covers_every_source_and_header(monkeypatch, tmp_path):
    """Editing any file under csrc/ (a kernel source or a header shared by
    several kernels) changes the build hash, so no stale library loads."""
    from ray_tpu_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers and all((csrc / s).exists() for s in _kernels.SOURCES)
    seen = {_kernels.source_hash()}
    for path in [*headers, csrc / _kernels.SOURCES[0]]:
        path.write_text(path.read_text() + "\n// edited\n")
        seen.add(_kernels.source_hash())
    (csrc / "extra.h").write_text("#pragma once\n")
    seen.add(_kernels.source_hash())
    assert len(seen) == len(headers) + 3
