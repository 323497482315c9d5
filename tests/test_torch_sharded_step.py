"""The sharded training step: the port against the JAX package.

The JAX dry run's configuration (vocab 512, 2 layers, 4 heads, d_model
128, d_ff 256, max_seq 64), in float32, with the same weights in both
packages (``models/convert.py``) and random tokens from a numpy seed.
JAX's ``make_sharded_train_step`` takes 2 steps on 4 virtual CPU
devices; the port's takes them on 4 spawned gloo ranks (one spawn for
every case, ``ray_tpu_torch.testing.sharded_step_cases``), over the
meshes data2 x seq2 (ring attention), fsdp2 x tensor2 (dense), seq2 x
tensor2 (Ulysses), and a Llama with GQA on fsdp2 x seq2 (ring).  Loss
and grad norm of both steps and every parameter after step 2 (gathered
with ``full_tensor()`` and turned back into the flax tree) must agree
within 1e-4 relative and 1e-5 absolute.  Each mesh must also give every
rank the rows of the batch that JAX's ``NamedSharding`` gives the device
at its coordinates (a dim split over several axes goes major to minor).

At world 1 (in this process), the port's sharded step must equal its
unsharded step within 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import create_mesh as jcreate_mesh
from ray_tpu.parallel.sharding import ShardingRules as JRules
from ray_tpu.parallel.sharding import logical_sharding as jlogical
from ray_tpu.train import train_step as jstep
from ray_tpu_torch import collective as col
from ray_tpu_torch.dryrun import dryrun_multichip, sharded_steps, spawn
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.testing import sharded_step_cases
from ray_tpu_torch.train import train_step as tstep

GPT2 = dict(vocab_size=512, n_layer=2, n_head=4, d_model=128, d_ff=256,
            max_seq=64, remat=True)
LLAMA = dict(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2,
             d_model=128, d_ff=256, max_seq=64, remat=True)
OPT = dict(total_steps=10, warmup_steps=2)
CASES = [("gpt2-data2-seq2-ring", "gpt2", "ring", dict(data=2, seq=2)),
         ("gpt2-fsdp2-tensor2-dense", "gpt2", "dense",
          dict(fsdp=2, tensor=2)),
         ("gpt2-seq2-tensor2-ulysses", "gpt2", "ulysses",
          dict(seq=2, tensor=2)),
         ("llama-gqa-fsdp2-seq2-ring", "llama", "ring",
          dict(fsdp=2, seq=2))]
RTOL, ATOL = 1e-4, 1e-5


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (4, 65)).astype(np.int32)
            for _ in range(2)]


def _jax_init(model, attn, axes):
    mesh = jcreate_mesh(JMeshSpec(**axes), jax.devices()[:4])
    if model == "gpt2":
        cfg = jgpt2.GPT2Config(**GPT2, dtype=jnp.float32, attn_impl=attn,
                               mesh=mesh, rules=JRules())
        return cfg, jgpt2.gpt2_init(cfg, jax.random.PRNGKey(0))
    cfg = jllama.LlamaConfig(**LLAMA, dtype=jnp.float32, attn_impl=attn,
                             mesh=mesh, rules=JRules())
    return cfg, jllama.llama_init(cfg, jax.random.PRNGKey(0))


def _jax_run(model, cfg, params, batches):
    mesh, rules = cfg.mesh, cfg.rules
    loss, axes_fn = ((jgpt2.gpt2_loss_fn, jgpt2.gpt2_param_axes)
                     if model == "gpt2" else
                     (jllama.llama_loss_fn, jllama.llama_param_axes))
    opt = jstep.make_optimizer(**OPT)
    state = jstep.shard_state(jstep.TrainState.create(params, opt), mesh,
                              axes_fn, rules)
    step = jstep.make_sharded_train_step(lambda p, b: loss(cfg, p, b), opt,
                                         mesh, telemetry=False)
    sharding = jlogical(mesh, ("batch", None), rules)
    metrics = []
    for toks in batches:
        state, m = step(state, {"tokens": jax.device_put(jnp.asarray(toks),
                                                         sharding)})
        metrics.append({k: float(v) for k, v in m.items()})
    rows = sharding.devices_indices_map((8, 1))
    # Rows of an [8, 1] batch for the device at each C-order coordinate.
    by_coord = [np.arange(8)[rows[d][0]]
                for d in mesh.devices.reshape(-1)]
    return metrics, jax.tree_util.tree_map(np.asarray, state.params), \
        by_coord


def _torch_cfg(model, attn):
    if model == "gpt2":
        return tgpt2.GPT2Config(**GPT2, dtype=torch.float32, attn_impl=attn)
    return tllama.LlamaConfig(**LLAMA, dtype=torch.float32, attn_impl=attn)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's four ranks run every case (one spawn) while JAX
    computes its side in this process; then the 8-rank dry run."""
    work = str(tmp_path_factory.mktemp("sharded"))
    inits = {name: _jax_init(model, attn, axes)
             for name, model, attn, axes in CASES}
    cases = [(name, model, _torch_cfg(model, attn),
              jax.tree_util.tree_map(np.asarray, inits[name][1]), axes,
              _batches(i))
             for i, (name, model, attn, axes) in enumerate(CASES)]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, sharded_step_cases, 4, cases, timeout=300,
                           workdir=work)
        jax_side = {name: _jax_run(model, *inits[name], _batches(i))
                    for i, (name, model, _a, _x) in enumerate(CASES)}
        ranks = port.result()
    ranks = {name: [r[name] for r in ranks] for name in jax_side}
    return jax_side, ranks, dryrun_multichip(8, timeout=300, workdir=work)


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_jax(runs, name):
    jax_side, ranks, _dry = runs
    want = jax_side[name][0]
    for rank in ranks[name]:
        got = rank[0]
        for step, (g, w) in enumerate(zip(got, want)):
            for key in ("loss", "grad_norm"):
                assert g[key] == pytest.approx(w[key], rel=RTOL, abs=ATOL), \
                    (step, key)


@pytest.mark.parametrize("name", NAMES)
def test_parameters_after_two_steps_match_jax(runs, name):
    jax_side, ranks, _dry = runs
    want = jax_side[name][1]["params"]
    got = ranks[name][0][1]["params"]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", NAMES)
def test_batch_rows_follow_jax_named_sharding(runs, name):
    jax_side, ranks, _dry = runs
    for rank, rows in enumerate(jax_side[name][2]):
        np.testing.assert_array_equal(ranks[name][rank][2], rows)


@pytest.mark.parametrize("name", NAMES)
def test_rule_sets_place_like_the_logical_axes(runs, name):
    """``gpt2_partition_rules``/``llama_partition_rules`` through
    ``shard_train_state`` give each parameter the placements of the
    logical axes through ``shard_state``, and ``put_global_batch`` of a
    rank's ``global_batch_slice`` rows lands as the rule places them."""
    _jax, ranks, _dry = runs
    for rank in ranks[name]:
        assert rank[3]
        assert rank[4] == rank[5]


@pytest.fixture
def world1(tmp_path):
    col.init_collective_group(1, 0, backend="cpu", group_name="gang",
                              init_method=f"file://{tmp_path}/store")
    yield
    col.destroy_collective_group("gang")


@pytest.mark.parametrize("sharded,plain", [("dense", "dense"),
                                           ("ring", "flash")])
def test_world1_sharded_step_equals_unsharded(world1, sharded, plain):
    """Ring attention at world 1 is one causal flash call merged with
    the empty accumulator."""
    batches = _batches(7)
    metrics, final = sharded_steps(_torch_cfg("gpt2", sharded), None, {},
                                   batches, device="cpu", optimizer_kw=OPT)
    cfg = _torch_cfg("gpt2", plain)
    model = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = tstep.make_optimizer(**OPT)
    state = tstep.TrainState.create(model, opt)
    step = tstep.make_train_step(
        lambda m, b: tgpt2.gpt2_loss_fn(cfg, m, b), opt)
    for toks, got in zip(batches, metrics):
        state, m = step(state, {"tokens": torch.from_numpy(toks).long()})
        for key in ("loss", "grad_norm"):
            assert got[key] == pytest.approx(float(m[key]), rel=1e-6)
    ref = gpt2_params_from_numpy(final)
    for n, p in model.named_parameters():
        torch.testing.assert_close(ref[n], p.detach(), rtol=1e-6, atol=1e-6)


def test_dryrun_multichip_8(runs):
    """The JAX dry run's meshes at 8 ranks: data2 x seq2 x tensor2 with
    ring attention, dcn2 x data2 x tensor2, and data2 x expert2 x
    tensor2 with MoE blocks; zero tokens from the seed-0 init give a
    finite loss below ln(vocab)."""
    dry = runs[2]
    assert [(name, axes) for name, axes, _l in dry] == [
        ("main", dict(data=2, seq=2, tensor=2)),
        ("dcn", dict(dcn=2, data=2, tensor=2)),
        ("ep", dict(data=2, expert=2, tensor=2))]
    for name, _axes, loss in dry:
        assert 0 < loss < np.log(512 if name == "main" else 256) + 0.1


def test_world1_meshes_and_ring_attention_sharded(world1):
    """The three mesh builders over a world-1 gang, and
    ``ring_attention_sharded`` on DTensors: one causal flash call."""
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshSpec,
                                             create_mesh, gang_mesh,
                                             local_mesh)
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.sharding import distribute, logical_sharding

    mesh = create_mesh(MeshSpec(), device="cpu")
    assert mesh.mesh_dim_names == AXIS_ORDER and mesh.size() == 1
    assert local_mesh(device="cpu").mesh_dim_names == AXIS_ORDER
    gang = gang_mesh({"fsdp": 1, "tensor": 1}, device="cpu")
    assert gang.mesh_dim_names == ("fsdp", "tensor")
    with pytest.raises(ValueError, match="needs 2 devices"):
        gang_mesh({"fsdp": 2}, device="cpu")
    q, k, v = (torch.randn(2, 32, 4, 16, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    sharding = logical_sharding(mesh, ("batch", "seq", "heads", None))
    out = ring_attention_sharded(mesh, *(distribute(x, sharding)
                                         for x in (q, k, v)))
    torch.testing.assert_close(out.full_tensor(),
                               flash_attention(q, k, v, causal=True),
                               rtol=0, atol=0)
