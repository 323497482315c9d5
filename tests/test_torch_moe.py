"""MoE and expert parallelism: the port against the JAX package.

The cases of ``tests/test_moe.py``, each held against the JAX layer or
model on the same weights (``models/convert.py``) and the same numpy
inputs, in float32:

- ``MoEMLP``: output, auxiliary loss and the gradients of every
  parameter and of the input, within 1e-5 (atol and rtol);
- the capacity drop at ``capacity_factor=0.05``: the same rows are zero;
- the Switch auxiliary loss: 1 for a uniform router, above 2 for a
  collapsed one, as JAX computes it;
- a GPT-2 with MoE blocks trained 12 steps: the same losses, and every
  parameter after 2 steps, within 1e-4 relative and 1e-5 absolute;
- the sharded step with random tokens against JAX's
  ``make_sharded_train_step`` on the virtual mesh, at data2 x expert2
  (4 spawned gloo ranks) and at the dry run's data2 x expert2 x tensor2
  (8 ranks): loss and grad norm of both steps and every parameter after
  step 2, within 1e-4 relative and 1e-5 absolute.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops.moe import MoEMLP as JMoE
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import create_mesh as jcreate_mesh
from ray_tpu.parallel.sharding import ShardingRules as JRules
from ray_tpu.parallel.sharding import logical_sharding as jlogical
from ray_tpu.train import train_step as jstep
from ray_tpu_torch.dryrun import spawn
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.ops.moe import MoEMLP
from ray_tpu_torch.testing import moe_step_cases
from ray_tpu_torch.train import train_step as tstep

RTOL, ATOL = 1e-4, 1e-5
OPT = dict(total_steps=10, warmup_steps=2)
# The JAX dry run's expert-parallel config.
EP = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=128,
          max_seq=32, remat=True, moe_num_experts=4, moe_every=2)
MESHES = {4: dict(data=2, expert=2), 8: dict(data=2, expert=2, tensor=2)}


def _layers(e=4, k=2, cap=2.0, d=16, ff=32):
    jl = JMoE(d_model=d, d_ff=ff, num_experts=e, top_k=k,
              capacity_factor=cap, dtype=jnp.float32)
    tl = MoEMLP(d, ff, e, top_k=k, capacity_factor=cap,
                dtype=torch.float32, device="cpu")
    return jl, tl


def _load(tl, params):
    with torch.no_grad():
        for name in ("router", "w_in", "w_out"):
            getattr(tl, name).copy_(
                torch.from_numpy(np.array(params["params"][name])))


def _jax_aux(state):
    return jax.tree_util.tree_leaves(state["intermediates"])[0]


@pytest.mark.parametrize("e,k,cap", [(4, 2, 2.0), (8, 1, 1.0),
                                     (4, 2, 0.5)])
def test_moe_layer_output_aux_and_gradients_match_jax(e, k, cap):
    jl, tl = _layers(e, k, cap)
    x = np.random.default_rng(0).standard_normal((2, 8, 16)) \
        .astype(np.float32)
    params = jl.init(jax.random.PRNGKey(1), x)

    def loss(p, x):
        y, state = jl.apply(p, x, mutable=["intermediates"])
        aux = _jax_aux(state)
        return jnp.mean(y ** 2) + 0.01 * jnp.sum(aux), (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, has_aux=True, argnums=(0, 1)))(params, x)
    _load(tl, params)
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = tl(xt)
    ((yt ** 2).mean() + 0.01 * auxt).backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(auxt.detach()), float(np.sum(aux)),
                               rtol=1e-5, atol=1e-5)
    for name in ("router", "w_in", "w_out"):
        g = getattr(tl, name).grad.numpy()
        np.testing.assert_allclose(g, np.asarray(gp["params"][name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(g).sum() > 0, name
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)


def test_moe_capacity_drops_the_same_rows_as_jax():
    """Capacity about one token per expert: nearly every row is dropped
    (exactly zero), the same rows as in JAX."""
    jl, tl = _layers(e=2, k=1, cap=0.05)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 64, 16)))
    params = jl.init(jax.random.PRNGKey(1), x)
    _load(tl, params)
    want = np.abs(np.asarray(jax.jit(jl.apply)(params, x))[0]).sum(-1)
    with torch.no_grad():
        got = tl(torch.from_numpy(x))[0][0].abs().sum(-1).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).sum() >= 60
    assert (got > 0).sum() >= 1


@pytest.mark.parametrize("skewed", [False, True])
def test_moe_aux_loss_uniform_and_collapsed_router(skewed):
    """A zero router gives uniform probabilities: the aux loss is 1
    whatever the top-1 picks.  A router that favours expert 0 gives
    more than 2.  The port's value is JAX's."""
    e, d = 4, 16
    jl, tl = _layers(e=e, k=1, cap=2.0, d=d)
    x = np.abs(np.random.default_rng(1).standard_normal((1, 64, d))) \
        .astype(np.float32)
    params = jl.init(jax.random.PRNGKey(1), x)
    router = np.zeros((d, e), np.float32)
    if skewed:
        router[:, 0] = 2.0
    params = {"params": {**params["params"], "router": jnp.asarray(router)}}
    _load(tl, params)
    _, state = jl.apply(params, x, mutable=["intermediates"])
    want = float(np.sum(_jax_aux(state)))
    with torch.no_grad():
        got = float(tl(torch.from_numpy(x))[1])
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    if skewed:
        assert got > 2.0
    else:
        assert got == pytest.approx(1.0, abs=1e-5)


def _init(cfg, seed):
    """The JAX model's init under ``jit`` (several times faster than
    eager on the CPU; the draws differ, and the port takes whatever
    weights JAX makes)."""
    return jax.jit(lambda key: jgpt2.gpt2_init(cfg, key))(
        jax.random.PRNGKey(seed))


def _gpt2_moe_cfgs():
    kw = dict(vocab_size=256, n_layer=2, n_head=2, d_model=64, d_ff=128,
              max_seq=32, remat=False, moe_num_experts=4, moe_every=2)
    return (jgpt2.GPT2Config(**kw, dtype=jnp.float32),
            tgpt2.GPT2Config(**kw, dtype=torch.float32))


@pytest.fixture(scope="module")
def trained():
    """12 steps of the GPT-2 MoE config in both packages."""
    jcfg, tcfg = _gpt2_moe_cfgs()
    params = _init(jcfg, 0)
    init = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 33),
                                           0, 256))
    opt = jstep.make_optimizer(total_steps=30)
    state = jstep.TrainState.create(params, opt)
    step = jstep.make_train_step(
        lambda p, b: jgpt2.gpt2_loss_fn(jcfg, p, b, loss_chunk=0), opt)
    model = tgpt2.GPT2(tcfg, device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(init))
    topt = tstep.make_optimizer(total_steps=30)
    tstate = tstep.TrainState.create(model, topt)
    tstep_fn = tstep.make_train_step(
        lambda m, b: tgpt2.gpt2_loss_fn(tcfg, m, b, loss_chunk=0), topt)
    jl, tl, after2 = [], [], None
    for i in range(12):
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep_fn(tstate, {"tokens": torch.from_numpy(tokens)})
        jl.append(float(m["loss"]))
        tl.append(float(tm["loss"]))
        if i == 1:
            after2 = (jax.tree_util.tree_map(np.asarray, state.params),
                      {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()})
    return init, jl, tl, after2


def test_gpt2_moe_blocks_on_alternate_layers(trained):
    init = trained[0]["params"]
    assert "moe_mlp" in init["h_1"] and "moe_mlp" not in init["h_0"]
    _jcfg, tcfg = _gpt2_moe_cfgs()
    names = dict(tgpt2.GPT2(tcfg, device="cpu").named_parameters())
    assert "h_1.moe_mlp.w_in" in names and "h_0.mlp_in.kernel" in names
    assert not any(n.startswith("h_1.mlp_") for n in names)


def test_gpt2_moe_losses_over_12_steps_match_jax(trained):
    _init, jl, tl, _ = trained
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tl[-1] < tl[0]


def test_gpt2_moe_parameters_after_two_steps_match_jax(trained):
    jp, tp = trained[3]
    want = gpt2_params_from_numpy(jp)
    assert sorted(want) == sorted(tp)
    for name, w in want.items():
        np.testing.assert_allclose(tp[name], w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# ------------------------------------------------------ expert parallel
def _jax_init(world):
    mesh = jcreate_mesh(JMeshSpec(**MESHES[world]), jax.devices()[:world])
    cfg = jgpt2.GPT2Config(**EP, dtype=jnp.float32, mesh=mesh,
                           rules=JRules())
    return cfg, _init(cfg, 1)


def _jax_steps(cfg, params, batches):
    mesh = cfg.mesh
    opt = jstep.make_optimizer(**OPT)
    state = jstep.shard_state(jstep.TrainState.create(params, opt), mesh,
                              jgpt2.gpt2_param_axes, JRules())
    step = jstep.make_sharded_train_step(
        lambda p, b: jgpt2.gpt2_loss_fn(cfg, p, b, loss_chunk=0), opt, mesh,
        telemetry=False)
    sharding = jlogical(mesh, ("batch", None), JRules())
    metrics = []
    for toks in batches:
        state, m = step(state, {"tokens": jax.device_put(jnp.asarray(toks),
                                                         sharding)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module", params=[4, 8])
def expert_parallel(request, tmp_path_factory):
    """The port's ranks run while JAX takes its steps in this process."""
    world = request.param
    rng = np.random.default_rng(world)
    batches = [rng.integers(0, 256, (4, 33)).astype(np.int32)
               for _ in range(2)]
    jcfg, params = _jax_init(world)
    init = jax.tree_util.tree_map(np.asarray, params)
    cfg = tgpt2.GPT2Config(**EP, dtype=torch.float32)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(
            spawn, moe_step_cases, world,
            [("ep", cfg, init, MESHES[world], batches)], timeout=300,
            workdir=str(tmp_path_factory.mktemp(f"moe{world}")))
        metrics, final = _jax_steps(jcfg, params, batches)
        runs = port.result()
    return world, metrics, final, [r["ep"] for r in runs]


def test_expert_parallel_loss_and_grad_norm_match_jax(expert_parallel):
    _world, want, _final, ranks = expert_parallel
    for got, _params, _placements in ranks:
        for step, (g, w) in enumerate(zip(got, want)):
            for key in ("loss", "grad_norm"):
                assert g[key] == pytest.approx(w[key], rel=RTOL, abs=ATOL), \
                    (step, key)


def test_expert_parallel_parameters_match_jax(expert_parallel):
    _world, _metrics, final, ranks = expert_parallel
    want = gpt2_params_from_numpy(final)
    got = gpt2_params_from_numpy(ranks[0][1])
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_expert_weights_split_over_the_expert_axis(expert_parallel):
    world, _m, _f, ranks = expert_parallel
    placements = ranks[0][2]
    assert placements["h_1.moe_mlp.w_in"].startswith("(Shard(dim=0)")
    assert placements["h_1.moe_mlp.w_out"].startswith("(Shard(dim=0)")
    if world == 8:
        assert placements["h_1.moe_mlp.w_in"].endswith("Shard(dim=2))")
        assert placements["h_1.moe_mlp.w_out"].endswith("Shard(dim=1))")
