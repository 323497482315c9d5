"""GPipe pipeline parallelism: the port against the JAX package.

``tests/test_parallel.py``'s pipeline cases (stage_fn ``tanh(h @ w)``,
float32) at 2 and 4 stages: JAX ``pipeline_apply`` under ``shard_map``
on the virtual CPU mesh (stacked stage weights over ``pipeline``) and
the port's on 2 and 4 spawned gloo ranks, one stage each (one spawn per
world, ``ray_tpu_torch.testing.pipeline_cases``).  The output, every
stage's weight gradient and the input gradient of sum(out ** 2) must
agree with JAX and with the stages run in sequence within 1e-5 (atol
and rtol), with the stage recomputed in the backward and without.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ray_tpu.parallel import MeshSpec, create_mesh, pipeline_apply
from ray_tpu_torch.dryrun import spawn
from ray_tpu_torch.testing import pipeline_cases

TOL = 1e-5


def _stage(w, h):
    return jnp.tanh(h @ w)


def _inputs(s, name):
    """test_pipeline_matches_sequential's and test_pipeline_gradients_
    flow's weights and batch, for s stages."""
    if name.startswith("sequential"):
        keys = jax.random.split(jax.random.PRNGKey(3), s)
        ws = jnp.stack([jax.random.normal(k, (16, 16)) * 0.3 for k in keys])
        return ws, jax.random.normal(jax.random.PRNGKey(4), (8, 16)), 4
    ws = jax.random.normal(jax.random.PRNGKey(5), (s, 8, 8)) * 0.3
    return ws, jax.random.normal(jax.random.PRNGKey(6), (8, 8)), 2


NAMES = [f"{case}-checkpoint-{ckpt}" for case in ("sequential", "gradients")
         for ckpt in (True, False)]


def _jax(s, ws, x, m):
    mesh = create_mesh(MeshSpec(pipeline=s, data=-1))
    piped = shard_map(
        functools.partial(pipeline_apply, _stage, num_microbatches=m),
        mesh=mesh, in_specs=(P("pipeline"), P(None)), out_specs=P(None),
        check_vma=False)
    out = jax.jit(piped)(ws, x)
    gw, gx = jax.jit(jax.grad(lambda w, x: jnp.sum(piped(w, x) ** 2),
                              argnums=(0, 1)))(ws, x)

    def ref_loss(w, x):
        h = x
        for i in range(s):
            h = _stage(w[i], h)
        return jnp.sum(h ** 2), h

    (_, ref), (rw, rx) = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                            has_aux=True)(ws, x)
    return [np.asarray(a) for a in (out, gw, gx, ref, rw, rx)]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    s = request.param
    inputs = {name: _inputs(s, name) for name in NAMES}
    cases = [(name, np.asarray(ws), np.asarray(x), m,
              name.endswith("True"))
             for name, (ws, x, m) in inputs.items()]
    runs = spawn(pipeline_cases, s, cases, timeout=120,
                 workdir=str(tmp_path_factory.mktemp(f"pipe{s}")))
    # JAX always recomputes the stage: one run serves both settings.
    once = {case: _jax(s, *inputs[f"{case}-checkpoint-True"])
            for case in ("sequential", "gradients")}
    want = {name: once[name.split("-")[0]] for name in NAMES}
    return s, runs, want


@pytest.mark.parametrize("name", NAMES)
def test_output_matches_jax_and_sequential(world, name):
    _s, runs, want = world
    out, _gw, _gx, ref, _rw, _rx = want[name]
    for rank in runs:   # every rank holds the last stage's output
        np.testing.assert_allclose(rank[name][0], out, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(rank[name][0], ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_and_sequential(world, name):
    s, runs, want = world
    _out, gw, gx, _ref, rw, rx = want[name]
    got_w = np.stack([runs[r][name][1] for r in range(s)])
    np.testing.assert_allclose(got_w, gw, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_w, rw, atol=TOL, rtol=TOL)
    # The input's gradient lands on stage 0.
    np.testing.assert_allclose(runs[0][name][2], gx, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(runs[0][name][2], rx, atol=TOL, rtol=TOL)
    for r in range(1, s):
        assert not np.any(runs[r][name][2])


def test_indivisible_batch_raises(world):
    _s, runs, _want = world
    assert all(r["indivisible_raises"] for r in runs)


def test_stack_stage_params():
    import torch

    from ray_tpu_torch.parallel.pipeline import stack_stage_params

    stages = [{"w": torch.full((2, 3), float(i)), "b": [torch.ones(3) * i]}
              for i in range(4)]
    stacked = stack_stage_params(stages)
    assert stacked["w"].shape == (4, 2, 3)
    assert stacked["b"][0].shape == (4, 3)
    for i in range(4):
        assert torch.equal(stacked["w"][i], stages[i]["w"])
