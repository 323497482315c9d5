"""Ring and Ulysses attention: the port against the JAX package.

The same float32 inputs (numpy, seeded) go through JAX's
``ring_attention`` / ``ulysses_attention`` under ``shard_map`` on the
virtual CPU mesh and through the port's on 2 and 4 spawned gloo ranks
(``ray_tpu_torch.testing.attention_cases``, one spawn per world).
Shapes are those of ``tests/test_parallel.py``: ring B2 T32 H4 D16,
Ulysses B2 T32 H8 D16.  Outputs and the gradients of sum(out ** 2) must
agree within that file's tolerances: 2e-5 (atol and rtol) for outputs,
3e-5 for gradients.  On the CPU, ``impl="flash"`` runs the plain
versions of the flash kernels with their lse cotangent.  Both impls also
run causal with ``checkpoint_steps`` set either way (JAX with the same
setting); the two settings must give the same output and gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ray_tpu.parallel import MeshSpec, create_mesh
from ray_tpu.parallel.ring_attention import ring_attention
from ray_tpu.parallel.ulysses import ulysses_attention
from ray_tpu_torch.dryrun import spawn
from ray_tpu_torch.testing import attention_cases

CASES = [(f"{kind}-{impl}-{'causal' if causal else 'full'}", kind, impl,
          causal, None)
         for kind, impl in (("ring", "flash"), ("ring", "lax"),
                            ("ulysses", None))
         for causal in (True, False)]
CASES += [(f"ring-{impl}-causal-checkpoint-{ckpt}", "ring", impl, True, ckpt)
          for impl in ("flash", "lax") for ckpt in (True, False)]


def _inputs(kind, seed):
    h = 8 if kind == "ulysses" else 4
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 32, h, 16)).astype(np.float32)
            for _ in range(3)]


def _jax(n, kind, impl, causal, ckpt, q, k, v):
    mesh = create_mesh(MeshSpec(seq=n, data=-1))
    spec = P(None, "seq", None, None)
    inner = (functools.partial(ring_attention, causal=causal, impl=impl,
                               checkpoint_steps=ckpt)
             if kind == "ring" else
             functools.partial(ulysses_attention, causal=causal))
    fn = shard_map(inner, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=spec, check_vma=False)
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    # The checkpoint_steps cases share one seed, so both settings see the
    # same inputs.
    cases = [(name, kind, impl, causal, ckpt,
              *_inputs(kind, 100 if ckpt is not None else i))
             for i, (name, kind, impl, causal, ckpt) in enumerate(CASES)]
    runs = spawn(attention_cases, n, cases, timeout=120,
                 workdir=str(tmp_path_factory.mktemp(f"ring{n}")))
    want = {name: _jax(n, kind, impl, causal, ckpt, *qkv)
            for name, kind, impl, causal, ckpt, *qkv in cases}
    # The ranks' shards, concatenated along the sequence.
    got = {name: [np.concatenate([r[name][j] for r in runs], axis=1)
                  for j in range(4)] for name, *_ in cases}
    return got, want


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_output_matches_jax(world, name):
    got, want = world
    np.testing.assert_allclose(got[name][0], want[name][0], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_gradients_match_jax(world, name):
    got, want = world
    for g, w, which in zip(got[name][1:], want[name][1:], "qkv"):
        np.testing.assert_allclose(g, w, atol=3e-5, rtol=3e-5,
                                   err_msg=f"d{which}")


@pytest.mark.parametrize("impl", ["flash", "lax"])
def test_checkpoint_steps_leave_output_and_gradients_alone(world, impl):
    """Recomputing each step's block in the backward changes nothing:
    the same output and gradients with checkpoint_steps on and off."""
    got, _want = world
    on, off = (got[f"ring-{impl}-causal-checkpoint-{c}"] for c in (True,
                                                                   False))
    for a, b, which in zip(on, off, ("out", "dq", "dk", "dv")):
        np.testing.assert_array_equal(a, b, err_msg=which)


def test_ulysses_rejects_heads_not_dividing_the_axis(monkeypatch):
    import torch

    from ray_tpu_torch.parallel import ulysses

    monkeypatch.setattr(ulysses.dist, "get_world_size", lambda group: 2)
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="divisible"):
        ulysses.ulysses_attention(q, q, q)
