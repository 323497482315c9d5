"""The port's mesh, sharding-rule and topology math against the JAX
package's, on the same inputs, exactly.

``MeshSpec.resolve``, ``ShardingRules.mesh_axes``/``prune``, the
``train.distributed`` topology math over the grids of
``tests/test_distributed_train.py``, and ``match_partition_rules`` /
``spec_to_json`` / ``prune_spec`` and the logical parameter axes on the
GPT-2 and Llama parameter trees.  Placements are checked on a stand-in
mesh object, so no process group is needed.
"""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import partition_rules as jrules
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.train import distributed as jdist
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import partition_rules as trules
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.train import distributed as tdist


def _same(fn_j, fn_t, *args, **kw):
    """Both return equal values, or both raise the same exception type."""
    try:
        want = fn_j(*args, **kw)
    except Exception as e:                        # noqa: BLE001
        with pytest.raises(type(e)):
            fn_t(*args, **kw)
        return None
    got = fn_t(*args, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("axes,n", [
    ({}, 1), ({"data": -1}, 8), ({"data": 2, "seq": 2, "tensor": 2}, 8),
    ({"data": -1, "seq": 2, "tensor": 2}, 16), ({"dcn": 2, "data": -1}, 8),
    ({"data": -1, "fsdp": -1}, 8), ({"data": 3}, 8), ({"data": -1}, 0),
    ({"data": 0}, 1), ({"data": -1, "tensor": 3}, 8)])
def test_mesh_spec_resolve(axes, n):
    _same(lambda: jmesh.MeshSpec(**axes).resolve(n).axes(),
          lambda: tmesh.MeshSpec(**axes).resolve(n).axes())
    assert tmesh.MeshSpec(**{k: max(v, 1) for k, v in axes.items()}
                          ).nontrivial_axes() == \
        jmesh.MeshSpec(**{k: max(v, 1) for k, v in axes.items()}
                       ).nontrivial_axes()
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("logical", [
    ("batch", "seq", "embed"), ("batch", "seq", "heads", None),
    ("vocab", "embed_fsdp"), ("batch", None), ("nope",)])
def test_sharding_rules_mesh_axes(logical):
    _same(lambda: jsharding.ShardingRules().mesh_axes(logical),
          lambda: tsharding.ShardingRules().mesh_axes(logical))
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


class _Mesh:
    """Stands in for a DeviceMesh: names, sizes and named slicing."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = np.empty(tuple(sizes.values()))
        self.sizes = dict(sizes)

    def __getitem__(self, names):
        return _Mesh({a: self.sizes[a] for a in names})


@pytest.mark.parametrize("axes", [
    dict(data=8), dict(data=2, seq=2, tensor=2), dict(fsdp=2, tensor=2),
    dict(dcn=2, data=2, tensor=2), {}])
def test_sharding_rules_prune(axes):
    spec = jmesh.MeshSpec(**axes)
    n = int(np.prod(list(spec.axes().values())))
    want = jsharding.ShardingRules().prune(
        jmesh.create_mesh(spec, jax.devices()[:n])).rules
    got = tsharding.ShardingRules().prune(
        _Mesh(tmesh.MeshSpec(**axes).axes())).rules
    assert got == want


def test_spec_placements_split_major_to_minor_in_mesh_order():
    mesh = _Mesh(tmesh.MeshSpec(fsdp=2, seq=2, tensor=1).axes())
    sh = tsharding.spec_placements(mesh, (("fsdp", "seq"), None))
    assert sh.mesh.mesh_dim_names == ("fsdp", "seq")
    assert sh.placements == (Shard(0), Shard(0))
    assert sh.spec == (("fsdp", "seq"), None) and sh.replica == ()
    # A size-1 axis is dropped, like JAX's prune.
    sh = tsharding.spec_placements(mesh, ("tensor", "fsdp"))
    assert sh.placements == (Shard(1), Replicate())
    assert sh.spec == (None, "fsdp")
    with pytest.raises(ValueError, match="mesh order"):
        tsharding.spec_placements(mesh, (("seq", "fsdp"),))
    with pytest.raises(ValueError, match="two dims"):
        tsharding.spec_placements(mesh, ("fsdp", "fsdp"))


def test_replica_axes_stay_outside_the_placement_mesh():
    """dcn and data split the batch before DTensor sees it: the
    placement mesh keeps the other axes, major to minor after them."""
    mesh = _Mesh(tmesh.MeshSpec(dcn=2, data=2, fsdp=2, tensor=2).axes())
    sh = tsharding.spec_placements(mesh, (("dcn", "data", "fsdp"), None))
    assert sh.mesh.mesh_dim_names == ("fsdp", "tensor")
    assert sh.placements == (Shard(0), Replicate())
    assert sh.replica == ((0, ("dcn", "data")),)
    assert tsharding.replica_axes(mesh) == ("dcn", "data")
    only_data = _Mesh(tmesh.MeshSpec(data=2).axes())
    assert tsharding.placement_mesh(only_data).mesh_dim_names == ("tensor",)
    with pytest.raises(ValueError, match="mesh order"):
        tsharding.spec_placements(mesh, (("fsdp", "data"),))


_SHAPES = [{"fsdp": 2, "tensor": 2}, {"fsdp": 4, "tensor": 2},
           {"fsdp": 3, "tensor": 1}, {"fsdp": 8, "tensor": 1},
           {"fsdp": 2, "tensor": 4}, {"fsdp": 1, "tensor": 2}]


@pytest.mark.parametrize("hosts,per_host,kw", [
    (2, 2, {}), (4, 4, {}), (8, 1, {}), (1, 4, {}), (1, 1, {}),
    (2, 4, {"tensor": 2}), (2, 4, {"fsdp": 2}),
    (2, 4, {"fsdp": 8, "tensor": 1}), (2, 4, {"tensor": 3}),
    (2, 4, {"fsdp": 3}), (2, 4, {"fsdp": 2, "tensor": 2}), (0, 4, {}),
    (2, 0, {})])
def test_derive_mesh_shape(hosts, per_host, kw):
    _same(jdist.derive_mesh_shape, tdist.derive_mesh_shape, hosts,
          per_host, **kw)


@pytest.mark.parametrize("shape", _SHAPES)
def test_mesh_coords_for_rank(shape):
    total = shape["fsdp"] * shape["tensor"]
    for world in (1, 2, 4):
        if total % world:
            continue
        for rank in range(world):
            _same(jdist.mesh_coords_for_rank, tdist.mesh_coords_for_rank,
                  shape, rank, world)
    for bad in ((2, 2), (-1, 2)):
        _same(jdist.mesh_coords_for_rank, tdist.mesh_coords_for_rank,
              shape, *bad)


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("batch", [8, 7, 24])
def test_global_batch_slice(shape, batch):
    for world in (1, 2, 4, 3):
        for rank in range(world + 1):
            _same(jdist.global_batch_slice, tdist.global_batch_slice, batch,
                  shape, rank, world)


def _gpt2_trees():
    cfg = jgpt2.GPT2Config.tiny()
    params = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(cfg, jax.random.PRNGKey(0)))
    model = tgpt2.gpt2_init(tgpt2.GPT2Config.tiny(),
                            torch.Generator().manual_seed(0), "cpu")
    return (params, model.state_dict(), jgpt2.gpt2_partition_rules(),
            tgpt2.gpt2_partition_rules(), jgpt2.gpt2_param_axes,
            tgpt2.gpt2_param_axes)


def _llama_trees():
    cfg = jllama.LlamaConfig.tiny()
    params = jax.tree_util.tree_map(
        np.asarray, jllama.llama_init(cfg, jax.random.PRNGKey(0)))
    model = tllama.llama_init(tllama.LlamaConfig.tiny(),
                              torch.Generator().manual_seed(0), "cpu")
    return (params, model.state_dict(), jllama.llama_partition_rules(),
            tllama.llama_partition_rules(), jllama.llama_param_axes,
            tllama.llama_param_axes)


@pytest.mark.parametrize("trees", [_gpt2_trees, _llama_trees])
def test_partition_rules_and_specs_match_jax(trees):
    jparams, state_dict, jr, tr, _jaxes, _taxes = trees()
    want = {name.removeprefix("params/"): jrules.spec_to_json(spec)
            for name, spec in zip(
                jrules.tree_paths(jparams),
                jax.tree_util.tree_leaves(
                    jrules.match_partition_rules(jr, jparams),
                    is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec)))}
    specs = trules.match_partition_rules(tr, state_dict)
    got = {trules.path_name(tuple(k.split("."))): trules.spec_to_json(v)
           for k, v in specs.items()}
    assert got == want
    # The nested flax layout names its leaves the same way.
    from ray_tpu_torch.models.convert import gpt2_params_to_numpy

    nested = trules.match_partition_rules(tr, gpt2_params_to_numpy(
        state_dict))
    assert trules.tree_paths(nested) == [f"params/{k}" for k in got]
    for spec in specs.values():
        assert trules.spec_from_json(trules.spec_to_json(spec)) == spec
    with pytest.raises(ValueError, match="partition rule not found"):
        trules.match_partition_rules(tr[:1], state_dict)


@pytest.mark.parametrize("trees", [_gpt2_trees, _llama_trees])
def test_logical_param_axes_match_jax(trees):
    jparams, state_dict, _jr, _tr, jaxes, taxes = trees()
    flat = dict(zip(jrules.tree_paths(jparams),
                    jax.tree_util.tree_leaves(jparams)))
    for name, leaf in state_dict.items():
        path = "/".join(name.split("."))
        assert taxes(path, leaf) == jaxes(path, flat["params/" + path])


@pytest.mark.parametrize("spec,sizes", [
    (("fsdp", "tensor"), {"fsdp": 2}), ((("data", "fsdp"), None),
                                        {"data": 2, "fsdp": 2}),
    ((("data", "fsdp"), "tensor"), {"fsdp": 4, "tensor": 1}),
    ((None, "tensor"), {}), ((), {"data": 2})])
def test_prune_spec(spec, sizes):
    want = jrules.spec_to_json(jrules.prune_spec(
        jax.sharding.PartitionSpec(*spec), sizes))
    got = trules.spec_to_json(trules.prune_spec(
        tsharding.PartitionSpec(*spec), sizes))
    assert got == want
