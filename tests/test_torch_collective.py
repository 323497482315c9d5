"""The port's collective groups (``ray_tpu_torch.collective``) on gloo.

The cases of ``tests/test_collective.py`` that need no runtime (every
reduce op of allreduce, allgather, broadcast, reducescatter, barrier,
send/recv, rank and size, name reuse after destroy), run by 2 and 4
spawned ranks over a ``file://`` rendezvous in ``tmp_path``.  Each rank
also joins two gloo groups of half the gang's size at once (the halves
and the strided pairs), each a process group of its own beside the
gang's.  Each
world is one spawn (``ray_tpu_torch.testing.collective_cases``); the
results must equal numpy's exactly.
"""

import numpy as np
import pytest

from ray_tpu_torch import collective as col
from ray_tpu_torch.dryrun import spawn
from ray_tpu_torch.testing import collective_cases


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    runs = spawn(collective_cases, n, timeout=120,
                 workdir=str(tmp_path_factory.mktemp(f"col{n}")))
    return n, runs


def _each(world):
    n, runs = world
    return n, list(enumerate(runs))


def test_allreduce_sum(world):
    n, ranks = _each(world)
    for _r, out in ranks:
        np.testing.assert_array_equal(out["allreduce_sum"],
                                      np.full(4, n * (n + 1) / 2))


@pytest.mark.parametrize("op,reduce", [
    ("prod", np.prod), ("max", np.max), ("min", np.min),
    ("mean", np.mean)])
def test_allreduce_ops(world, op, reduce):
    n, ranks = _each(world)
    want = np.full(4, reduce(np.arange(1, n + 1, dtype=np.float32)),
                   np.float32)
    for _r, out in ranks:
        np.testing.assert_array_equal(out[f"allreduce_{op}"], want)


def test_allgather_in_rank_order_and_input_untouched(world):
    n, ranks = _each(world)
    want = np.stack([np.full(2, 10.0 + r, np.float32) for r in range(n)])
    for _r, out in ranks:
        np.testing.assert_array_equal(out["allgather"], want)
        assert out["input_untouched"] == 1.0


def test_broadcast_from_rank_one(world):
    _n, ranks = _each(world)
    for _r, out in ranks:
        np.testing.assert_array_equal(out["broadcast"], np.full(3, 101.0))


@pytest.mark.parametrize("case", ["reducescatter", "reducescatter_mean",
                                  "reducescatter_uneven"])
def test_reducescatter(world, case):
    n, ranks = _each(world)
    if case == "reducescatter_uneven":
        total = sum(np.arange(10, dtype=np.float32).reshape(5, 2) + r
                    for r in range(n))
    else:
        total = np.full((n, 3), n * (n + 1) / 2, np.float32)
        if case == "reducescatter_mean":
            total = total / n
    for r, out in ranks:
        np.testing.assert_array_equal(out[case],
                                      np.array_split(total, n, axis=0)[r])


def test_barrier_rank_and_size(world):
    n, ranks = _each(world)
    for r, out in ranks:
        np.testing.assert_array_equal(out["rank_size"], [r, n])


def test_send_recv_ring_carries_shape_and_dtype(world):
    n, ranks = _each(world)
    for r, out in ranks:
        src = (r - 1) % n
        want = np.arange(3, dtype=np.float64).reshape(1, 3) + src
        assert out["p2p"].dtype == np.float64
        np.testing.assert_array_equal(out["p2p"], want)


def test_second_group_and_name_reuse_after_destroy(world):
    n, ranks = _each(world)
    for _r, out in ranks:
        np.testing.assert_array_equal(out["side_sum"], np.full(4, n))
        assert out["destroyed_rank"] == -1
        np.testing.assert_array_equal(out["reused_sum"], np.full(4, 2 * n))


def test_backend_names():
    """The mirror of tests/test_collective.py's nccl rejection."""
    assert col.Backend.parse("nccl") is col.Backend.NCCL
    assert col.Backend.parse("gloo") is col.Backend.CPU
    assert col.Backend.parse("cpu").torch_name == "gloo"
    with pytest.raises(ValueError) as ei:
        col.Backend.parse("xla")
    assert "nccl" in str(ei.value).lower()
    with pytest.raises(ValueError):
        col.Backend.parse("mpi")


def test_runtime_declared_groups_wait_for_the_runtime_slice():
    with pytest.raises(NotImplementedError, match="runtime slice"):
        col.create_collective_group([], 2, [0, 1])
    with pytest.raises(RuntimeError, match="not initialized"):
        col.allreduce(np.ones(1), "never-joined")
    assert col.get_rank("never-joined") == -1
    with pytest.raises(ValueError):
        col.init_collective_group(2, 2, group_name="bad-rank")


@pytest.mark.parametrize("name", ["halves", "strided"])
def test_groups_of_half_the_gang_size(world, name):
    """Each rank sits in the gang and in a half-size group of its own
    rendezvous; every op of the half-size group sees only its members,
    and the gang's group still works beside it."""
    n, ranks = _each(world)
    half = n // 2
    groups = ([list(range(half)), list(range(half, n))] if name == "halves"
              else [list(range(0, n, 2)), list(range(1, n, 2))])
    for r, out in ranks:
        members = next(m for m in groups if r in m)
        np.testing.assert_array_equal(out[f"{name}_rank_size"],
                                      [members.index(r), half])
        np.testing.assert_array_equal(
            out[f"{name}_allreduce"],
            np.full(4, sum(m + 1 for m in members), np.float32))
        np.testing.assert_array_equal(
            out[f"{name}_allgather"],
            np.stack([np.full(2, m, np.float32) for m in members]))
        np.testing.assert_array_equal(out[f"{name}_broadcast"],
                                      [float(members[-1])])
        np.testing.assert_array_equal(out["gang_after_halves"],
                                      np.full(4, n, np.float32))
