"""The port's data library (``ray_tpu_torch.data``) against the JAX
package's (``ray_tpu.data``) on the same inputs.

Every pipeline of ``tests/test_data_tune.py`` (its data half),
``test_data_plan.py``, ``test_data_relational.py`` and
``test_data_streaming.py`` runs through both packages: the JAX
package's runtime first (shut down before the port's starts), then one
port runtime for all of them, each with the streaming tests' small
object store (48 MiB).  Results are compared exactly, row for row and
in order: both packages define the same order for every pipeline here
(source order for streaming, seeded ``random.Random`` for shuffles,
blake2b key hashing for group partitions, sorted keys inside a
partition).  The pipelines that need no runtime (``groupby`` without
one, and ``test_data_input_pipeline.py``'s vectorized batching,
streaming split and prefetch lifecycle) run in both packages in this
process.  A dataset-fed trainer closes the file: the JAX package's
``DataParallelTrainer`` and the port's ``TorchTrainer`` (a world-2 gloo
gang) each give their two ranks the same shards.

Pipeline functions run in workers pickled by value; they reach their
package by name and touch no jax.
"""

import importlib
import threading

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
STORE = 48 * 1024 ** 2
PROGRAMS = {}          # name -> fn(pkg, tmp) run under a cluster
LOCAL_PROGRAMS = {}    # name -> fn(pkg, tmp) run without a runtime


def program(fn):
    PROGRAMS[fn.__name__] = fn
    return fn


def local_program(fn):
    LOCAL_PROGRAMS[fn.__name__] = fn
    return fn


def _mods(pkg):
    return (importlib.import_module(pkg),
            importlib.import_module(pkg + ".data"))


def plain(x):
    """Rows, batches and tables as plain Python, dtypes kept."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape,
                [plain(v) for v in x] if x.dtype == object else x.tolist())
    if isinstance(x, np.generic):
        return ("scalar", str(x.dtype), x.item())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    mod = type(x).__module__
    if mod.startswith("pandas"):
        return ("pandas", list(x.columns),
                {c: plain(x[c].to_numpy()) for c in x.columns})
    if mod.startswith("pyarrow"):
        return ("arrow", x.to_pylist())
    return x


def _items(n=200, mod=7):
    return [{"k": i % mod, "v": float(i)} for i in range(n)]


def _ints(data, n_rows, n_blocks):
    return data.from_items(list(range(n_rows)), parallelism=n_blocks)


def _indexed(data, n_blocks, rows_per_block):
    def make_source(i):
        def src():
            return data.build_block([{"i": i * rows_per_block + j}
                                     for j in range(rows_per_block)])
        return src

    return data.Dataset([make_source(i) for i in range(n_blocks)])


# ---------------------------------------------- test_data_tune.py (data)
@program
def range_count_take(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.range(100, parallelism=4)
    return ds.count(), ds.take(3), ds.num_blocks()


@program
def map_filter_pipeline(pkg, tmp):
    _, data = _mods(pkg)
    return (data.range(50, parallelism=4)
            .map(lambda r: {"x": r["id"] * 2})
            .filter(lambda r: r["x"] % 4 == 0)).take_all()


@program
def map_batches_numpy(pkg, tmp):
    _, data = _mods(pkg)
    return data.range(40, parallelism=2).map_batches(
        lambda b: {"y": b["id"].astype(np.float64) + 0.5},
        batch_format="numpy").take_all()


@program
def iter_batches_shapes(pkg, tmp):
    _, data = _mods(pkg)
    return list(data.range(100, parallelism=4).iter_batches(batch_size=32))


@program
def split_for_workers(pkg, tmp):
    _, data = _mods(pkg)
    shards = data.range(80, parallelism=4).split(4)
    return [s.count() for s in shards], [s.take_all() for s in shards]


@program
def from_items_and_shuffle(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items([{"v": i} for i in range(20)])
    return ds.random_shuffle(seed=42).take_all()


@program
def parquet_roundtrip(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.range(30, parallelism=2).map(
        lambda r: {"id": r["id"], "sq": r["id"] ** 2})
    ds.write_parquet(f"{tmp}/{pkg}-out")
    back = data.read_parquet(f"{tmp}/{pkg}-out")
    return back.count(), back.take_all()


# ------------------------------------------------------ test_data_plan.py
@program
def map_chain_fuses_to_one_stage(pkg, tmp):
    _, data = _mods(pkg)
    logical = importlib.import_module(pkg + ".data.logical")
    ds = (_ints(data, 40, 4).map(lambda x: x + 1)
          .filter(lambda x: x % 2 == 0)
          .map_batches(lambda b: b, batch_format="list"))
    return ([(s.kind, s.tasks, s.fused_ops)
             for s in logical.plan_stages(ds._plan)], ds.explain())


@program
def fusion_executes_one_task_per_block(pkg, tmp):
    import time

    _, data = _mods(pkg)
    state = importlib.import_module(pkg + ".util.state")

    def n_block_tasks():
        tasks = state._call("list_tasks", {"state": None, "name": None,
                                           "limit": 10000})["tasks"]
        return len([t for t in tasks
                    if "_process_block" in (t.get("name") or "")])

    before = n_block_tasks()
    ds = (_ints(data, 40, 4).map(lambda x: x + 1)
          .filter(lambda x: True)
          .map_batches(lambda b: b, batch_format="list"))
    rows = ds.take_all()
    deadline = time.time() + 15
    while n_block_tasks() - before < 4 and time.time() < deadline:
        time.sleep(0.25)
    time.sleep(0.5)         # a fifth task would land by now
    return sorted(rows), n_block_tasks() - before


@program
def union_concatenates_lazily(pkg, tmp):
    _, data = _mods(pkg)
    logical = importlib.import_module(pkg + ".data.logical")
    u = _ints(data, 10, 2).map(lambda x: x * 10).union(
        _ints(data, 5, 1).map(lambda x: -x))
    return (u.take_all(),
            [s.tasks for s in logical.plan_stages(u._plan)
             if s.kind == "read+map"],
            u.map(lambda x: x + 1).take_all())


@program
def zip_merges_rows(pkg, tmp):
    _, data = _mods(pkg)
    a = _ints(data, 8, 2).map(lambda x: {"a": x})
    b = _ints(data, 8, 2).map(lambda x: {"a": x * 2, "b": x * 3})
    t = _ints(data, 4, 1).zip(_ints(data, 4, 1).map(lambda x: -x))
    return a.zip(b).take_all(), t.take_all()


@program
def zip_block_count_mismatch_raises(pkg, tmp):
    _, data = _mods(pkg)
    try:
        _ints(data, 8, 2).zip(_ints(data, 8, 4))
    except ValueError as e:
        return "ValueError", str(e)
    return None


@program
def limit_streaming(pkg, tmp):
    _, data = _mods(pkg)
    ds = _ints(data, 100, 10).map(lambda x: x * 2)
    return (ds.limit(7).take_all(), ds.limit(0).take_all(),
            ds.limit(1000).count(),
            ds.limit(3).map(lambda x: x + 1).take_all())


@program
def limit_survives_barriers(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(list(range(100)), parallelism=10)
    return (ds.limit(5).repartition(2).take_all(),
            ds.limit(5).random_shuffle(seed=0).take_all(),
            ds.limit(5).sort(lambda x: -x).take_all(),
            ds.limit(5).aggregate(data.Sum()),
            [s.take_all() for s in ds.limit(6).split(2)])


@program
def limit_after_union_and_zip(pkg, tmp):
    _, data = _mods(pkg)
    a = _ints(data, 6, 2)
    b = _ints(data, 6, 2).map(lambda x: x + 100)
    return a.union(b).limit(8).take_all(), a.zip(b).limit(4).take_all()


@program
def iter_batches_prefetch(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(list(range(100)), parallelism=10).map(
        lambda x: x * 3)
    batches = [list(ds.iter_batches(batch_size=16, batch_format="list",
                                    prefetch_blocks=p)) for p in (0, 4)]
    it = ds.iter_batches(batch_size=8, batch_format="list",
                         prefetch_blocks=2)
    first = next(it)
    it.close()
    return batches, first


# ------------------------------------------------ test_data_relational.py
@program
def groupby_count_sum(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(_items(), parallelism=5)
    return ds.groupby("k").aggregate(data.Count(), data.Sum("v")).take_all()


@program
def groupby_mean_min_max_std(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(_items(120, mod=4), parallelism=3)
    return ds.groupby("k").aggregate(data.Mean("v"), data.Min("v"),
                                     data.Max("v"), data.Std("v")).take_all()


@program
def groupby_key_function(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.range(60, parallelism=4).map(
        lambda r: {"id": r["id"], "bucket": r["id"] // 20})
    return ds.groupby(lambda r: r["bucket"]).count().take_all()


@program
def map_groups(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(_items(60, mod=3), parallelism=4)
    return ds.groupby("k").map_groups(
        lambda rows: {"k": rows[0]["k"],
                      "span": max(r["v"] for r in rows)
                      - min(r["v"] for r in rows)}).take_all()


@program
def sort_ascending_descending(pkg, tmp):
    _, data = _mods(pkg)
    vals = np.random.default_rng(0).permutation(300).tolist()
    ds = data.from_items([{"v": int(v)} for v in vals], parallelism=6)
    return ([r["v"] for r in ds.sort("v").iter_rows()],
            [r["v"] for r in ds.sort("v", descending=True).iter_rows()])


@program
def sort_scalar_rows_and_key_fn(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items([9, 3, 7, 1, 8, 2, 0, 6, 4, 5], parallelism=3)
    return ds.sort().take_all(), ds.sort(lambda v: -v).take_all()


@program
def global_aggregate_and_unique(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(_items(100, mod=5), parallelism=4)
    return (ds.aggregate(data.Count(), data.Mean("v")), ds.mean("v"),
            ds.min("v"), ds.max("v"), ds.std("v"), ds.unique("k"))


@program
def sort_empty_and_single_block(pkg, tmp):
    _, data = _mods(pkg)
    return (data.from_items([], parallelism=1).sort().take_all(),
            data.from_items([3, 1, 2], parallelism=1).sort().take_all())


# ------------------------------------------------- test_data_streaming.py
@program
def out_of_core_streaming(pkg, tmp):
    """~96 MB of blocks through the 48 MiB store, in source order."""
    _, data = _mods(pkg)

    def widen(batch):
        n = len(batch["i"])
        return {"i": batch["i"], "payload": np.ones((n, 1024), np.float32)}

    seen, total, widths = 0, 0, set()
    for batch in _indexed(data, 24, 1000).map_batches(widen).iter_batches(
            batch_size=500):
        widths.add(batch["payload"].shape[1])
        seen += len(batch["i"])
        total += int(batch["i"].sum())
    return seen, total, sorted(widths)


@program
def backpressure_bounds_inflight(pkg, tmp):
    rt, data = _mods(pkg)
    ctx = importlib.import_module(pkg + ".data.context").DataContext \
        .get_current()
    old = (ctx.max_in_flight_bytes, ctx.initial_block_size_estimate)
    ctx.max_in_flight_bytes = 1   # forces the keep-one-running minimum
    ctx.initial_block_size_estimate = 1024

    @rt.remote
    class Gauge:
        def __init__(self):
            self.cur = self.peak = 0

        def enter(self):
            self.cur += 1
            self.peak = max(self.peak, self.cur)

        def exit(self):
            self.cur -= 1

        def get_peak(self):
            return self.peak

    gauge = Gauge.options(name="bp_gauge").remote()

    def make_source(i):
        def src():
            import time

            m = importlib.import_module(pkg)
            g = m.get_actor("bp_gauge")
            m.get(g.enter.remote())
            time.sleep(0.1)
            m.get(g.exit.remote())
            return importlib.import_module(pkg + ".data").build_block(
                [{"x": i}])
        return src

    try:
        ds = data.Dataset([make_source(i) for i in range(8)])
        count = ds.count()
        peak = rt.get(gauge.get_peak.remote())
    finally:
        ctx.max_in_flight_bytes, ctx.initial_block_size_estimate = old
        rt.kill(gauge)
    return count, peak <= 2


@program
def lazy_split_streams_into_training_loop(pkg, tmp):
    _, data = _mods(pkg)

    def make_source(i):
        def src():
            return importlib.import_module(pkg + ".data").build_block(
                [{"v": float(i * 10 + j)} for j in range(10)])
        return src

    ds = data.Dataset([make_source(i) for i in range(8)]).map_batches(
        lambda b: {"v": b["v"] * 2})
    shards = ds.split(4)
    epochs = [[[b["v"] for b in shard.iter_batches(batch_size=8)]
               for _epoch in range(2)] for shard in shards]
    return [s._materialized is None for s in shards], epochs


@program
def tensor_block_arrow_roundtrip(pkg, tmp):
    import pyarrow.parquet as pq

    _, data = _mods(pkg)

    def src():
        return importlib.import_module(pkg + ".data").build_block(
            [{"v": np.arange(3, dtype=np.float32) + i} for i in range(4)])

    ds = data.Dataset([src])
    ds.write_parquet(f"{tmp}/{pkg}-pq")
    table = pq.read_table(f"{tmp}/{pkg}-pq")
    frame = next(iter(ds.iter_batches(batch_size=4, batch_format="pandas")))
    return table.to_pylist(), frame


@program
def random_shuffle_is_distributed(pkg, tmp):
    _, data = _mods(pkg)
    ds = _indexed(data, 8, 200)
    out = ds.random_shuffle(seed=7)
    return (out._materialized is None, [r["i"] for r in out.iter_rows()],
            [r["i"] for r in ds.random_shuffle(seed=7).iter_rows()],
            [r["i"] for r in ds.random_shuffle(seed=8).iter_rows()])


@program
def repartition_without_driver(pkg, tmp):
    _, data = _mods(pkg)
    out = _indexed(data, 3, 100).repartition(5)
    return (out._materialized is None, out.num_blocks(),
            [r["i"] for r in out.iter_rows()])


@program
def uneven_split_remote(pkg, tmp):
    _, data = _mods(pkg)
    ds = _indexed(data, 3, 100)
    return [[[r["i"] for r in s.iter_rows()] for s in ds.split(2, equal=eq)]
            for eq in (True, False)]


# ------------------------------------------------------ without a runtime
@local_program
def groupby_local_mode_no_runtime(pkg, tmp):
    _, data = _mods(pkg)
    ds = data.from_items(_items(40, mod=4), parallelism=2)
    return (ds.groupby("k").sum("v").take_all(),
            ds.sort("v", descending=True).take_all()[:3],
            ds.groupby("k").map_groups(lambda rows: len(rows)).take_all(),
            ds.random_shuffle(seed=3).take_all(),
            ds.repartition(3).num_blocks())


def _run_all(pkg: str, tmp: str) -> dict:
    rt = importlib.import_module(pkg)
    out = {name: plain(fn(pkg, tmp)) for name, fn in LOCAL_PROGRAMS.items()}
    rt.init(mode="cluster", num_cpus=4,
            config={"object_store_memory_bytes": STORE})
    try:
        # The task count reads the controller's task records, a bounded
        # sink the other pipelines' tasks would fill: it runs first.
        first = "fusion_executes_one_task_per_block"
        for name, fn in sorted(PROGRAMS.items(),
                               key=lambda kv: kv[0] != first):
            try:
                out[name] = plain(fn(pkg, tmp))
            except Exception as e:  # noqa: BLE001 — compared below
                out[name] = ("raised", type(e).__name__, str(e))
        out["trainer_shards"] = _trainer_shards(pkg, tmp)
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data"))
    return {pkg: _run_all(pkg, tmp) for pkg in PACKAGES}


@pytest.mark.parametrize("name", sorted(PROGRAMS) + sorted(LOCAL_PROGRAMS))
def test_pipeline_equals_jax(results, name):
    port = results["ray_tpu_torch"][name]
    assert not (isinstance(port, tuple) and port[:1] == ("raised",)) \
        or name == "zip_block_count_mismatch_raises", port
    assert port == results["ray_tpu"][name]


def test_pipelines_give_the_expected_values(results):
    """The JAX tests' own assertions, on the port's results."""
    r = results["ray_tpu_torch"]
    assert r["range_count_take"] == (100, [{"id": 0}, {"id": 1}, {"id": 2}],
                                     4)
    assert [x["x"] for x in r["map_filter_pipeline"]] == [
        i * 2 for i in range(50) if (i * 2) % 4 == 0]
    counts, rows = r["split_for_workers"]
    assert counts == [20] * 4
    assert sorted(x["id"] for s in rows for x in s) == list(range(80))
    shuffled = [x["v"] for x in r["from_items_and_shuffle"]]
    assert sorted(shuffled) == list(range(20)) and shuffled != list(range(20))
    assert r["parquet_roundtrip"][0] == 30
    assert r["map_chain_fuses_to_one_stage"][0] == [("read+map", 4, 3)]
    assert r["fusion_executes_one_task_per_block"] == (list(range(1, 41)), 4)
    assert r["union_concatenates_lazily"][1] == [3]
    assert r["zip_merges_rows"][0][3] == {"a": 3, "a_1": 6, "b": 9}
    assert r["zip_block_count_mismatch_raises"][0] == "ValueError"
    assert r["limit_streaming"] == ([0, 2, 4, 6, 8, 10, 12], [], 100,
                                    [1, 3, 5])
    assert sorted(r["limit_survives_barriers"][2]) == [0, 1, 2, 3, 4]
    assert r["limit_survives_barriers"][3] == {"sum()": 10}
    batches, first = r["iter_batches_prefetch"]
    assert batches[0] == batches[1] and len(first) == 8
    assert sorted(x["k"] for x in r["groupby_count_sum"]) == list(range(7))
    asc, desc = r["sort_ascending_descending"]
    assert asc == list(range(300)) and desc == asc[::-1]
    assert r["sort_empty_and_single_block"] == ([], [1, 2, 3])
    assert sorted(r["global_aggregate_and_unique"][5]) == [0, 1, 2, 3, 4]
    n = 24 * 1000
    assert r["out_of_core_streaming"] == (n, n * (n - 1) // 2, [1024])
    assert r["backpressure_bounds_inflight"] == (8, True)
    lazy, epochs = r["lazy_split_streams_into_training_loop"]
    assert lazy == [True] * 4
    assert [sum(len(b[3]) for e in s for b in e) for s in epochs] == [40] * 4
    flag, ids, again, other = r["random_shuffle_is_distributed"]
    assert flag and sorted(ids) == list(range(1600)) and ids == again
    assert ids != list(range(1600)) and other != ids
    assert r["repartition_without_driver"][1] == 5
    for shards in r["uneven_split_remote"]:
        assert [len(s) for s in shards] == [150, 150]
        assert sorted(i for s in shards for i in s) == list(range(300))
    assert r["trainer_shards"] == [list(range(0, 20)), list(range(20, 40))]


# ---------------------------------------------- a dataset-fed trainer
def _shard_loop(config):
    """jax-free: each rank writes the ids of its shard to a file (the
    trainer's history keeps rank 0's reports only)."""
    import json

    train = importlib.import_module(config["pkg"] + ".train")
    shard = train.get_dataset_shard("train")
    ids = [int(i) for b in shard.iter_batches(batch_size=8)
           for i in b["id"]]
    rank = train.get_world_rank()
    with open(f"{config['out']}-rank{rank}.json", "w") as f:
        json.dump(ids, f)
    train.report({"rows_seen": len(ids)})


def _trainer_shards(pkg: str, tmp: str):
    """The JAX package's ``DataParallelTrainer`` (its ``JaxTrainer``
    would join jax.distributed, which this host cannot) and the port's
    ``TorchTrainer`` over 2 workers: each rank's rows."""
    import json

    _, data = _mods(pkg)
    train = importlib.import_module(pkg + ".train")
    cls = train.TorchTrainer if pkg == "ray_tpu_torch" \
        else train.DataParallelTrainer
    out = f"{tmp}/{pkg}-shard"
    result = cls(_shard_loop, train_loop_config={"pkg": pkg, "out": out},
                 scaling_config=train.ScalingConfig(num_workers=2),
                 run_config=train.RunConfig(name="shards",
                                            storage_path=f"{tmp}/{pkg}-t"),
                 datasets={"train": data.range(40, parallelism=4)}).fit()
    assert result.error is None, result.error
    assert result.metrics == {"rows_seen": 20}
    ranks = []
    for rank in range(2):
        with open(f"{out}-rank{rank}.json") as f:
            ranks.append(json.load(f))
    return ranks


# ------------------------------------- test_data_input_pipeline.py cases
def _dataset_cls(pkg):
    return importlib.import_module(pkg + ".data.dataset").Dataset


def _scalar_dataset(pkg, sizes):
    """Blocks of dict rows {"id": int, "x": float} of the given sizes."""
    data = importlib.import_module(pkg + ".data")
    blocks, n = [], 0
    for s in sizes:
        blocks.append(data.build_block(
            [{"id": n + j, "x": float(n + j) / 2} for j in range(s)]))
        n += s
    return _dataset_cls(pkg)._from_materialized(blocks, 4)


def _tensor_dataset(pkg, sizes, width=3):
    blocks, n = [], 0
    for s in sizes:
        ids = np.arange(n, n + s)
        blocks.append({"id": ids, "vec": np.stack(
            [np.full(width, i, np.float32) for i in ids])})
        n += s
    return _dataset_cls(pkg)._from_materialized(blocks, 4)


def _row_wise_batches(pkg, ds, batch_size, batch_format, drop_last):
    """The row-wise reference of the JAX package's test: explode blocks
    into rows, slice per batch, rebuild a block per batch."""
    data = importlib.import_module(pkg + ".data")
    buf, out = [], []
    for block in ds._iter_blocks():
        buf.extend(data.BlockAccessor.for_block(block).iter_rows())
        while len(buf) >= batch_size:
            chunk, buf = buf[:batch_size], buf[batch_size:]
            out.append(_dataset_cls(pkg)._format_batch(chunk, batch_format))
    if buf and not drop_last:
        out.append(_dataset_cls(pkg)._format_batch(buf, batch_format))
    return out


def _both(make, fn):
    """``fn(pkg, make(pkg))`` in both packages, as plain values."""
    return {pkg: plain(fn(pkg, make(pkg))) for pkg in PACKAGES}


@pytest.mark.parametrize("sizes,batch_size", [
    ([7, 5, 9], 4), ([8, 8], 4), ([3, 1, 2], 10), ([5], 2)])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("kind", ["scalar", "tensor"])
def test_vectorized_batches_equal_jax_and_row_wise(sizes, batch_size,
                                                   drop_last, kind):
    make = (lambda pkg: _scalar_dataset(pkg, sizes)) if kind == "scalar" \
        else (lambda pkg: _tensor_dataset(pkg, sizes))
    got = _both(make, lambda pkg, ds: list(ds.iter_batches(
        batch_size=batch_size, batch_format="numpy", drop_last=drop_last)))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    want = _row_wise_batches("ray_tpu_torch", make("ray_tpu_torch"),
                             batch_size, "numpy", drop_last)
    # The vectorized batches equal the row-wise ones value for value
    # (a row-wise batch of one-row tensor blocks keeps its dtype).
    assert [{k: v[3] for k, v in b.items()} for b in got["ray_tpu_torch"]] \
        == [{k: np.asarray(v).tolist() for k, v in b.items()} for b in want]


@pytest.mark.parametrize("fmt,batch_size", [("pandas", 5), ("arrow", 3),
                                            ("rows", 3)])
def test_other_batch_formats_equal_jax(fmt, batch_size):
    got = _both(lambda pkg: _scalar_dataset(pkg, [7, 6]),
                lambda pkg, ds: list(ds.iter_batches(
                    batch_size=batch_size, batch_format=fmt)))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"] == plain(_row_wise_batches(
        "ray_tpu_torch", _scalar_dataset("ray_tpu_torch", [7, 6]),
        batch_size, fmt, False))


def test_scalar_value_rows_batch_as_a_value_column():
    got = _both(lambda pkg: _dataset_cls(pkg)._from_materialized(
        [[1, 2, 3], [4, 5]], 4),
        lambda pkg, ds: list(ds.iter_batches(batch_size=2)))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert [b["value"][3] for b in got["ray_tpu_torch"]] == [[1, 2], [3, 4],
                                                             [5]]


def test_batches_are_read_only_views_inside_blocks():
    ds = _tensor_dataset("ray_tpu_torch", [8], width=2)
    block = ds._materialized[0]
    batches = list(ds.iter_batches(batch_size=4, batch_format="numpy"))
    assert batches[0]["vec"].base is block["vec"]
    assert not batches[0]["vec"].flags.writeable
    with pytest.raises(ValueError):
        batches[0]["vec"][0, 0] = 99.0
    assert block["vec"].flags.writeable


def test_streaming_split_equals_jax():
    def shards(pkg, ds):
        its = ds.streaming_split(2)
        return ([it.num_blocks() for it in its],
                [list(it.iter_batches(batch_size=3, prefetch_blocks=0))
                 for it in its])

    got = _both(lambda pkg: _scalar_dataset(pkg, [4] * 5), shards)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    counts, batches = got["ray_tpu_torch"]
    assert counts == [3, 2]
    assert sorted(i for s in batches for b in s for i in b["id"][3]) == \
        list(range(20))


def test_streaming_split_validates_hints():
    ds = _scalar_dataset("ray_tpu_torch", [4, 4])
    with pytest.raises(ValueError):
        ds.streaming_split(2, locality_hints=["onlyone"])
    with pytest.raises(ValueError):
        ds.streaming_split(0)
    it = ds.streaming_split(2, locality_hints=["aa" * 16, None])[0]
    assert it.locality_node == "aa" * 16


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("rt-data-prefetch") and t.is_alive()]


@pytest.mark.parametrize("abandon", [True, False])
def test_prefetch_feeder_is_joined(abandon):
    """Abandoned mid-stream or run to its end, the block prefetcher's
    feeder thread is gone when the iterator is."""
    ds = _scalar_dataset("ray_tpu_torch", [8] * 6 if abandon else [4, 4])
    it = ds.iter_batches(batch_size=4, prefetch_blocks=1 if abandon else 2)
    if abandon:
        next(it)
        it.close()
    else:
        assert len(list(it)) == 2
    assert _prefetch_threads() == []
