"""The port's single-process training session against the JAX
package's ``TrainSession``: the per-step gauges under one fake clock,
device prefetch, the session's sharded checkpoint round trip, and what
waits for the runtime slice."""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.train.config import TelemetryConfig as JaxTelemetryConfig
from ray_tpu.train.session import TrainSession as JaxTrainSession
from ray_tpu.util import metrics as jax_metrics
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.config import TelemetryConfig
from ray_tpu_torch.train.session import TrainSession, iter_device_batches
from ray_tpu_torch.util import goodput, metrics

RANKS = dict(world_rank=0, world_size=1, local_rank=0, local_world_size=1,
             node_rank=0)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_registries():
    for reg in (metrics.registry(), jax_metrics.registry()):
        reg.clear()
    yield
    for reg in (metrics.registry(), jax_metrics.registry()):
        reg.clear()


def _gauges(mod):
    return {s["name"]: s["series"] for s in mod.registry().snapshot()}


def _drive(session_cls, tel, steps=((0.25, {"loss": 0.9}),
                                    (0.5, {"loss": 0.8, "tokens": 256}))):
    clk = FakeClock()
    sess = session_cls(**RANKS, experiment_name="mfu", telemetry=tel)
    sess._clock = clk
    sess.report({"loss": 1.0})          # establishes the cadence
    for dt, m in steps:
        clk.advance(dt)
        sess.report(m)


def test_mfu_gauge_matches_hand_computed_figure():
    """tests/test_telemetry.py's case on the port, and the port's series
    equal to JAX's ``TrainSession`` under the same clock."""
    kw = dict(model_flops_per_token=2000.0, tokens_per_step=512.0,
              peak_flops_per_device=1e6, devices_per_worker=1)
    _drive(TrainSession, TelemetryConfig(**kw), steps=((0.25, {}),))
    got = _gauges(metrics)
    assert got["rt_train_tokens_per_sec"][0]["value"] == \
        pytest.approx(512.0 / 0.25)
    assert got["rt_train_mfu"][0]["value"] == \
        pytest.approx(2048.0 * 2000.0 / 1e6)
    assert got["rt_train_step"][0]["value"] == 2.0
    hist = got["rt_train_step_time_seconds"][0]["hist"]
    assert (hist["count"], hist["sum"]) == (1, pytest.approx(0.25))
    metrics.registry().clear()
    for cls, cfg in ((TrainSession, TelemetryConfig),
                     (JaxTrainSession, JaxTelemetryConfig)):
        _drive(cls, cfg(**kw))
    assert _gauges(metrics) == _gauges(jax_metrics)


def test_mfu_gauge_absent_without_declared_flops_or_peak(monkeypatch):
    """No declared FLOPs: no MFU gauge, step time regardless (as in
    JAX).  A declared figure on a device without a known peak (the
    CPU): achieved FLOP/s but no MFU gauge."""
    monkeypatch.delenv("RT_PEAK_FLOPS_PER_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TrainSession, JaxTrainSession):
        _drive(cls, None)
    assert _gauges(metrics) == _gauges(jax_metrics)
    names = set(_gauges(metrics))
    assert "rt_train_step_time_seconds" in names
    assert "rt_train_mfu" not in names
    metrics.registry().clear()
    _drive(TrainSession, TelemetryConfig(model_flops_per_token=10.0))
    names = set(_gauges(metrics))
    assert "rt_train_achieved_flops_per_sec" in names
    assert "rt_train_mfu" not in names


def _batches(n, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 100, (rows, 9)),
             "mask": {"m": rng.random((rows, 9)).astype(np.float32)}}
            for _ in range(n)]


def test_iter_device_batches_in_order_and_equal():
    src = _batches(7)
    sess = TrainSession(**RANKS, experiment_name="prefetch")
    got = list(sess.iter_device_batches(iter(src), depth=2, device="cpu"))
    assert len(got) == len(src)
    for g, s in zip(got, src):
        assert isinstance(g["tokens"], torch.Tensor)
        assert np.array_equal(g["tokens"].numpy(), s["tokens"])
        assert np.array_equal(g["mask"]["m"].numpy(), s["mask"]["m"])
    # An explicit transfer replaces the placement.
    out = list(iter_device_batches(iter(src), transfer=lambda b: b["tokens"]))
    assert all(o is s["tokens"] for o, s in zip(out, src))


def test_iter_device_batches_charges_data_stall_and_stops_its_feeder():
    """A slow source starves the loop: the waits go to ``data_stall`` and
    the data-wait histogram.  A loop that stops early stops the feeder."""
    def slow():
        for b in _batches(3):
            time.sleep(0.05)
            yield b

    goodput.reset()
    assert len(list(iter_device_batches(slow(), device="cpu"))) == 3
    stall = goodput.ledger().snapshot()["seconds"]["data_stall"]
    assert stall >= 0.05
    hist = _gauges(metrics)["rt_train_data_wait_seconds"][0]["hist"]
    assert hist["count"] >= 1

    def endless():
        while True:
            yield _batches(1)[0]

    before = threading.active_count()
    it = iter_device_batches(endless(), device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_sharded_checkpoint_round_trip_through_the_session(tmp_path):
    """``save_sharded_checkpoint`` commits ``checkpoint_<step>`` under the
    storage dir, reports the step (the step gauge) and becomes the
    session's checkpoint; ``load_sharded_checkpoint`` gives the tree back
    bit for bit; the save and restore ran in the goodput ``checkpoint``
    phase with their series."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)},
            "step": np.int64(3)}
    goodput.reset()
    sess = TrainSession(**RANKS, experiment_name="ckpt",
                        storage_dir=str(tmp_path), attempt_id="a1")
    assert sess.load_sharded_checkpoint() is None
    res = sess.save_sharded_checkpoint(tree, step=3, metrics={"loss": 1.0})
    assert res["committed"]
    assert sess.get_checkpoint().path == str(tmp_path / "checkpoint_000003")
    assert sess.get_checkpoint().manifest_meta()["step"] == 3
    back = sess.load_sharded_checkpoint()
    for name in ("w", "b"):
        got, want = back["params"][name], tree["params"][name]
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert int(back["step"]) == 3
    series = _gauges(metrics)
    assert series["rt_train_step"][0]["value"] == 3.0
    assert series["rt_checkpoint_bytes"][0]["value"] == res["bytes"]
    assert series["rt_checkpoint_shards"][0]["value"] == res["files"]
    for name in ("rt_train_checkpoint_save_seconds",
                 "rt_train_checkpoint_restore_seconds"):
        assert series[name][0]["tags"] == {"sharded": "1"}
    assert goodput.ledger().snapshot()["seconds"]["checkpoint"] > 0
    with session_mod.checkpoint_on_notice():
        assert goodput.current_phase() == "checkpoint_on_notice"
        sess.save_sharded_checkpoint(tree, step=4, report=False)
    assert "rt_train_ckpt_on_notice_seconds" in _gauges(metrics)


class _Queue:
    """A stand-in for the trainer's result-queue actor handle."""

    def __init__(self):
        self.items, self.interrupt = [], None
        self.push = _Method(self.items.append)
        self.interrupt_info = _Method(lambda: self.interrupt)


class _Method:
    def __init__(self, fn):
        self.fn = fn

    def remote(self, *args):
        import ray_tpu_torch

        return ray_tpu_torch.put(self.fn(*args))


def test_what_waits_for_the_runtime_raises():
    """The result queue is the runtime's now: reports reach it and the
    interruption poll reads it; only dataset shards still raise."""
    import ray_tpu_torch

    ray_tpu_torch.init(mode="local")
    try:
        q = _Queue()
        sess = TrainSession(**RANKS, experiment_name="q", result_queue=q)
        sess.report({"step": 3})
        assert q.items == [{"rank": 0, "metrics": {"step": 3}, "index": 1,
                            "checkpoint_path": None}]
        assert not sess.interrupted()
        q.interrupt = {"reason": "drain", "deadline": 1.0}
        sess._last_interrupt_poll = -1e9
        assert sess.interruption() == q.interrupt
    finally:
        ray_tpu_torch.shutdown()
    sess = session_mod.init_session(**RANKS, experiment_name="x")
    try:
        assert session_mod.get_session() is sess
        assert not session_mod.interrupted()
        assert session_mod.get_world_size() == 1
        with pytest.raises(KeyError, match="no dataset shard 'train'"):
            session_mod.get_dataset_shard()
        session_mod.report({"step": 7})
        assert _gauges(metrics)["rt_train_step"][0]["value"] == 7.0
    finally:
        session_mod.shutdown_session()
    with pytest.raises(RuntimeError):
        session_mod.get_session()
