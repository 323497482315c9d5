"""The port's xprof plane against the JAX package's.

The pure layer (roofline, collective attribution, wire bytes, the
report and its text) is a copy and must give JAX's outputs on the
inputs of tests/test_xprof.py.  The torch layer counts one real call of
a step (``harvest_step``): its FLOPs must equal an independent count of
the step's matrix products and attention kernels exactly, and JAX's
``cost_analysis`` figure for the same step is printed beside it (XLA
also counts elementwise FLOPs; the ratio is held to the band measured
on the CPU, 0.80-0.90).  Telemetry on and off must give the same
losses and parameters bit for bit.  A 2x2 fsdp x tensor gloo world
must register collective bytes on both axes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from ray_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from ray_tpu.train.train_step import TrainState as JaxTrainState
from ray_tpu.train.train_step import make_optimizer as jax_make_optimizer
from ray_tpu.train.train_step import make_train_step as jax_make_train_step
from ray_tpu.util import xprof as jax_xprof
from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss_fn
from ray_tpu_torch.ops.flash_attention import flash_cost
from ray_tpu_torch.train import config as train_config
from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                            make_sharded_train_step)
from ray_tpu_torch.util import goodput, metrics, xprof

SIZES = {"fsdp": 2, "tensor": 2}
COLLS = [{"op": "all-reduce", "bytes": 100.0, "groups": [[0, 1], [2, 3]]},
         {"op": "all-gather", "bytes": 100.0, "groups": [[0, 2], [1, 3]]},
         {"op": "all-reduce", "bytes": 40.0, "groups": []},
         {"op": "all-reduce", "bytes": 9.0,
          "groups": [[0], [1], [2], [3]]},
         {"op": "reduce-scatter", "bytes": 25.0, "groups": [[0, 1, 2, 3]]}]
PROGRAMS = {
    "train_step": {
        "flops": 1e12, "bytes": 2e10,
        "memory": {"argument": 1e9, "temp": 5e8, "peak": 1.5e9},
        "collectives": {
            "fsdp": {"bytes": 2e9, "by_op": {"all-gather": 2e9}},
            "tensor": {"bytes": 1e9, "by_op": {"all-reduce": 1e9}}},
        "compiles": 1, "compile_seconds": 12.5},
    "llm_decode": {"flops": 3e9, "bytes": 3e9, "compiles": 2,
                   "compile_seconds": 1.0}}


@pytest.fixture(autouse=True)
def _clean():
    metrics.registry().clear()
    xprof._reset_local()
    yield
    metrics.registry().clear()
    xprof._reset_local()


# ----------------------------------------------------- the pure layer
@pytest.mark.parametrize("args", [
    (1e12, 1e11, 1e14, 1e12), (1e14, 1e11, 1e14, 1e12),
    (1e12, 1e10, 2e14, 1e12), (0.0, 0.0, 1e14, 1e12)])
def test_roofline_matches_jax(args):
    assert xprof.roofline(*args) == jax_xprof.roofline(*args)


@pytest.mark.parametrize("groups", [
    [[0, 1], [2, 3]], [[0, 2], [1, 3]], [[0, 1, 2, 3]],
    [[0], [1], [2], [3]], [[0, 9]]])
def test_attribute_axes_matches_jax(groups):
    for sizes in (SIZES, None, {"dcn": 1, "fsdp": 2, "seq": 1,
                                "tensor": 2}):
        assert xprof.attribute_axes(groups, sizes) == \
            jax_xprof.attribute_axes(groups, sizes)


def test_wire_bytes_and_collective_summary_match_jax():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        for g in (1, 2, 4):
            assert xprof.collective_wire_bytes(op, 100.0, g) == \
                jax_xprof.collective_wire_bytes(op, 100.0, g)
    got = xprof.summarize_collectives(COLLS, SIZES)
    assert got == jax_xprof.summarize_collectives(COLLS, SIZES)
    assert got["tensor"]["bytes"] == pytest.approx(100.0)
    assert "none" not in got


def test_build_and_render_report_match_jax():
    """Equal rows and text, but for the peaks' device label (the JAX
    package names a TPU generation, the port the CUDA device) and the
    report's time stamp."""
    measured = {"train_step": {"step_time_s": 0.05},
                "llm_decode": {"achieved_flops_per_sec": 1e11}}
    kw = dict(peak_flops=100e12, peak_hbm=1e12, interconnect=100e9)
    got = xprof.build_report(PROGRAMS, measured, **kw)
    want = jax_xprof.build_report(PROGRAMS, measured, **kw)
    assert got["programs"] == want["programs"]
    assert got["peaks"] == {**{k: v for k, v in want["peaks"].items()
                               if k != "gen"}, "device": ""}
    row = got["programs"]["train_step"]
    assert row["mfu"] == pytest.approx(0.2)
    assert row["decomposition"]["shares"]["collective"] == \
        pytest.approx(0.6)
    got["device_memory"] = want["device_memory"] = {
        "w": {"0": {"used": 8e9, "peak": 9e9, "limit": 80e9}}}
    text, want_text = (xprof.render_report(got),
                       jax_xprof.render_report(want))
    assert text.splitlines()[1:] == want_text.splitlines()[1:]
    for needle in ("train_step", "roofline", "axis fsdp", "decomposition",
                   "compiles", "Device memory"):
        assert needle in text


# ------------------------------------------------------------- peaks
def test_peak_tables_mirror_train_config():
    assert xprof.PEAK_FLOPS_BY_DEVICE == train_config.PEAK_FLOPS_BY_DEVICE
    assert xprof.PEAK_HBM_BYTES_PER_SEC_BY_DEVICE == \
        train_config.PEAK_HBM_BYTES_PER_SEC_BY_DEVICE


@pytest.mark.parametrize("name,flops,hbm,link", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 450e9),
    ("NVIDIA A100-SXM4-80GB", 0.0, 0.0, 0.0),
    (None, 0.0, 0.0, 0.0)])          # no CUDA device
def test_peak_resolution_by_device_name(monkeypatch, name, flops, hbm,
                                        link):
    """The H100 resolves to its data-sheet peaks; an unknown card and
    the CPU to 0 (no MFU gauge), in xprof and in TelemetryConfig."""
    for env in ("RT_PEAK_FLOPS_PER_DEVICE", "RT_PEAK_HBM_BYTES_PER_SEC",
                "RT_INTERCONNECT_BYTES_PER_SEC"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: name is not None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert xprof.resolve_peak_flops() == flops
    assert xprof.resolve_peak_hbm() == hbm
    assert xprof.resolve_interconnect() == link
    assert train_config.TelemetryConfig().resolved_peak_flops() == flops
    assert train_config.TelemetryConfig(
        peak_flops_per_device=5.0).resolved_peak_flops() == 5.0


def test_peak_resolution_env_overrides(monkeypatch):
    monkeypatch.setenv("RT_PEAK_FLOPS_PER_DEVICE", "123e12")
    monkeypatch.setenv("RT_PEAK_HBM_BYTES_PER_SEC", "456e9")
    monkeypatch.setenv("RT_INTERCONNECT_BYTES_PER_SEC", "7e9")
    assert xprof.resolve_peak_flops() == pytest.approx(123e12)
    assert xprof.resolve_peak_hbm() == pytest.approx(456e9)
    assert xprof.resolve_interconnect() == pytest.approx(7e9)
    assert train_config.TelemetryConfig().resolved_peak_flops() == \
        pytest.approx(123e12)


def test_cluster_report_waits_for_the_runtime():
    with pytest.raises(NotImplementedError, match="runtime"):
        xprof.cluster_report()


@pytest.mark.parametrize("kernel,ms,by", [
    ("flash_fwd", 0.0303, "bytes"), ("flash_dkv", 0.0522, "operations"),
    ("flash_dq", 0.0391, "operations")])
def test_flash_cost_gives_the_kernel_bounds(kernel, ms, by):
    """At the main-path shape (B*H 192, T 1024, D 64, bf16, causal)
    ``flash_cost`` gives the bounds ``chip_smoke.bound`` gave before it
    used the formula (PERF.md's kernel table), and ``bound`` reads it."""
    import chip_smoke

    flops, nbytes = flash_cost(kernel, 192, 1024, 64, True)
    pairs, tile, rows = 1024 * 1025 // 2, 192 * 1024 * 64 * 2, 192 * 1024 * 4
    assert (flops, nbytes) == {
        "flash_fwd": (4 * 64 * pairs * 192, 4 * tile + rows),
        "flash_dkv": (8 * 64 * pairs * 192, 6 * tile + 2 * rows),
        "flash_dq": (6 * 64 * pairs * 192, 5 * tile + 2 * rows)}[kernel]
    t_ops, t_bytes = flops / 989e12, nbytes / 3.35e12
    assert round(1e3 * max(t_ops, t_bytes), 4) == ms
    assert ("operations" if t_ops >= t_bytes else "bytes") == by
    got_ms, got_by, got_flops = chip_smoke.bound(kernel, 192, 1024, 64, True)
    assert (round(got_ms, 4), got_by, got_flops) == (ms, by, flops)


# ------------------------------------------------------------ harvest
TINY = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
            max_seq=32)
B = 2


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (B, TINY["max_seq"] + 1)).astype(np.int32)


def _port_step(cfg, telemetry=True, loss_chunk=0):
    model = gpt2_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(total_steps=10, warmup_steps=1)
    step = make_sharded_train_step(
        lambda m, b: gpt2_loss_fn(cfg, m, b, loss_chunk=loss_chunk), opt,
        telemetry=telemetry)
    return TrainState.create(model, opt), step


def _independent_flops(cfg) -> float:
    """The step's matrix products from the shapes: each Dense and the
    tied logits product 2*M*K*N forward and twice that backward (dX,
    dW); attention as flash_cost per kernel launch (flash) or the
    score and value products (dense); with remat, the blocks' forward
    again in the backward up to the last saved activation (so without
    the mlp_out product: the recomputation stops early) and one more
    flash forward."""
    bt, d, f, v = B * cfg.max_seq, cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, t, hd = cfg.n_head, cfg.max_seq, cfg.d_model // cfg.n_head
    block = 2 * bt * (3 * d * d + d * d + 2 * d * f)
    total = 3 * (cfg.n_layer * block + 2 * bt * d * v)
    if cfg.attn_impl == "flash":
        att = {k: flash_cost(k, B * h, t, hd, True, 4)[0]
               for k in ("flash_fwd", "flash_dkv", "flash_dq")}
        total += cfg.n_layer * sum(att.values())
        if cfg.remat:
            total += cfg.n_layer * att["flash_fwd"]
    else:
        total += cfg.n_layer * 3 * 2 * (2 * B * h * t * t * hd)
    if cfg.remat:
        total += cfg.n_layer * (block - 2 * bt * f * d)
        if cfg.attn_impl == "dense":
            total += cfg.n_layer * 2 * (2 * B * h * t * t * hd)
    return float(total)


@pytest.mark.parametrize("impl,remat", [("flash", False), ("flash", True),
                                        ("dense", False), ("dense", True)])
def test_harvest_flops_equal_an_independent_count(impl, remat):
    """The registered ``train_step`` of a tiny float32 GPT-2 (2 layers,
    d 32, T 32, B 2): FLOPs exactly the independent count, the flash
    part exactly launches x ``flash_cost``, bytes and memory counted,
    and the step's goodput and compile series published."""
    cfg = GPT2Config(**TINY, attn_impl=impl, remat=remat,
                     dtype=torch.float32)
    state, step = _port_step(cfg)
    goodput.reset()
    state, m = step(state, {"tokens": torch.as_tensor(_tokens()).long()})
    prog = xprof.local_programs()["train_step"]
    assert prog["flops"] == _independent_flops(cfg)
    launches = {"flash_fwd": cfg.n_layer * (2 if remat else 1),
                "flash_dkv": cfg.n_layer, "flash_dq": cfg.n_layer}
    if impl == "flash":
        assert {k: v["launches"] for k, v in prog["kernels"].items()} == \
            launches
        for k, row in prog["kernels"].items():
            fl, nb = flash_cost(k, B * cfg.n_head, cfg.max_seq,
                                cfg.d_model // cfg.n_head, True, 4)
            assert (row["flops"], row["bytes"]) == \
                (launches[k] * fl, launches[k] * nb)
    else:
        assert prog["kernels"] == {}
    n_params = sum(p.numel() for p in state.model.parameters())
    assert prog["memory"]["argument"] == 3 * 4 * n_params + 8 * 2 * 33
    assert prog["memory"]["output"] == 8     # loss and grad norm
    assert prog["bytes"] > prog["memory"]["argument"]
    assert prog["compiles"] == 1 and prog["collectives"] == {}
    snap = goodput.ledger().snapshot()["seconds"]
    assert snap["compile"] > 0 and snap["compute"] == 0
    step(state, {"tokens": torch.as_tensor(_tokens()).long()})
    assert goodput.ledger().snapshot()["seconds"]["compute"] > 0
    names = {s["name"] for s in metrics.registry().snapshot()}
    for need in ("rt_xla_cost_flops", "rt_xla_cost_bytes",
                 "rt_xla_memory_bytes", "rt_xla_compiles_total",
                 "rt_train_compile_seconds",
                 "rt_train_step_dispatch_seconds", "rt_goodput_seconds"):
        assert need in names


@pytest.mark.parametrize("remat", [False, True])
def test_harvest_flops_beside_jax_cost_analysis(remat):
    """JAX's ``cost_analysis`` FLOPs of the same float32 step (dense
    attention, full logits), printed beside the harvest: XLA counts the
    elementwise and reduction FLOPs too, so the port's count is below
    it (0.854 without remat and 0.863 with it on the CPU)."""
    kw = dict(TINY, attn_impl="dense", remat=remat)
    jcfg = JaxGPT2Config(**kw, dtype=jnp.float32)
    opt = jax_make_optimizer(total_steps=10)
    jstate = JaxTrainState.create(
        jax.jit(jax_gpt2_init, static_argnums=0)(jcfg,
                                                 jax.random.PRNGKey(0)),
        opt)
    jstep = jax_make_train_step(
        lambda p, b: jax_gpt2_loss_fn(jcfg, p, b, loss_chunk=0), opt)
    cost = jax.jit(jstep).lower(jstate, {"tokens": _tokens()}) \
        .compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    state, step = _port_step(GPT2Config(**kw, dtype=torch.float32))
    step(state, {"tokens": torch.as_tensor(_tokens()).long()})
    port = xprof.local_programs()["train_step"]["flops"]
    ratio = port / cost["flops"]
    print(f"harvest {port:.0f} FLOPs, JAX cost_analysis "
          f"{cost['flops']:.0f}: ratio {ratio:.4f}")
    assert 0.80 <= ratio <= 0.90


@pytest.mark.parametrize("impl,dtype", [("flash", torch.float32),
                                        ("dense", torch.float32),
                                        ("flash", torch.bfloat16)])
def test_telemetry_on_and_off_give_the_same_bits(impl, dtype):
    """Three steps with and without telemetry (the first one under the
    harvest's counting mode): equal losses, grad norms, parameters and
    moments, bit for bit."""
    cfg = GPT2Config(**TINY, attn_impl=impl, remat=True, dtype=dtype)
    runs = []
    for telemetry in (True, False):
        state, step = _port_step(cfg, telemetry, loss_chunk=16)
        ms = [step(state, {"tokens": torch.as_tensor(_tokens(s)).long()})[1]
              for s in range(3)]
        runs.append(([(float(m["loss"]), float(m["grad_norm"]))
                      for m in ms],
                     list(state.model.parameters()) +
                     state.opt_state["mu"] + state.opt_state["nu"]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


class _Tick(torch.autograd.Function):
    """Identity on the loss that advances a fake clock: 1 s in the
    forward, 2 s in the backward."""

    clock = [0.0]

    @staticmethod
    def forward(ctx, x):
        _Tick.clock[0] += 1.0
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _Tick.clock[0] += 2.0
        return g


def test_step_decomposition_arithmetic_and_state_untouched(monkeypatch):
    """``measure_step_decomposition`` on a tiny GPT-2 step under a fake
    clock (forward 1 s, backward 2 s, optimizer 0.25 s a call): the
    forward, backward and optimizer seconds, the shares and the of-peak
    figures come out exactly, the shares sum to 1, and the state (the
    parameters, both moments, the counters) is as it was.  The bounds on
    real times are held on the card (``chip_smoke.py`` [telemetry] (e)):
    on a loaded CPU the differences of the loops drown in noise."""
    cfg = GPT2Config(**TINY, remat=True, dtype=torch.float32)
    state, _step = _port_step(cfg)
    opt = make_optimizer(total_steps=10, warmup_steps=1)
    update = opt.update

    def timed_update(*args, **kwargs):
        _Tick.clock[0] += 0.25
        return update(*args, **kwargs)

    monkeypatch.setattr(opt, "update", timed_update)
    monkeypatch.setattr(xprof.time, "perf_counter", lambda: _Tick.clock[0])
    model = state.model
    before = [t.clone() for t in list(model.parameters())
              + state.opt_state["mu"] + state.opt_state["nu"]]

    def loss_fn(m, b):
        return _Tick.apply(gpt2_loss_fn(cfg, m, b, loss_chunk=0))

    d = xprof.measure_step_decomposition(
        loss_fn, opt, state, {"tokens": torch.as_tensor(_tokens()).long()},
        steps=3, reps=2, flops_per_step=3.0e12, peak_flops=1e12)
    assert (d["forward_s"], d["backward_s"], d["optimizer_s"],
            d["full_step_s"]) == (1.0, 2.0, 0.25, 3.25)
    assert d["shares"] == {"forward": 1 / 3.25, "backward": 2 / 3.25,
                           "optimizer": 0.25 / 3.25}
    assert sum(d["shares"].values()) == pytest.approx(1.0, abs=1e-12)
    assert d["of_peak"] == {"forward": 1.0, "backward": 1.0,
                            "full_step": 3.0 / 3.25}
    after = list(model.parameters()) + state.opt_state["mu"] + \
        state.opt_state["nu"]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert state.step == 0 and state.opt_state["count"] == 0


def test_publish_device_memory_writes_nothing_without_a_card():
    assert xprof.publish_device_memory() == 0


def test_sharded_step_registers_collectives_on_both_axes():
    """A sharded GPT-2 step on a 2x2 fsdp x tensor mesh of 4 gloo ranks
    (the port's counterpart of tests/test_xprof.py's): the registered
    ``train_step`` has collective bytes on both mesh axes, and the
    ``rt_xla_*`` series went out."""
    from ray_tpu_torch import testing
    from ray_tpu_torch.dryrun import spawn

    cfg = GPT2Config(vocab_size=256, n_layer=1, n_head=4, d_model=64,
                     d_ff=128, max_seq=32)
    tokens = np.random.default_rng(0).integers(0, 256, (4, 33))
    runs = spawn(testing.harvest_case, 4, cfg, SIZES, tokens, timeout=300.0)
    for prog, names in runs:
        colls = prog["collectives"]
        for axis in SIZES:
            assert sum(a["bytes"] for ax, a in colls.items()
                       if axis in ax.split("+")) > 0, colls
        assert prog["flops"] > 0
        for need in ("rt_xla_cost_flops", "rt_xla_collective_bytes",
                     "rt_xla_compiles_total"):
            assert need in names
