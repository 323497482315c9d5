"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are
built from ``ray_tpu_torch/csrc`` at first use), carries the ``cuda``
marker and skips without a card.  This file imports no JAX, so it runs
on the GPU machine too, where the suite's conftest (which sets JAX up)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel's error against the float32 plain version stays
within twice the bf16 plain version's error plus 2^-8 of the peak.  The
serving path (plain PyTorch, no kernel of its own) is held to the same
engine on the CPU: the same tokens, decode logits within 1e-4 in
float32.
"""

import dataclasses
import functools

import pytest
import torch

from ray_tpu_torch.llm.engine import EngineConfig, GenerationEngine
from ray_tpu_torch.llm.kv_cache import paged_store
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import gpt2 as _gpt2
from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss_fn
from ray_tpu_torch.models.llama import LlamaConfig, llama_init
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as attention
from ray_tpu_torch.ops import flash_attention_with_lse as attention_with_lse
from ray_tpu_torch.ops.flash_attention import (flash_dkv_plain,
                                               flash_dq_plain,
                                               flash_fwd_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's CUDA kernels)")
    return torch.device("cuda")


def _close(got, plain, ref):
    err_k = float((got.float() - ref.float()).abs().max())
    err_p = float((plain.float() - ref.float()).abs().max())
    assert err_k <= 2 * err_p + 2.0 ** -8 * float(ref.abs().max())


def _qkv(device, b=2, t=256, h=4, d=64, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=gen, device=device)
            .to(torch.bfloat16).requires_grad_() for _ in range(3)]


@pytest.mark.parametrize("t", [64, 256, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_on_card(card, causal, t):
    """Forward and all three gradients through the autograd Function:
    the card (kernels) against the CPU (plain versions), same inputs.
    T = 64 and 320 leave a partial 128-row tile in the kernels."""
    q, k, v = _qkv(card, t=t)
    blk = 128 if t % 128 == 0 else 64
    out = attention(q, k, v, causal=causal, block_q=blk, block_k=blk)
    out.float().square().sum().backward()
    got = [out, q.grad, k.grad, v.grad]

    def run(dtype):
        xs = [x.detach().cpu().to(dtype).requires_grad_() for x in (q, k, v)]
        o = attention(*xs, causal=causal, block_q=blk, block_k=blk)
        o.float().square().sum().backward()
        return [o] + [x.grad for x in xs]

    for g, p, r in zip(got, run(torch.bfloat16), run(torch.float32)):
        _close(g.cpu(), p, r)


def _backward_inputs(device, b, t, h, causal, d=64, seed=0):
    """The dQ kernel's inputs: q, k, v as column slices of one qkv tensor
    (the model's layout), dO, and lse and delta from the float32 plain
    forward; with the plain versions' keyword arguments."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=device
                      ).to(torch.bfloat16)
    q, k, v = (z.unflatten(-1, (h, d)) for z in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen, device=device
                     ).to(torch.bfloat16)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=64, block_k=64)
    o, lse = flash_fwd_plain(q.float(), k.float(), v.float(), **kw)
    delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), kw


@pytest.mark.parametrize("causal", [True, False])
def test_dq_kernel_many_heads_partial_items(card, causal):
    """B*H = 144 work items per q block, more than the card's 132 SMs, so
    the persistent blocks take several rounds; T = 320 leaves a last
    128-row item half past T, whose lse/delta reads must stop at T."""
    (q, k, v, do, lse, delta), kw = _backward_inputs(card, 12, 320, 12,
                                                     causal)
    got = _kernels.flash_dq(q, k, v, do, lse, delta, scale=kw["scale"],
                            causal=causal)
    plain = flash_dq_plain(q, k, v, do, lse, delta, **kw)
    ref = flash_dq_plain(q.float(), k.float(), v.float(), do.float(), lse,
                         delta, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    _close(got, plain, ref)


def test_dq_kernel_is_deterministic(card):
    """Each block writes only its own rows (no atomics): two calls give
    bit-identical dQ."""
    (q, k, v, do, lse, delta), kw = _backward_inputs(card, 12, 320, 12, True)
    runs = [_kernels.flash_dq(q, k, v, do, lse, delta, scale=kw["scale"],
                              causal=True) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_flash_attention_with_lse_cotangent_on_card_matches_plain(card):
    """A non-zero lse cotangent folds into delta before the backward
    kernels: the card (kernels) against the CPU (plain versions)."""
    q, k, v = _qkv(card, t=320, seed=5)
    gen = torch.Generator().manual_seed(6)
    w = torch.randn((2, 320, 4), generator=gen)

    def run(xs):
        o, lse = attention_with_lse(*xs, causal=True, block_q=64,
                                    block_k=64)
        (o.float().square().sum()
         + (lse * w.to(lse.device)).sum()).backward()
        return [o, lse] + [x.grad for x in xs]

    got = run([q, k, v])

    def cpu(dtype):
        return run([x.detach().cpu().to(dtype).requires_grad_()
                    for x in (q, k, v)])

    for g, p, r in zip(got, cpu(torch.bfloat16), cpu(torch.float32)):
        _close(g.cpu(), p, r)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_mid_shape_on_card(card, causal):
    """Ring attention's backward: random dO and a random lse cotangent
    at B4 T512 H8 through the kernels (autograd), against the plain
    versions on the card in bf16 and float32, every output and
    gradient."""
    b, t, h, d = 4, 512, 8, 64
    q, k, v = _qkv(card, b=b, t=t, h=h, seed=7)
    gen = torch.Generator(device=card).manual_seed(8)
    do = torch.randn((b, t, h, d), generator=gen, device=card).to(
        torch.bfloat16)
    dlse = torch.randn((b, t, h), generator=gen, device=card)
    o, lse = attention_with_lse(q, k, v, causal=causal, block_q=t,
                                block_k=t)
    got = [o.detach(), lse.detach(),
           *torch.autograd.grad((o, lse), (q, k, v), (do, dlse))]

    def plain(q, k, v, do):
        kw = dict(scale=d ** -0.5, causal=causal, block_q=t, block_k=t)
        out, lse = flash_fwd_plain(q, k, v, **kw)
        delta = ((do.float() * out.float()).sum(-1) - dlse).transpose(
            1, 2).contiguous()
        dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, **kw)
        return [out, lse.transpose(1, 2),
                flash_dq_plain(q, k, v, do, lse, delta, **kw), dk, dv]

    xs = [x.detach() for x in (q, k, v, do)]
    for g, p, r in zip(got, plain(*xs), plain(*(x.float() for x in xs))):
        _close(g, p, r)


@pytest.fixture
def nccl_gang(card, tmp_path):
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.train.distributed import setup_distributed_mesh

    gang = setup_distributed_mesh(rank=0, world=1, device=card,
                                  init_method=f"file://{tmp_path}/gang")
    yield gang
    col.destroy_collective_group(gang.group_name)


def test_nccl_group_ops_stay_on_the_device(nccl_gang):
    """The NCCL group of a world-1 gang: every collective returns a new
    CUDA tensor and leaves its input alone; a CPU tensor raises."""
    from ray_tpu_torch import collective as col

    name = nccl_gang.group_name
    x = torch.arange(4, dtype=torch.float32, device="cuda")
    for out in (col.allreduce(x, name), col.allreduce(x, name, "mean"),
                col.reducescatter(x, name), col.broadcast(x, 0, name),
                *col.allgather(x, name)):
        assert out.is_cuda and torch.equal(out, x) and out is not x
    col.barrier(name)
    assert col.get_group(name).backend == "nccl"
    with pytest.raises(ValueError, match="CUDA tensors"):
        col.allreduce(x.cpu(), name)


def test_world1_nccl_sharded_step_matches_unsharded(nccl_gang):
    """Two steps of the sharded GPT-2 step (a world-1 NCCL gang, DTensor
    state, ring attention over the one-device seq axis) against the
    unsharded flash step on the same bf16 weights and tokens.  The
    attention output is bit-equal; loss and grad norm agree within 1e-5
    relative, the parameters within 1e-5."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from ray_tpu_torch.parallel.sharding import (ShardingRules, distribute,
                                                 logical_sharding)
    from ray_tpu_torch.train import train_step as ts

    mesh = create_mesh(MeshSpec(), device="cuda")
    base = GPT2Config(vocab_size=512, n_layer=2, n_head=2, d_model=128,
                      d_ff=256, max_seq=128)
    runs = []
    for cfg in (dataclasses.replace(base, attn_impl="flash"),
                dataclasses.replace(base, attn_impl="ring", mesh=mesh,
                                    rules=ShardingRules())):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = gpt2_init(cfg, gen, device="cuda")
        tokens = torch.randint(0, 512, (2, 129), generator=gen,
                               device="cuda")
        opt = ts.make_optimizer(total_steps=10, warmup_steps=1)
        state = ts.TrainState.create(model, opt)
        loss = functools.partial(gpt2_loss_fn, cfg)
        if cfg.mesh is None:
            step = ts.make_train_step(loss, opt)
            batch = {"tokens": tokens}
        else:
            state = ts.shard_state(state, mesh,
                                   _gpt2.gpt2_param_axes, cfg.rules)
            step = ts.make_sharded_train_step(loss, opt, mesh)
            batch = {"tokens": distribute(tokens, logical_sharding(
                mesh, ("batch", None)))}
        metrics = [step(state, batch)[1] for _ in range(2)]
        params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                  for n, p in model.named_parameters()}
        runs.append((metrics, params))
    (plain, plain_params), (sharded, sharded_params) = runs
    for a, b in zip(plain, sharded):
        for key in ("loss", "grad_norm"):
            assert float(b[key]) == pytest.approx(float(a[key]), rel=1e-5)
    for n, p in plain_params.items():
        torch.testing.assert_close(sharded_params[n], p, rtol=1e-5,
                                   atol=1e-5)


def test_kernels_reject_what_they_do_not_take(card):
    q = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16, device=card)
    kw = dict(scale=0.125, causal=True)
    with pytest.raises(ValueError, match="bfloat16"):
        _kernels.flash_fwd(q.float(), q.float(), q.float(), **kw)
    with pytest.raises(ValueError, match="head width"):
        x = q[..., :32]
        _kernels.flash_fwd(x, x, x, **kw)
    with pytest.raises(ValueError, match="multiple"):
        x = q[:, :96]
        _kernels.flash_fwd(x, x, x, **kw)
    with pytest.raises(ValueError, match="stride"):
        x = q.transpose(1, 3)
        _kernels.flash_fwd(x, x, x, **kw)


def test_gpt2_flash_step_on_card_matches_cpu(card):
    """A small bf16 GPT-2 (d_head 64): loss and gradient norm of the flash
    model on the card agree with the same weights on the CPU."""
    cfg = GPT2Config(vocab_size=512, n_layer=2, n_head=2, d_model=128,
                     d_ff=256, max_seq=128, attn_impl="flash")
    model = gpt2_init(cfg, torch.Generator(device=card).manual_seed(0),
                      device=card)
    cpu = gpt2_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cpu.load_state_dict(model.state_dict())
    tokens = torch.randint(0, 512, (2, 129), device=card)
    before = _kernels.launches["flash_dkv"]
    losses, norms = [], []
    for m, toks in ((model, tokens), (cpu, tokens.cpu())):
        loss = gpt2_loss_fn(cfg, m, {"tokens": toks}, loss_chunk=64)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        losses.append(float(loss))
        norms.append(float(torch.stack([g.norm() for g in grads]).norm()))
    assert _kernels.launches["flash_dkv"] == before + cfg.n_layer
    assert abs(losses[0] - losses[1]) < 1e-2
    assert abs(norms[0] - norms[1]) < 1e-2 * norms[1]


def _engine_run(engine):
    """Step the engine (no thread) over three prompts in flight, one of
    them sampled; returns each sequence's frames and every forward's
    logits on the host."""
    logits = []
    real_fwd = engine._fwd

    def spy(*args):
        out = real_fwd(*args)
        logits.append(out[0].float().cpu())
        return out

    engine._fwd = spy
    seqs = [engine.submit([5, 100, 23, 77], max_tokens=10),
            engine.submit([9, 4, 300], max_tokens=10,
                          params=SamplingParams(temperature=0.9, top_k=50),
                          seed=42),
            engine.submit(list(range(1, 12)), max_tokens=10)]
    for _ in range(200):
        if all(s.finished for s in seqs):
            break
        engine.step()
    frames = [[s.out.get_nowait() for _ in range(s.out.qsize())]
              for s in seqs]
    return frames, logits


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_tiny_engine_on_card_matches_cpu(card, family):
    """Float32 tiny GPT-2 and GQA Llama: the engine on the card gives the
    CPU engine's frames, its forwards' logits within 1e-4."""
    if family == "gpt2":
        cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
        weights = gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    else:
        cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
        assert cfg.n_kv_head < cfg.n_head
        weights = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = EngineConfig(page_size=4, num_pages=12, max_batch=4)
    runs = [_engine_run(GenerationEngine(model_cfg=cfg, engine_cfg=ecfg,
                                         params=weights.state_dict(),
                                         device=dev))
            for dev in (card, "cpu")]
    (got, got_logits), (want, want_logits) = runs
    assert got == want
    assert all(f[-1]["reason"] == "length" for f in got)
    assert len(got_logits) == len(want_logits)
    for a, b in zip(got_logits, want_logits):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_paged_store_on_card_drops_padded_rows(card):
    """Rows 2 and 3 are padding with all-zero page-table rows; page 0
    holds sequence 0's first tokens and must not change."""
    gen = torch.Generator(device=card).manual_seed(0)
    k0 = torch.randn((6, 4, 2, 8), generator=gen, device=card)
    v0 = torch.randn((6, 4, 2, 8), generator=gen, device=card)
    k_new = torch.randn((4, 1, 2, 8), generator=gen, device=card)
    v_new = torch.randn((4, 1, 2, 8), generator=gen, device=card)
    table = torch.tensor([[0, 5], [3, 1], [0, 0], [0, 0]], device=card)
    pos = torch.tensor([[5], [2], [-1], [-1]], device=card)
    k, v = k0.clone(), v0.clone()
    paged_store(k, v, k_new, v_new, table, pos)
    want_k, want_v = k0.clone(), v0.clone()
    want_k[5, 1], want_v[5, 1] = k_new[0, 0], v_new[0, 0]
    want_k[3, 2], want_v[3, 2] = k_new[1, 0], v_new[1, 0]
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    assert torch.equal(k[0], k0[0]) and torch.equal(v[0], v0[0])


def test_moe_layer_on_the_card_matches_its_cpu_run(card):
    """``MoEMLP`` (plain PyTorch: routing, dense dispatch/combine, the
    expert FFNs) on the card against the same layer on the CPU, float32:
    output, aux loss and gradients within 1e-4, the same rows dropped."""
    from ray_tpu_torch.ops.moe import MoEMLP

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 32, generator=gen)
    runs = []
    for device in ("cpu", card):
        layer = MoEMLP(32, 64, 4, top_k=2, capacity_factor=1.0,
                       dtype=torch.float32, device=device)
        if device == "cpu":
            layer.reset_parameters(torch.Generator().manual_seed(1))
        else:
            layer.load_state_dict(runs[0][0].state_dict())
        xi = x.detach().to(device).requires_grad_()
        y, aux = layer(xi)
        ((y ** 2).mean() + 0.01 * aux).backward()
        runs.append((layer, y.detach().cpu(), float(aux.detach()),
                     xi.grad.cpu(), [p.grad.cpu() for p in
                                     layer.parameters()]))
    (_l, y0, a0, dx0, g0), (_c, y1, a1, dx1, g1) = runs
    assert torch.equal(y0.abs().sum(-1) == 0, y1.abs().sum(-1) == 0)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)
    assert abs(a1 - a0) <= 1e-4
    torch.testing.assert_close(dx1, dx0, rtol=1e-4, atol=1e-4)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_world1_checkpoint_round_trip_of_dtensor_state(card, nccl_gang,
                                                       tmp_path):
    """A world-1 NCCL gang's DTensor train state (GPT-2 tiny, after one
    step) saved with ``save_sharded`` and restored with
    ``load_sharded`` onto the same mesh: every leaf bit-identical, and
    the next step equal from both."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from ray_tpu_torch.parallel.sharding import distribute, logical_sharding
    from ray_tpu_torch.train import distributed
    from ray_tpu_torch.train import train_step as ts
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    mesh = create_mesh(MeshSpec(), device=card)
    cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32,
                              mesh=mesh)
    opt = ts.make_optimizer(total_steps=10, warmup_steps=2)

    def fresh(seed):
        model = gpt2_init(cfg, torch.Generator(device=card).manual_seed(seed),
                          device=card)
        return ts.shard_state(ts.TrainState.create(model, opt), mesh,
                              _gpt2.gpt2_param_axes)

    step = ts.make_sharded_train_step(
        lambda m, b: gpt2_loss_fn(cfg, m, b), opt, mesh)
    gen = torch.Generator(device=card).manual_seed(3)
    toks = [distribute(torch.randint(0, cfg.vocab_size, (4, 129),
                                     generator=gen, device=card),
                       logical_sharding(mesh, ("batch", None)))
            for _ in range(2)]
    state, _ = step(fresh(0), {"tokens": toks[0]})
    path = str(tmp_path / "checkpoint_000001")
    save_sharded(path, distributed.train_state_tree(state), mesh=mesh)
    again = distributed.restore_train_state(fresh(1),
                                            load_sharded(path, mesh=mesh))
    for a, b in zip(again.model.parameters(), state.model.parameters()):
        assert torch.equal(a.full_tensor(), b.full_tensor())
    for key in ("mu", "nu"):
        for a, b in zip(again.opt_state[key], state.opt_state[key]):
            assert torch.equal(a.full_tensor(), b.full_tensor())
    _, m1 = step(state, {"tokens": toks[1]})
    _, m2 = step(again, {"tokens": toks[1]})
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(again.model.parameters(), state.model.parameters()):
        assert torch.equal(a.full_tensor(), b.full_tensor())


def test_nccl_timed_op_covers_completion(nccl_gang):
    """The NCCL group's eager ops record one latency sample per call,
    tagged backend="nccl"; over 5 alternated rounds an allreduce's and a
    broadcast's median latency is at least the median CUDA-event time of
    the same device work (the staging copy into a buffer allocated
    beforehand, the collective, its wait) without telemetry: the
    timed region ends after the op has completed, not at its launch.
    (NCCL's barrier blocks the host in ``wait()`` itself: its event time
    is the same round trip, so it is held to its count.)"""
    import statistics

    import torch.distributed as dist

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.util.metrics import registry

    group = col.get_group(nccl_gang.group_name)
    pg = group.process_group
    x = torch.ones(64 << 20, device="cuda")            # 256 MiB
    y = torch.empty_like(x)
    bcast = dist.BroadcastOptions()
    bcast.rootRank = 0

    def series(op):
        for snap in registry().snapshot():
            if snap["name"] == "rt_collective_latency_seconds":
                for s in snap["series"]:
                    if s["tags"] == {"op": op, "backend": "nccl",
                                     "world": "1"}:
                        return s["hist"]["count"], s["hist"]["sum"]
        return 0, 0.0

    for op, call, raw in (
            ("allreduce", lambda: group.allreduce(x),
             lambda: pg.allreduce([y.copy_(x)],
                                  dist.AllreduceOptions()).wait()),
            ("broadcast", lambda: group.broadcast(x, 0),
             lambda: pg.broadcast([y.copy_(x)], bcast).wait()),
            ("barrier", group.barrier,
             lambda: pg.barrier(dist.BarrierOptions()).wait())):
        n_pre, _ = series(op)
        call()                                # sets NCCL up
        torch.cuda.synchronize()
        events, latencies = [], []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            raw()
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end) / 1e3)
            _, s0 = series(op)
            call()
            _, s1 = series(op)
            latencies.append(s1 - s0)
        assert series(op)[0] - n_pre == 6
        assert op == "barrier" or \
            statistics.median(latencies) >= statistics.median(events)


def test_publish_device_memory_on_card(card):
    """Three series for the one card, ``peak`` equal to the allocator's
    own peak statistic and ``limit`` to the card's memory."""
    from ray_tpu_torch.util import xprof
    from ray_tpu_torch.util.metrics import registry

    torch.ones(1 << 20, device=card)
    assert xprof.publish_device_memory() == 3
    got = {s["tags"]["kind"]: s["value"]
           for snap in registry().snapshot()
           if snap["name"] == "rt_xla_device_memory_bytes"
           for s in snap["series"] if s["tags"]["device"] == "0"}
    stats = torch.cuda.memory_stats(0)
    assert got["peak"] == stats["allocated_bytes.all.peak"]
    assert got["limit"] == torch.cuda.mem_get_info(0)[1]


def test_harvest_on_card_counts_every_launch_and_changes_nothing(card):
    """The telemetry step of a tiny bf16 flash GPT-2 (head width 64) on
    the card: the
    harvest counts the kernels' forward and backward launches (the
    backward runs on the autograd engine's thread) from ``flash_cost``,
    and three steps with and without telemetry give the same bits."""
    from ray_tpu_torch.ops.flash_attention import flash_cost
    from ray_tpu_torch.train import train_step as ts
    from ray_tpu_torch.util import xprof

    cfg = dataclasses.replace(GPT2Config.tiny(), n_head=2,
                              attn_impl="flash", remat=True)
    gen = torch.Generator(device=card).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq + 1),
                         generator=gen, device=card)
    runs = []
    for telemetry in (True, False):
        model = gpt2_init(cfg, torch.Generator(device=card).manual_seed(0),
                          device=card)
        opt = ts.make_optimizer(total_steps=10, warmup_steps=1)
        state = ts.TrainState.create(model, opt)
        step = ts.make_sharded_train_step(
            lambda m, b: gpt2_loss_fn(cfg, m, b), opt, telemetry=telemetry)
        losses = [float(step(state, {"tokens": toks})[1]["loss"])
                  for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    prog = xprof.local_programs()["train_step"]
    want = {"flash_fwd": 2 * cfg.n_layer, "flash_dkv": cfg.n_layer,
            "flash_dq": cfg.n_layer}
    assert {k: v["launches"] for k, v in prog["kernels"].items()} == want
    d = cfg.d_model // cfg.n_head
    for k, n in want.items():
        assert prog["kernels"][k]["flops"] == n * flash_cost(
            k, 4 * cfg.n_head, cfg.max_seq, d, True)[0]
    assert prog["memory"]["peak"] >= prog["memory"]["argument"]
