"""Training step: the PyTorch port against the JAX package (optax).

Five float32 GPT-2 steps from converted weights with
``make_optimizer(learning_rate=1e-3, warmup_steps=2, total_steps=10)``,
so the run crosses from warmup into the cosine decay: per-step loss and
pre-clip grad_norm agree within a relative 1e-4.  The schedule and the
clip + AdamW update are also held to optax directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.train import train_step as jstep
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.train import train_step as tstep

_CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=128, d_ff=256,
            max_seq=128, attn_impl="flash", remat=True)
_OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def test_five_steps_match_jax():
    jcfg = jgpt2.GPT2Config(**_CFG, dtype=jnp.float32)
    tcfg = tgpt2.GPT2Config(**_CFG, dtype=torch.float32)
    params = jgpt2.gpt2_init(jcfg, jax.random.PRNGKey(0))
    model = tgpt2.GPT2(tcfg, device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (2, 129)).astype(np.int32)
               for _ in range(5)]

    jopt = jstep.make_optimizer(**_OPT)
    jstate = jstep.TrainState.create(params, jopt)
    jfn = jax.jit(jstep.make_train_step(
        lambda p, b: jgpt2.gpt2_loss_fn(jcfg, p, b, loss_chunk=32), jopt))
    topt = tstep.make_optimizer(**_OPT)
    tstate = tstep.TrainState.create(model, topt)
    tfn = tstep.make_train_step(
        lambda m, b: tgpt2.gpt2_loss_fn(tcfg, m, b, loss_chunk=32), topt)

    for toks in batches:
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tfn(tstate, {"tokens": torch.from_numpy(toks)})
        for key in ("loss", "grad_norm"):
            want, got = float(jm[key]), float(tm[key])
            assert abs(got - want) <= 1e-4 * abs(want), (key, got, want)
    assert tstate.step == int(jstate.step) == 5


@pytest.mark.parametrize("warmup,total", [(2, 10), (100, 10000), (5, 3)])
def test_schedule_matches_optax(warmup, total):
    peak = 3e-4
    want = optax.warmup_cosine_decay_schedule(
        0.0, peak, warmup, max(total, warmup + 1), 0.1 * peak)
    opt = tstep.make_optimizer(learning_rate=peak, warmup_steps=warmup,
                               total_steps=total)
    # optax evaluates in float32, the port in float64: relative 1e-5.
    for count in list(range(16)) + [warmup, total - 1, total, 3 * total]:
        assert opt.schedule(count) == pytest.approx(float(want(count)),
                                                    rel=1e-5, abs=1e-12)
    assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_update_matches_optax(grad_scale):
    """Three clip + AdamW updates on random leaves, with the global norm
    below (0.01) and above (10.0) the clip limit."""
    rng = np.random.default_rng(4)
    shapes = [(8, 16), (16,), (3, 4, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[grad_scale * rng.standard_normal(s).astype(np.float32)
              for s in shapes] for _ in range(3)]

    jopt = jstep.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                total_steps=5)
    jp = [jnp.asarray(p) for p in params]
    jst = jopt.init(jp)
    topt = tstep.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                total_steps=5)
    tp = [torch.tensor(p) for p in params]
    tst = topt.init(tp)
    for g in grads:
        upd, jst = jopt.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update([torch.tensor(x) for x in g], tst, tp)
        assert float(norm) == pytest.approx(
            float(optax.global_norm([jnp.asarray(x) for x in g])), rel=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


def test_first_step_leaves_params_unchanged():
    """The lr is read at the pre-increment count: 0 on step one, weight
    decay included."""
    tcfg = tgpt2.GPT2Config(**_CFG, dtype=torch.float32)
    model = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tstep.make_optimizer(**_OPT)
    state = tstep.TrainState.create(model, opt)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256,
                                                              (2, 129)))
    state, metrics = tstep.make_train_step(
        lambda m, b: tgpt2.gpt2_loss_fn(tcfg, m, b), opt)(
            state, {"tokens": toks})
    assert float(metrics["grad_norm"]) > 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert state.opt_state["count"] == 1
