"""``ops.remat.checkpoint`` against torch's checkpoint and ``jax.checkpoint``.

The port's recomputation must give what ``torch.utils.checkpoint`` gives,
bit for bit on the CPU (the same ops run again in the same order), and
what the JAX package's ``jax.checkpoint`` gives on the same numpy inputs
(float32, max error / peak < 1e-6).  It must replay the RNG, nest, keep
no reference cycle, refuse autocast and higher-order gradients, and
stop its recomputation where torch's does; and it must leave a new
process's first GPT-2 step without the compiler stack (``torch._dynamo``,
sympy) or ``torch.distributed.tensor``.
"""

import gc
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from ray_tpu_torch.ops.remat import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _block(width: int = 16, dropout: float = 0.0):
    torch.manual_seed(0)
    lin1, lin2 = torch.nn.Linear(width, 4 * width), \
        torch.nn.Linear(4 * width, width)

    def fn(x):
        h = F.gelu(lin1(x))
        if dropout:
            h = F.dropout(h, dropout, training=True)
        return x + lin2(torch.tanh(h))

    return fn, [*lin1.parameters(), *lin2.parameters()]


def _pair_fn(x, w):
    """A function of two outputs, as an MoE block returns (y, aux)."""
    y = torch.tanh(x @ w)
    return y, (y * y).mean()


def _grads(run, fn, params, x, seed=1):
    x = x.detach().requires_grad_()
    torch.manual_seed(seed)
    out = run(fn, x)
    loss = (out * out).sum()
    return [loss.detach(), *torch.autograd.grad(loss, [x, *params])]


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_checkpoint_matches_torch_checkpoint(dropout):
    fn, params = _block(dropout=dropout)
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(2))
    ours = _grads(lambda f, a: checkpoint(f, a), fn, params, x)
    theirs = _grads(lambda f, a: torch_checkpoint(f, a, use_reentrant=False),
                    fn, params, x)
    plain = _grads(lambda f, a: f(a), fn, params, x)
    for a, b, c in zip(ours, theirs, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_recomputation_stops_where_torch_stops():
    """The block's last product saves nothing for the backward, so
    neither recomputation runs it: the same FLOPs as torch's."""
    from torch.utils.flop_counter import FlopCounterMode

    fn, params = _block()
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(5))
    flops = []
    for run in (checkpoint,
                lambda f, a: torch_checkpoint(f, a, use_reentrant=False),
                lambda f, a: f(a)):
        xg = x.clone().requires_grad_()
        with FlopCounterMode(display=False) as counter:
            (run(fn, xg) ** 2).sum().backward()
        flops.append(counter.get_total_flops())
    assert flops[0] == flops[1] > flops[2]


def test_tuple_outputs_and_nesting():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(6, 8, generator=gen, requires_grad=True)
    w = torch.randn(8, 8, generator=gen, requires_grad=True)

    def outer(run):
        def fn(a):
            y, aux = run(_pair_fn, a, w)
            return run(lambda b: _pair_fn(b, w)[0], y) + aux
        out = run(fn, x)
        return torch.autograd.grad(out.sum(), [x, w])

    ours = outer(checkpoint)
    plain = outer(lambda f, *a: f(*a))
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def test_matches_jax_checkpoint():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    w1 = (0.3 * rng.standard_normal((12, 24))).astype(np.float32)
    w2 = (0.3 * rng.standard_normal((24, 12))).astype(np.float32)

    def jloss(x, w1, w2):
        block = jax.checkpoint(lambda a: a + jnp.tanh(
            jax.nn.gelu(a @ w1, approximate=False) @ w2))
        return jnp.sum(block(block(x)) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(x, w1, w2)
    tx, t1, t2 = (torch.tensor(a, requires_grad=True) for a in (x, w1, w2))

    def block(a):
        return a + torch.tanh(F.gelu(a @ t1) @ t2)

    loss = (checkpoint(block, checkpoint(block, tx)) ** 2).sum()
    tgrads = torch.autograd.grad(loss, [tx, t1, t2])
    for j, t in zip(jgrads, tgrads):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() / np.abs(j).max() < 1e-6


def test_no_grad_runs_the_function_alone():
    fn, _params = _block()
    x = torch.randn(2, 16)
    with torch.no_grad():
        assert torch.equal(checkpoint(fn, x), fn(x))


def test_autocast_raises():
    fn, _params = _block()
    x = torch.randn(2, 16, requires_grad=True)
    with torch.autocast("cpu"), pytest.raises(RuntimeError,
                                              match="autocast"):
        checkpoint(fn, x)


def test_higher_order_gradients_raise():
    x = torch.randn(3, 4, requires_grad=True)
    y = checkpoint(lambda a: (a.sin() * a).sum(), x)
    with pytest.raises(RuntimeError, match="create_graph"):
        torch.autograd.grad(y, x, create_graph=True)


def test_keeps_no_reference_cycle():
    fn, params = _block()
    x = torch.randn(4, 16, requires_grad=True)
    h = x * 2
    seen = weakref.ref(h)
    loss = checkpoint(fn, h).sum()
    loss.backward()
    del loss, h
    assert seen() is None      # freed without a gc pass
    gc.collect()


def test_first_step_imports_no_compiler_stack():
    code = (
        "import sys, torch\n"
        "from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, "
        "gpt2_loss_fn\n"
        "from ray_tpu_torch.train.train_step import TrainState, "
        "make_optimizer, make_train_step\n"
        "for impl in ('dense', 'flash'):\n"
        "    cfg = GPT2Config(vocab_size=64, max_seq=16, n_layer=2, "
        "n_head=2, d_model=32, d_ff=64, remat=True, attn_impl=impl, "
        "dtype=torch.float32)\n"
        "    gen = torch.Generator().manual_seed(0)\n"
        "    opt = make_optimizer(learning_rate=1e-3, total_steps=4)\n"
        "    state = TrainState.create(gpt2_init(cfg, gen, device='cpu'), "
        "opt)\n"
        "    step = make_train_step(lambda m, b: gpt2_loss_fn(cfg, m, b, "
        "loss_chunk=8), opt)\n"
        "    tokens = torch.randint(0, 64, (2, 17), generator=gen)\n"
        "    state, m = step(state, {'tokens': tokens})\n"
        "    assert torch.isfinite(m['loss'])\n"
        "print(sorted(n for n in ('torch._dynamo', 'sympy', "
        "'torch.distributed.tensor') if n in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
