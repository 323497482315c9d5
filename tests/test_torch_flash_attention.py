"""Flash attention: the PyTorch port against the JAX package.

The same numpy inputs (fixed seed, float32) go through
``ray_tpu.ops.flash_attention`` (Pallas kernels in interpret mode on the
CPU, as tests/test_ops.py runs them) and ``ray_tpu_torch.ops`` (its
plain PyTorch versions on the CPU).  Tolerances are those of
tests/test_ops.py: atol/rtol 2e-5 for outputs, max error / peak < 1e-4
for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_lse
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention, flash_attention_with_lse


def _qkv(b=2, t=128, h=4, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _torch(arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = float(np.max(np.abs(b))) + 1e-9
        assert float(np.max(np.abs(np.asarray(a) - b))) / scale < 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(64, 64), (64, 32)])
def test_forward_matches_jax(causal, blocks):
    qkv = _qkv()
    bq, bk = blocks
    want = jax_flash(*map(jnp.asarray, qkv), causal=causal,
                     block_q=bq, block_k=bk)
    got = flash_attention(*_torch(qkv), causal=causal, block_q=bq,
                          block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    qkv = _qkv()

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=64,
                                 block_k=64) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    q, k, v = _torch(qkv, grad=True)
    (flash_attention(q, k, v, causal=causal, block_q=64,
                     block_k=64) ** 2).sum().backward()
    _assert_grads_close([q.grad, k.grad, v.grad], want)


def test_lse_variant_forward_and_gradients_match_jax():
    """The lse output matches, and its (non-zero) cotangent folds into
    the backward exactly as in the JAX custom_vjp."""
    qkv = _qkv(seed=1)
    w = np.random.default_rng(2).standard_normal(
        (2, 128, 4)).astype(np.float32)

    def jax_loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, block_q=64, block_k=64)
        return jnp.sum(out ** 2) + jnp.sum(lse * w)

    jq = list(map(jnp.asarray, qkv))
    want_out, want_lse = jax_flash_lse(*jq, block_q=64, block_k=64)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*jq)

    q, k, v = _torch(qkv, grad=True)
    out, lse = flash_attention_with_lse(q, k, v, block_q=64, block_k=64)
    assert lse.shape == (2, 128, 4) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=2e-5)
    ((out ** 2).sum() + (lse * torch.tensor(w)).sum()).backward()
    _assert_grads_close([q.grad, k.grad, v.grad], want)


def test_bf16_follows_the_pallas_roundings():
    """In bf16 the plain versions cast where the Pallas kernels cast (P
    to bf16 before P.V and P^T.dO, dS to bf16 before its products), so
    output and gradients equal JAX's except where float32 summation
    order flips a rounding: under 2% of elements (a missing cast
    changes ~40% of them)."""
    qkv = _qkv()
    do = np.random.default_rng(5).standard_normal(qkv[0].shape)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, block_q=64, block_k=64)
        return jnp.sum(out.astype(jnp.float32) * do), out

    jq = [jnp.asarray(x, jnp.bfloat16) for x in qkv]
    grads, want_out = jax.grad(jax_loss, argnums=(0, 1, 2),
                               has_aux=True)(*jq)
    q, k, v = [torch.tensor(x).to(torch.bfloat16).requires_grad_()
               for x in qkv]
    out = flash_attention(q, k, v, block_q=64, block_k=64)
    (out.float() * torch.tensor(do)).sum().backward()
    for got, want in zip([out, q.grad, k.grad, v.grad],
                         [want_out, *grads]):
        got = got.detach().float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        assert np.mean(got != want) < 0.02
        assert np.max(np.abs(got - want)) <= 2.0 ** -7 * np.max(
            np.abs(want))


def test_whole_sequence_block_is_clamped():
    """The model's call: blocks of 1024 clamp to T."""
    qkv = _qkv(t=128)
    want = jax_flash(*map(jnp.asarray, qkv), block_q=1024, block_k=1024)
    got = flash_attention(*_torch(qkv), block_q=1024, block_k=1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", [flash_attention, flash_attention_with_lse])
def test_rejects_indivisible_seq(fn):
    q, k, v = _torch(_qkv(t=200))
    with pytest.raises(ValueError, match="divide"):
        fn(q, k, v, block_q=128, block_k=128)


def test_causality_is_exact():
    """Perturbing k/v at positions j > i cannot change output row i."""
    q, k, v = _torch(_qkv(t=128))
    out1 = flash_attention(q, k, v, block_q=64, block_k=64)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = flash_attention(q, k2, v2, block_q=64, block_k=64)
    np.testing.assert_allclose(out1[:, :100].numpy(), out2[:, :100].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_dkv", "flash_dq"])
def test_kernel_wrappers_reject_cpu_tensors(wrapper):
    """A kernel wrapper takes CUDA tensors only; it raises before it
    builds or launches anything (CPU tensors go to the plain versions)."""
    x = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    rows = torch.zeros(1, 1, 64)
    args = (x, x, x) if wrapper == "flash_fwd" else (x, x, x, x, rows, rows)
    before = dict(_kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(_kernels, wrapper)(*args, scale=0.125, causal=True)
    assert _kernels.launches == before
