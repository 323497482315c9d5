"""Llama: the PyTorch port against the JAX package on converted weights.

A tiny GQA config (2 layers, width 128, 4 query heads over 2 KV heads,
T = 64) in float32: the JAX model is initialised from a fixed key, its
param tree converted with ``llama_params_from_numpy``, and the same
numpy token ids go through both.  Tolerances: logits atol/rtol 1e-4;
losses relative 1e-5; gradients max error / peak < 1e-4 per parameter;
RoPE tables bit-equal (both are the same numpy code), RoPE outputs
within 1e-6 in float32; bf16 is held to the 1e-2 loss bound of
tests/test_ops.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (llama_params_from_numpy,
                                          llama_params_to_numpy)

_CFG = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=128,
            d_ff=256, max_seq=128)


def _configs(dtype="float32", remat=True):
    return (jllama.LlamaConfig(**_CFG, remat=remat, dtype=getattr(jnp, dtype)),
            tllama.LlamaConfig(**_CFG, remat=remat,
                               dtype=getattr(torch, dtype)))


def _pair(dtype="float32", remat=True):
    jcfg, tcfg = _configs(dtype, remat)
    params = jllama.llama_init(jcfg, jax.random.PRNGKey(1))
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, tcfg, params, model


def _tokens(t=64, seed=1):
    return np.random.default_rng(seed).integers(
        0, _CFG["vocab_size"], (2, t + 1)).astype(np.int32)


def test_convert_round_trip():
    _jcfg, _tcfg, params, model = _pair()
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = llama_params_to_numpy(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_init_matches_jax_names_and_shapes():
    jcfg, tcfg = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.llama_init(jcfg, jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in
            llama_params_from_numpy(tree).items()}
    model = tllama.llama_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "layer_0.wq.bias" not in sd                 # bias-free Dense
    assert sd["lm_head"].shape == (128, 256)           # untied, [D, V]
    assert torch.all(sd["layer_1.mlp_norm.scale"] == 1)
    for name in ("embed", "lm_head", "layer_0.w_gate.kernel"):
        assert abs(float(sd[name].std()) - 0.02) < 2e-3


def test_logits_match_jax():
    jcfg, _tcfg, params, model = _pair()
    toks = _tokens()[:, :-1]
    want = jax.jit(jllama.Llama(jcfg).apply)(params, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_loss_and_grads_match_jax():
    jcfg, tcfg, params, model = _pair()
    toks = _tokens()
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.llama_loss_fn(jcfg, p,
                                       {"tokens": jnp.asarray(toks)})))(params)
    loss = tllama.llama_loss_fn(tcfg, model,
                                {"tokens": torch.from_numpy(toks)})
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    want = {k: v.numpy() for k, v in llama_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want_grads)).items()}
    for name, p in model.named_parameters():
        peak = float(np.max(np.abs(want[name]))) + 1e-12
        err = float(np.max(np.abs(p.grad.numpy() - want[name])))
        assert err / peak < 1e-4, (name, err, peak)


def test_bf16_loss_matches_jax():
    jcfg, tcfg, params, model = _pair(dtype="bfloat16")
    toks = _tokens()
    want = jax.jit(lambda p: jllama.llama_loss_fn(
        jcfg, p, {"tokens": jnp.asarray(toks)}))(params)
    with torch.no_grad():
        got = tllama.llama_loss_fn(tcfg, model,
                                   {"tokens": torch.from_numpy(toks)})
    assert abs(float(got) - float(want)) < 1e-2


def test_remat_gives_the_same_gradients():
    _jcfg, tcfg, _params, model = _pair(remat=True)
    plain = tllama.Llama(dataclasses.replace(tcfg, remat=False),
                         device="cpu")
    plain.load_state_dict(model.state_dict())
    batch = {"tokens": torch.from_numpy(_tokens())}
    for m in (model, plain):
        tllama.llama_loss_fn(m.cfg, m, batch).backward()
    for (name, a), b in zip(model.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0,
                                   msg=name)


def test_rope_tables_match_jax_and_are_cached():
    a = tllama._rope_tables(32, 16, 10000.0)
    assert tllama._rope_tables(32, 16, 10000.0) is a   # cache hit
    for got, want in zip(a, jllama._rope_tables(32, 16, 10000.0)):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    """Table RoPE (contiguous positions) and positional RoPE (decode:
    arbitrary positions, negative = padding read as 0)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, -1, -1],
                    [40, 7, 3, 100, 0, 9, 11, 12]], np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for jpos, tpos in ((None, None),
                       (jnp.asarray(pos), torch.from_numpy(pos))):
        want = np.asarray(jllama._rope(jx, 10000.0, jpos), np.float32)
        got = tllama._rope(tx, 10000.0, tpos)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    contiguous = torch.from_numpy(np.broadcast_to(
        np.arange(8, dtype=np.int32), (2, 8)).copy())
    torch.testing.assert_close(tllama._rope(tx, 10000.0, contiguous),
                               tllama._rope(tx, 10000.0), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("cfg", ["tiny", "llama2_7b", None])
def test_config_and_flops_match_jax(cfg):
    jc = getattr(jllama.LlamaConfig, cfg)() if cfg else jllama.LlamaConfig()
    tc = getattr(tllama.LlamaConfig, cfg)() if cfg else tllama.LlamaConfig()
    fields = [f.name for f in dataclasses.fields(tc)
              if f.name not in ("dtype", "mesh", "rules")]
    assert {f: getattr(tc, f) for f in fields} == \
        {f: getattr(jc, f) for f in fields}
    assert tc.flops_per_token() == jc.flops_per_token()
    assert tc.decode_flops_per_token() == jc.decode_flops_per_token()
    assert tc.decode_flops_per_token(32) == jc.decode_flops_per_token(32)


def test_later_slices_raise_not_implemented():
    _jcfg, tcfg = _configs()
    # The distributed slice brought ring/Ulysses attention, which need a
    # mesh as in the JAX model, and the partition rules (held to JAX's in
    # tests/test_torch_parallel.py).
    for impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        model = tllama.llama_init(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        with pytest.raises(ValueError, match="needs cfg.mesh"):
            model(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="attn_impl"):
        tllama.Llama(dataclasses.replace(tcfg, attn_impl="flash"),
                     device="cpu")
    assert tllama.llama_param_axes("embed", torch.zeros(2, 2)) == \
        ("vocab", "embed_fsdp")
