"""GPT-2: the PyTorch port against the JAX package on converted weights.

A tiny config (2 layers, width 128, T = 128) in float32: the JAX model is
initialised from a fixed key, its param tree converted with
``gpt2_params_from_numpy``, and the same numpy token ids go through
both.  Tolerances: logits atol/rtol 1e-4; losses relative 1e-5;
gradients max error / peak < 1e-4 per parameter.  bf16 is held to the
1e-2 loss bound of tests/test_ops.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_params_to_numpy)

_CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=128, d_ff=256,
            max_seq=128)


def _configs(attn_impl="dense", dtype="float32", remat=True):
    jcfg = jgpt2.GPT2Config(**_CFG, attn_impl=attn_impl, remat=remat,
                            dtype=getattr(jnp, dtype))
    tcfg = tgpt2.GPT2Config(**_CFG, attn_impl=attn_impl, remat=remat,
                            dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _pair(attn_impl="dense", dtype="float32", remat=True):
    jcfg, tcfg = _configs(attn_impl, dtype, remat)
    params = jgpt2.gpt2_init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tgpt2.GPT2(tcfg, device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(tree))
    return jcfg, tcfg, params, model


def _tokens(t=128, seed=1):
    return np.random.default_rng(seed).integers(
        0, _CFG["vocab_size"], (2, t + 1)).astype(np.int32)


def _flat_grads(grads_tree):
    """JAX gradient tree -> {state_dict name: numpy array}."""
    return {k: v.numpy() for k, v in gpt2_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, grads_tree)).items()}


def test_convert_round_trip():
    _jcfg, _tcfg, params, model = _pair()
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = gpt2_params_to_numpy(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_init_matches_jax_names_and_shapes():
    jcfg, tcfg = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jcfg, jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in
            gpt2_params_from_numpy(tree).items()}
    model = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    sd = model.state_dict()
    assert torch.all(sd["h_0.c_attn.bias"] == 0)
    assert torch.all(sd["h_1.ln_2.scale"] == 1)
    assert abs(float(sd["wte"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_logits_match_jax(attn_impl):
    jcfg, _tcfg, params, model = _pair(attn_impl)
    toks = _tokens()[:, :-1]
    want = jax.jit(jgpt2.GPT2(jcfg).apply)(params, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("loss_chunk", [0, 32])
def test_loss_and_grads_match_jax(attn_impl, loss_chunk):
    """Plain (loss_chunk=0) and fused chunked cross entropy."""
    jcfg, tcfg, params, model = _pair(attn_impl)
    toks = _tokens()
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jgpt2.gpt2_loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)},
                                     loss_chunk=loss_chunk)))(params)
    loss = tgpt2.gpt2_loss_fn(tcfg, model,
                              {"tokens": torch.from_numpy(toks)},
                              loss_chunk=loss_chunk)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    want = _flat_grads(want_grads)
    for name, p in model.named_parameters():
        peak = float(np.max(np.abs(want[name]))) + 1e-12
        err = float(np.max(np.abs(p.grad.numpy() - want[name])))
        assert err / peak < 1e-4, (name, err, peak)


def test_bf16_flash_loss_matches_jax():
    """bf16 activations (fp32 params): the loss agrees with the JAX
    model to the 1e-2 bound tests/test_ops.py holds flash to dense."""
    jcfg, tcfg, params, model = _pair("flash", dtype="bfloat16")
    toks = _tokens()
    want = jax.jit(lambda p: jgpt2.gpt2_loss_fn(
        jcfg, p, {"tokens": jnp.asarray(toks)}, loss_chunk=32))(params)
    with torch.no_grad():
        got = tgpt2.gpt2_loss_fn(tcfg, model,
                                 {"tokens": torch.from_numpy(toks)},
                                 loss_chunk=32)
    assert abs(float(got) - float(want)) < 1e-2


def test_remat_gives_the_same_gradients():
    _jcfg, tcfg, _params, model = _pair("flash", remat=True)
    plain = tgpt2.GPT2(dataclasses.replace(tcfg, remat=False), device="cpu")
    plain.load_state_dict(model.state_dict())
    batch = {"tokens": torch.from_numpy(_tokens())}
    for m, cfg in ((model, tcfg), (plain, plain.cfg)):
        tgpt2.gpt2_loss_fn(cfg, m, batch, loss_chunk=32).backward()
    for (name, a), b in zip(model.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("cfg", ["tiny", "small", "medium"])
def test_flops_per_token_match_jax(cfg):
    jc, tc = getattr(jgpt2.GPT2Config, cfg)(), getattr(tgpt2.GPT2Config,
                                                        cfg)()
    assert tc.flops_per_token() == jc.flops_per_token()
    assert tc.decode_flops_per_token() == jc.decode_flops_per_token()
    assert tc.decode_flops_per_token(77) == jc.decode_flops_per_token(77)


def test_later_slices_raise_not_implemented():
    _jcfg, tcfg = _configs()
    # MoE blocks arrived with the expert-parallel slice (every other
    # block); an unknown attention impl raises; ring/Ulysses attention
    # (the distributed slice) need a mesh, as in the JAX model.
    moe = tgpt2.GPT2(dataclasses.replace(tcfg, moe_num_experts=4),
                     device="cpu")
    assert [b.use_moe for b in moe.blocks()] == [False, True]
    with pytest.raises(ValueError, match="attn_impl"):
        tgpt2.GPT2(dataclasses.replace(tcfg, attn_impl="paged"),
                   device="cpu")
    for impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        model = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="needs cfg.mesh"):
            model(torch.zeros(1, 4, dtype=torch.long))
    # Decode mode (the serving slice) runs: logits, and the same pool
    # tensors written in place, from the model and from one block.
    model = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    pos = torch.arange(4)[None]
    pool = torch.zeros(2, 3, 4, 4, 32)
    kv = {"k_pages": pool, "v_pages": pool.clone(),
          "page_table": torch.zeros(1, 2, dtype=torch.long)}
    x = torch.randn(1, 4, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, new = model(toks, kv_cache=kv, positions=pos)
        out, (k1, _v1) = model.h_0(
            x, cache={"k_pages": pool[1], "v_pages": kv["v_pages"][1],
                      "page_table": kv["page_table"], "positions": pos})
    assert logits.shape == (1, 4, _CFG["vocab_size"])
    assert new["k_pages"] is pool and new["v_pages"] is kv["v_pages"]
    assert out.shape == (1, 4, 128)
    assert k1.data_ptr() == pool[1].data_ptr()
    assert pool[0, 0].any() and pool[1, 0].any() and not pool[:, 1:].any()


def test_graft_entry_logits_match_jax_entry():
    """``ray_tpu_torch.entry.entry`` against ``__graft_entry__.entry`` on
    the converted weights: the same configuration, tokens and output
    shape.  Both run bf16 activations over float32 parameters, so the
    logits (peak ~2) agree to bf16 rounding: max error 0.05 (a few bf16
    ulps at the peak), mean error 0.01; at float32 the same models agree
    to 1e-4 (``test_logits_match_jax``)."""
    import __graft_entry__
    from ray_tpu_torch import entry as tentry

    fn, (params, tokens) = __graft_entry__.entry()
    model, (ttokens,) = tentry.entry(device="cpu")
    assert ttokens.shape == tokens.shape == (2, 128)
    assert torch.all(ttokens == 0) and not any(
        p.requires_grad for p in model.parameters())
    cfg = tentry.ENTRY_CONFIG
    assert (cfg.vocab_size, cfg.n_layer, cfg.n_head, cfg.d_model, cfg.d_ff,
            cfg.max_seq, cfg.attn_impl, cfg.remat, cfg.dtype) == (
        8192, 4, 8, 512, 2048, 256, "dense", False, torch.bfloat16)
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    fwd = jax.jit(fn)
    rand = np.random.default_rng(0).integers(0, 8192, (2, 128))
    for toks in (np.asarray(tokens), rand):
        want = np.asarray(fwd(params, jnp.asarray(toks, jnp.int32)),
                          np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(toks).long()).float().numpy()
        assert got.shape == want.shape == (2, 128, 8192)
        err = np.abs(got - want)
        assert err.max() < 0.05 and err.mean() < 0.01, (err.max(),
                                                        err.mean())
