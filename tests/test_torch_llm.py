"""LLM inference plane units: the port against the JAX package.

Sampling (each function on the same logits, ``sample`` with the same
seeds), ``paged_store``/``paged_attend`` on the same seeded pools,
shuffled page tables, padded prefill tails and padded decode rows,
``PagePool`` on one alloc/free sequence, and the GPT-2 and Llama
decode loops on converted float32 weights.

Tolerances: sampling outputs equal (float64 numpy on both sides);
stored pools bit-equal, pages no row wrote bit-unchanged; attention
outputs within 1e-5 in float32 and within 2^-7 of the peak in bf16 (two
bf16 steps); decode loops give the same greedy tokens with logits within
2e-4 (tests/test_llm.py's bound), against the JAX loop and against the
port's own full forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import kv_cache as jkv
from ray_tpu.llm import sampling as jsampling
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import kv_cache as tkv
from ray_tpu_torch.llm import sampling as tsampling
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          llama_params_from_numpy)

# ------------------------------------------------------------ sampling


def _logits(seed, v=64):
    return np.random.default_rng(seed).normal(size=v).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_functions_match_jax(seed):
    x = _logits(seed)
    assert tsampling.greedy(x) == jsampling.greedy(x)
    for t in (0.5, 1.0, 1e-9):
        np.testing.assert_array_equal(tsampling.apply_temperature(x, t),
                                      jsampling.apply_temperature(x, t))
    np.testing.assert_array_equal(tsampling.softmax(x),
                                  jsampling.softmax(x))
    for k in (0, 1, 5, 64, 100):
        np.testing.assert_array_equal(tsampling.top_k_mask(x, k),
                                      jsampling.top_k_mask(x, k))
    for p in (1e-9, 0.3, 0.9, 1.0):
        np.testing.assert_array_equal(tsampling.top_p_mask(x, p),
                                      jsampling.top_p_mask(x, p))


@pytest.mark.parametrize("params", [
    dict(temperature=0.0),
    dict(temperature=0.7),
    dict(temperature=1.3, top_k=5),
    dict(temperature=0.9, top_p=0.8),
    dict(temperature=1.0, top_k=10, top_p=0.5),
])
def test_sample_same_seed_same_tokens(params):
    jp, tp = jsampling.SamplingParams(**params), \
        tsampling.SamplingParams(**params)
    for seed in range(3):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        got = [tsampling.sample(_logits(i), tp, tr) for i in range(20)]
        want = [jsampling.sample(_logits(i), jp, jr) for i in range(20)]
        assert got == want


def test_sampling_params_validate_like_jax():
    for bad in (dict(temperature=-1.0), dict(top_k=-2), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            jsampling.SamplingParams(**bad).validate()
        with pytest.raises(ValueError):
            tsampling.SamplingParams(**bad).validate()
    tsampling.SamplingParams(temperature=0.8, top_k=40,
                             top_p=0.95).validate()


# ---------------------------------------------- paged store and attend

_NUM_PAGES, _PAGE, _D = 12, 4, 8


def _pool(h_kv, seed):
    rng = np.random.default_rng(seed)
    shape = (_NUM_PAGES, _PAGE, h_kv, _D)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _cases():
    """(name, page_table, positions): a padded prefill (two sequences of
    6 and 8 tokens in a bucket of 8, pages shuffled) and a padded decode
    batch (rows 2 and 3 padded, all-zero tables, while page 0 holds
    sequence 0's first tokens)."""
    prefill_table = np.array([[7, 2, 0, 0, 0], [4, 9, 0, 0, 0]], np.int32)
    prefill_pos = np.array([[0, 1, 2, 3, 4, 5, -1, -1],
                            [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    decode_table = np.array([[0, 5, 0, 0, 0], [3, 8, 11, 0, 0],
                             [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    decode_pos = np.array([[5], [9], [-1], [-1]], np.int32)
    return [("prefill", prefill_table, prefill_pos),
            ("decode", decode_table, decode_pos)]


def _written_pages(table, pos):
    b, t = np.nonzero(pos >= 0)
    return set(table[b, pos[b, t] // _PAGE].tolist())


@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("case", [0, 1])
def test_paged_store_and_attend_match_jax(h, h_kv, case):
    name, table, pos = _cases()[case]
    b, t = pos.shape
    rng = np.random.default_rng(10 + case)
    k_new = rng.normal(size=(b, t, h_kv, _D)).astype(np.float32)
    v_new = rng.normal(size=(b, t, h_kv, _D)).astype(np.float32)
    q = rng.normal(size=(b, t, h, _D)).astype(np.float32)
    k0, v0 = _pool(h_kv, seed=case)

    jk, jv = jkv.paged_store(jnp.asarray(k0), jnp.asarray(v0),
                             jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(table), jnp.asarray(pos))
    want = jkv.paged_attend(jnp.asarray(q), jk, jv, jnp.asarray(table),
                            jnp.asarray(pos))

    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    out_k, out_v = tkv.paged_store(tk, tv, torch.from_numpy(k_new),
                                   torch.from_numpy(v_new), tt, tp)
    assert out_k is tk and out_v is tv               # written in place
    got = tkv.paged_attend(torch.from_numpy(q), tk, tv, tt, tp)

    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    untouched = sorted(set(range(_NUM_PAGES)) - _written_pages(table, pos))
    assert 0 in untouched                             # padded rows' page
    np.testing.assert_array_equal(tk.numpy()[untouched], k0[untouched])
    np.testing.assert_array_equal(tv.numpy()[untouched], v0[untouched])
    assert got.shape == (b, t, h, _D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("case", [0, 1])
def test_paged_store_and_attend_match_jax_bf16(case):
    _name, table, pos = _cases()[case]
    b, t = pos.shape
    h, h_kv = 4, 2
    rng = np.random.default_rng(20 + case)
    k_new, v_new = (rng.normal(size=(b, t, h_kv, _D)).astype(np.float32)
                    for _ in range(2))
    q = rng.normal(size=(b, t, h, _D)).astype(np.float32)
    k0, v0 = _pool(h_kv, seed=case)
    j = dict(k=jnp.asarray(k0, jnp.bfloat16), v=jnp.asarray(v0, jnp.bfloat16))
    jk, jv = jkv.paged_store(j["k"], j["v"],
                             jnp.asarray(k_new, jnp.bfloat16),
                             jnp.asarray(v_new, jnp.bfloat16),
                             jnp.asarray(table), jnp.asarray(pos))
    want = np.asarray(jkv.paged_attend(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                       jnp.asarray(table), jnp.asarray(pos)),
                      np.float32)
    bf = torch.bfloat16
    tk = torch.from_numpy(k0).to(bf)
    tv = torch.from_numpy(v0).to(bf)
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    tkv.paged_store(tk, tv, torch.from_numpy(k_new).to(bf),
                    torch.from_numpy(v_new).to(bf), tt, tp)
    got = tkv.paged_attend(torch.from_numpy(q).to(bf), tk, tv, tt, tp)
    assert got.dtype == bf
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))
    err = float(np.max(np.abs(got.float().numpy() - want)))
    assert err <= 2.0 ** -7 * float(np.max(np.abs(want)))


def test_paged_slots_drop_padding_once_for_every_layer():
    _name, table, pos = _cases()[1]
    rows, flat = tkv.paged_slots(torch.from_numpy(table),
                                 torch.from_numpy(pos), _PAGE)
    assert rows.tolist() == [0, 1]
    assert flat.tolist() == [5 * _PAGE + 1, 11 * _PAGE + 1]


def test_init_cache_shape_and_device():
    kv = tkv.init_cache(3, 7, 4, 2, 16, torch.bfloat16, device="cpu")
    for key in ("k_pages", "v_pages"):
        assert kv[key].shape == (3, 7, 4, 2, 16)
        assert kv[key].dtype == torch.bfloat16
        assert not kv[key].any()


# ------------------------------------------------------------ page pool


def test_page_pool_matches_jax_sequence():
    jp, tp = jkv.PagePool(8, 16), tkv.PagePool(8, 16)
    held = {}
    for step, n in enumerate([3, 6, 2, "free0", 4, 1, "free2", 3, 9, 1]):
        if isinstance(n, str):
            i = int(n[4:])
            for pool, side in ((jp, "j"), (tp, "t")):
                pool.free(held.pop((side, i)))
        else:
            a, b = jp.alloc(n), tp.alloc(n)
            assert a == b, step
            if a is not None:
                held[("j", step)], held[("t", step)] = a, b
        assert (jp.used, jp.available) == (tp.used, tp.available)
    for key in [k for k in held if k[0] == "t"]:
        tp.free(held[key])
    assert tp.used == 0
    assert tp.alloc(0) == [] and tp.alloc(9) is None
    with pytest.raises(AssertionError):
        tp.free([0])                     # over-free is a bug, loudly
    with pytest.raises(ValueError):
        tkv.PagePool(0, 16)


def test_pages_for():
    for n in (0, 1, 16, 17, 100):
        assert tkv.pages_for(n, 16) == jkv.pages_for(n, 16)


# ----------------------------------------------- decode-mode identity


def _decode_loop(forward, init_kv, cfg, prompt, steps, page_size=4,
                 pad_to=16, seed=0):
    """Greedy generation through the paged decode path, as
    tests/test_llm.py's ``_decode_loop`` (here on shuffled pages):
    ``forward(tokens, kv, table, positions) -> (logits np, kv)``.
    Returns (tokens, per-step last-position logits)."""
    n = len(prompt)
    kv = init_kv(cfg.n_layer, 32, page_size)
    order = np.random.default_rng(seed).permutation(32).tolist()
    p_max = jkv.pages_for(cfg.max_seq, page_size)
    pages = order[:jkv.pages_for(n, page_size)]
    table = np.zeros((1, p_max), np.int32)
    table[0, :len(pages)] = pages
    tokens = np.zeros((1, pad_to), np.int32)
    tokens[0, :n] = prompt
    pos = np.full((1, pad_to), -1, np.int32)
    pos[0, :n] = np.arange(n)
    logits, kv = forward(tokens, kv, table, pos)
    out_logits = [logits[0, n - 1]]
    cur = int(np.argmax(out_logits[0]))
    out, cached = [cur], n
    for _ in range(steps - 1):
        while cached // page_size + 1 > len(pages):
            pages.append(order[len(pages)])
            table[0, :len(pages)] = pages
        logits, kv = forward(np.asarray([[cur]], np.int32), kv, table,
                             np.asarray([[cached]], np.int32))
        cached += 1
        out_logits.append(logits[0, 0])
        cur = int(np.argmax(logits[0, 0]))
        out.append(cur)
    return out, out_logits


def _jax_forward(model, params):
    apply = jax.jit(model.apply)

    def forward(tokens, kv, table, pos):
        logits, kv = apply(
            params, jnp.asarray(tokens),
            kv_cache={"k_pages": kv["k_pages"], "v_pages": kv["v_pages"],
                      "page_table": jnp.asarray(table)},
            positions=jnp.asarray(pos))
        return np.asarray(logits), kv
    return forward


def _torch_forward(model):
    def forward(tokens, kv, table, pos):
        before = kv["k_pages"]
        with torch.inference_mode():
            logits, kv = model(torch.from_numpy(tokens).long(),
                               kv_cache={**kv,
                                         "page_table":
                                             torch.from_numpy(table)},
                               positions=torch.from_numpy(pos).long())
        assert kv["k_pages"] is before           # the pool, in place
        return logits.numpy(), kv
    return forward


def _torch_full_loop(model, prompt, steps):
    toks, logits_out = list(prompt), []
    with torch.no_grad():
        for _ in range(steps):
            logits = model(torch.tensor([toks]))
            logits_out.append(logits[0, -1].numpy())
            toks.append(int(np.argmax(logits_out[-1])))
    return toks[len(prompt):], logits_out


def _models(family):
    """(JAX cfg, JAX module, JAX params, port model, n_kv_head), tiny,
    float32, the port model loaded with the converted JAX weights."""
    if family == "gpt2":
        jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), remat=False,
                                   dtype=jnp.float32)
        params = jgpt2.gpt2_init(jcfg, jax.random.PRNGKey(0))
        jmodel, n_kv = jgpt2.GPT2(jcfg), jcfg.n_head
        convert = gpt2_params_from_numpy
        tmodel = tgpt2.GPT2(dataclasses.replace(
            tgpt2.GPT2Config.tiny(), remat=False, dtype=torch.float32),
            device="cpu")
    else:
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), remat=False,
                                   dtype=jnp.float32)
        params = jllama.llama_init(jcfg, jax.random.PRNGKey(1))
        jmodel, n_kv = jllama.Llama(jcfg), jcfg.n_kv_head
        convert = llama_params_from_numpy
        tmodel = tllama.Llama(dataclasses.replace(
            tllama.LlamaConfig.tiny(), remat=False, dtype=torch.float32),
            device="cpu")
    tmodel.load_state_dict(convert(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, jmodel, params, tmodel, n_kv


@pytest.mark.parametrize("family,prompt,steps", [
    ("gpt2", [3, 17, 42, 99, 7], 6),
    ("llama", [3, 17, 42, 99, 7, 250, 8], 5),
])
def test_decode_loop_matches_jax_and_full_forward(family, prompt, steps):
    """Llama has h_kv < h: the GQA cache and positional RoPE."""
    jcfg, jmodel, params, tmodel, n_kv = _models(family)
    d_head = jcfg.d_model // jcfg.n_head
    want, want_logits = _decode_loop(
        _jax_forward(jmodel, params),
        lambda L, n, p: jkv.init_cache(L, n, p, n_kv, d_head, jnp.float32),
        jcfg, prompt, steps)
    got, got_logits = _decode_loop(
        _torch_forward(tmodel),
        lambda L, n, p: tkv.init_cache(L, n, p, n_kv, d_head, torch.float32,
                                       device="cpu"),
        jcfg, prompt, steps)
    full, full_logits = _torch_full_loop(tmodel, prompt, steps)
    assert got == want == full
    for a, b, c in zip(got_logits, want_logits, full_logits):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-4)
