"""The plain reference against values worked out by hand, and against
the port's float32 model at a small size on the CPU."""

import math

import pytest
import torch

from benchmark.harness import weights as W
from benchmark.reference import gpt2 as ref

CFG = {"vocab_size": 64, "n_positions": 16, "n_embd": 32, "n_layer": 2,
       "n_head": 2, "n_inner": None, "layer_norm_epsilon": 1e-6,
       "initializer_range": 0.02}


def test_layer_norm_and_gelu_by_hand():
    x = torch.tensor([[1.0, 2.0, 3.0]])
    y = ref.layer_norm(x, torch.ones(3), torch.zeros(3), 0.0)
    s = math.sqrt(2.0 / 3.0)
    assert torch.allclose(y, torch.tensor([[-1 / s, 0.0, 1 / s]]))
    g = ref.gelu(torch.tensor([0.0, 1.0, -1.0]))
    assert torch.allclose(g, torch.tensor([0.0, 0.8411920, -0.1588080]),
                          atol=1e-6)


def test_zero_weights_give_the_uniform_loss():
    p = {k: torch.zeros_like(v) for k, v in
         W.gpt2_weights(CFG, 1, "cpu").items()}
    tokens = torch.randint(0, 64, (3, 9))
    loss, grads = ref.loss_and_grads(p, tokens, CFG, rows=2)
    assert loss == pytest.approx(math.log(64), rel=1e-6)
    assert set(grads) == set(p)


def test_attention_is_causal():
    p = W.gpt2_weights(CFG, 2, "cpu")
    a = torch.randint(0, 64, (10,))
    b = a.clone()
    b[7:] = (b[7:] + 1) % 64
    ha, hb = (ref.hidden(p, t[None], CFG)[0] for t in (a, b))
    assert torch.equal(ha[:7], hb[:7])
    assert not torch.allclose(ha[7:], hb[7:])


def test_gradients_against_finite_differences():
    p = {k: v.double() for k, v in W.gpt2_weights(CFG, 3, "cpu").items()}
    tokens = torch.randint(0, 64, (2, 6))
    _loss, g = ref.loss_and_grads(p, tokens, CFG, rows=1)
    for name, idx in (("h_1.mlp_out.kernel", (3, 4)), ("wte", (5, 6)),
                      ("h_0.ln_1.scale", (2,))):
        eps = 1e-6
        hi = {k: v.clone() for k, v in p.items()}
        lo = {k: v.clone() for k, v in p.items()}
        hi[name][idx] += eps
        lo[name][idx] -= eps
        n = tokens.shape[0] * (tokens.shape[1] - 1)
        fd = (float(ref.loss_sum(hi, tokens, CFG))
              - float(ref.loss_sum(lo, tokens, CFG))) / (2 * eps * n)
        assert float(g[name][idx]) == pytest.approx(fd, rel=1e-5, abs=1e-9)


def test_adamw_first_steps_by_hand():
    opt = {"learning_rate": 0.1, "warmup_steps": 2, "total_steps": 10,
           "weight_decay": 0.5, "grad_clip": 1.0, "b1": 0.9, "b2": 0.95,
           "eps": 1e-8}
    adam = ref.AdamW(opt)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([3.0, 4.0])}          # norm 5: clipped to 1
    seen = {}
    adam.update(p, g, lambda name, gk: seen.update({name: gk}))
    assert torch.allclose(seen["w"], torch.tensor([0.6, 0.8]))
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0]))   # lr(0) = 0
    adam.update(p, {"w": torch.tensor([0.3, -0.4])})        # norm 0.5
    mu = 0.9 * 0.1 * torch.tensor([0.6, 0.8]) + 0.1 * torch.tensor([0.3, -0.4])
    nu = 0.95 * 0.05 * torch.tensor([0.36, 0.64]) \
        + 0.05 * torch.tensor([0.09, 0.16])
    upd = (mu / (1 - 0.9 ** 2)) / (torch.sqrt(nu / (1 - 0.95 ** 2)) + 1e-8)
    want = torch.tensor([1.0, -2.0]) - 0.05 * (upd + 0.5 * torch.tensor(
        [1.0, -2.0]))                               # lr(1) = 0.1 * 1 / 2
    assert torch.allclose(p["w"], want, atol=1e-7)


def test_warmup_cosine_schedule():
    lr = ref.warmup_cosine(0.0, 1.0, 10, 110, 0.1)
    assert [lr(0), lr(5), lr(10)] == [0.0, 0.5, 1.0]
    assert lr(60) == pytest.approx(0.55)
    assert lr(110) == pytest.approx(0.1) and lr(500) == pytest.approx(0.1)


def test_fp8_products_are_close_but_not_exact():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    exact = a @ b
    low = ref.matmul(a, b, "fp8")
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2


def test_fp8_bf16_keeps_activations_and_their_gradients_in_bfloat16():
    x = torch.randn(8, 8, requires_grad=True)
    y = ref.store(x, "fp8_bf16")
    assert torch.equal(y, x.detach().to(torch.bfloat16).float())
    g = torch.randn(8, 8)
    y.backward(g)
    assert torch.equal(x.grad, g.to(torch.bfloat16).float())
    assert ref.store(x, "fp8") is x

    p = W.gpt2_weights(CFG, 5, "cpu")
    tokens = torch.randint(0, 64, (2, 9))
    h = ref.hidden(p, tokens, CFG, "fp8_bf16")
    assert torch.equal(h, h.to(torch.bfloat16).float())
    a = ref.loss_and_grads(p, tokens, CFG, rows=2, precision="fp8")[1]
    b = ref.loss_and_grads(p, tokens, CFG, rows=2,
                           precision="fp8_bf16")[1]
    assert not torch.equal(a["h_0.mlp_in.kernel"], b["h_0.mlp_in.kernel"])


def test_reference_matches_the_port_in_float32():
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_loss_fn

    p = W.gpt2_weights(CFG, 4, "cpu")
    port = GPT2(GPT2Config(vocab_size=64, n_layer=2, n_head=2, d_model=32,
                           d_ff=128, max_seq=16, dtype=torch.float32,
                           remat=False), "cpu")
    port.load_state_dict(p)
    tokens = torch.randint(0, 64, (3, 17))
    want, grads = ref.loss_and_grads(p, tokens, CFG, rows=3)
    got = gpt2_loss_fn(port.cfg, port, {"tokens": tokens}, loss_chunk=0)
    assert float(got.detach()) == pytest.approx(want, rel=1e-5)
    got.backward()
    for name, param in port.named_parameters():
        assert torch.allclose(param.grad, grads[name], rtol=1e-3, atol=1e-6)
