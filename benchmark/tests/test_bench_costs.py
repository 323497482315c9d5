"""The frozen yardsticks, checked by hand at the main path's shapes."""

from benchmark import costs

GPT2_124M = {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768,
             "n_layer": 12, "n_head": 12, "n_inner": None}
GPT2_XL = {"vocab_size": 50257, "n_positions": 1024, "n_embd": 1600,
           "n_layer": 48, "n_head": 25, "n_inner": None}


def test_flash_cost_at_the_main_path_shape():
    # B*H 192, T 1024, D 64, causal: 1024 * 1025 / 2 visible pairs.
    pairs = 524800
    tile = 192 * 1024 * 64 * 2
    rows = 192 * 1024 * 4
    assert costs.flash_cost("flash_fwd", 192, 1024, 64, True) == (
        4 * 64 * pairs * 192, 4 * tile + rows)
    assert costs.flash_cost("flash_dkv", 192, 1024, 64, True) == (
        8 * 64 * pairs * 192, 6 * tile + 2 * rows)
    assert costs.flash_cost("flash_dq", 192, 1024, 64, True) == (
        6 * 64 * pairs * 192, 5 * tile + 2 * rows)


def test_flash_roofline_bounds_match_the_kernel_table():
    # PERF.md's kernel table: 0.0303 ms (bytes), 0.0522, 0.0391 (FLOPs).
    kind = "NVIDIA H100 80GB HBM3"
    got = [costs.roofline_seconds(*costs.flash_cost(k, 192, 1024, 64, True),
                                  kind) * 1e3
           for k in ("flash_fwd", "flash_dkv", "flash_dq")]
    assert [round(x, 4) for x in got] == [0.0303, 0.0522, 0.0391]
    assert costs.roofline_seconds(1.0, 1.0, "cpu") is None


def test_training_flops_per_token_by_hand():
    # 124M: 6 * 124,318,464 parameters + 12 * 12 * 768 * 1024.
    n = 50257 * 768 + 1024 * 768 + 12 * (4 * 768 ** 2 + 2 * 768 * 3072)
    assert n == 124_318_464
    assert costs.train_flops_per_token(GPT2_124M) == 6.0 * n + 113_246_208
    n_xl = 50257 * 1600 + 1024 * 1600 + 48 * (4 * 1600 ** 2
                                              + 2 * 1600 * 6400)
    assert costs.train_flops_per_token(GPT2_XL) == \
        6.0 * n_xl + 12 * 48 * 1600 * 1024


def test_flops_per_token_agrees_with_the_port():
    from ray_tpu_torch.models.gpt2 import GPT2Config

    port = GPT2Config(vocab_size=50257, n_layer=48, n_head=25, d_model=1600,
                      d_ff=6400, max_seq=1024)
    assert costs.train_flops_per_token(GPT2_XL) == port.flops_per_token()
    assert costs.decode_flops_per_token(GPT2_XL, 300) == \
        port.decode_flops_per_token(300)


def test_serving_counts_by_hand():
    mm = 50257 * 768 + 12 * (4 * 768 ** 2 + 2 * 768 * 3072)
    assert costs.matmul_params(GPT2_124M) == mm
    assert costs.decode_flops_per_token(GPT2_124M, 100) == \
        2.0 * mm + 4 * 12 * 768 * 100
    # A prompt of 3: blocks for 3 positions, 1 + 2 + 3 attended, one
    # unembedding.
    assert costs.prefill_flops(GPT2_124M, 3) == \
        2.0 * (mm - 50257 * 768) * 3 + 4.0 * 12 * 768 * 6 + 2.0 * 50257 * 768
    assert costs.decode_step_weight_bytes(GPT2_124M) == 2.0 * mm
    # K and V, 12 layers, 768 wide, bf16: 36,864 bytes a position.
    assert costs.decode_token_kv_bytes(GPT2_124M, 10) == 36864.0 * 11
