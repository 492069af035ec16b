"""``perfbench/work.py`` against counts made by hand."""

import types

import pytest

from perfbench import work


def cfg(window=None, experts=0):
    return types.SimpleNamespace(
        hidden_size=8, intermediate_size=16, num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=2,
        vocab_size=10, window=window, num_experts=experts, num_experts_per_tok=2)


@pytest.mark.parametrize("kw, keys", [
    (dict(q_len=4), 1 + 2 + 3 + 4),
    (dict(q_len=4, window=2), 1 + 2 + 2 + 2),
    (dict(q_len=3, q_offset=5), 6 + 7 + 8),
    (dict(q_len=3, q_offset=5, window=4), 4 + 4 + 4),
    (dict(q_len=3, kv_len=5, causal=False), 15),
])
def test_attention_keys(kw, keys):
    assert work.attention_keys(**kw) == keys


def test_frozen_model_and_the_exact_count():
    s, h, d = 4096, 32, 128
    frozen = work.dense_attention_flops(1, h, s, s, d, causal=True)
    assert frozen == 4 * h * s * s * d // 2
    att = work.attention_flops(work.attention_keys(s), h, d)
    assert att["qk"] + att["pv"] == 4 * d * h * s * (s + 1) // 2
    windowed = work.attention_flops(work.attention_keys(s, window=1024), h, d)
    assert windowed["qk"] < 0.45 * att["qk"]


def test_int8_bytes():
    assert work.int8_bytes((4096, 14336)) == 4096 * 14336 + 4 * 14336
    assert work.int8_bytes((8, 4096, 14336)) == 8 * 4096 * 14336 + 4 * 8 * 14336


def test_decode_step_by_hand():
    c = cfg(window=3)
    w = work.decode_step(c, [2, 5])
    per_layer = 8 * 8 + 8 * 4 * 2 + 8 * 8 + 3 * 8 * 16  # wq, wk + wv, wo, gate + up + down
    keys = 2 + 3  # the second slot's 5 rows are cut to the window of 3
    flops = 2 * (2 * 2 * per_layer + 2 * 2 * 2 * keys * 4) + 2 * 2 * 8 * 10
    assert w["flops"] == flops
    layer_bytes = per_layer + 4 * (8 + 4 + 4 + 8 + 16 + 16 + 8)
    cache = 2 * keys * 2 * 2 * (2 + 4)
    assert w["bytes"] == 2 * layer_bytes + (8 * 10 + 4 * 10) + cache
    assert w["cache_bytes"] == cache


def test_moe_reads_every_expert_and_computes_top_k():
    c = cfg(experts=4)
    mats = work.layer_matrices(c)
    assert mats["moe.w_gate"] == (4, 8, 16)
    attn = 8 * 8 + 8 * 4 * 2 + 8 * 8
    assert work.token_matmul_weights(c) == attn + 2 * 3 * 8 * 16 + 8 * 4
    experts = 2 * (4 * 8 * 16 + 4 * 4 * 16) + (4 * 16 * 8 + 4 * 4 * 8)
    assert work.layer_int8_bytes(c) == work.layer_int8_bytes(cfg()) - work.int8_bytes((8, 16)) * 2 \
        - work.int8_bytes((16, 8)) + experts + 4 * 8 * 4
    step = work.qmm_decode_step(c, 3)
    assert step["bytes"] == 2 * sum(work.int8_bytes(s) for s in mats.values()) + work.int8_bytes((8, 10))


def test_prefill_and_k1_bound():
    c = cfg(window=4)
    w = work.prefill_call(c, [3, 6])
    keys = (1 + 2 + 3) + (1 + 2 + 3 + 4 + 4 + 4)
    assert w["tokens"] == 9
    assert w["qk"] == w["pv"] == 2 * 2 * 2 * keys * 4
    assert w["products"] == 2 * 2 * 9 * work.token_matmul_weights(c) + 2 * 2 * 8 * 10
    assert work.k1_seconds(1979e12, 989e12) == pytest.approx(2.0)
    assert work.k1_seconds(989e12, 989e12, fp8_qk=False) == pytest.approx(2.0)
