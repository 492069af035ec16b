"""Port Llama model against the JAX package on identical weights.

``llama.tiny()`` params come from the JAX ``init_params(PRNGKey(0))`` and
are converted with ``models/convert.params_from_numpy``.  Prefill logits
and K/V come from ``forward_prefill``; decode logits from each package's
slots backend (cache writes + decode attention + ``forward_decode``).

Tolerance: the layers run in bf16 in both frameworks, which round at
different places (XLA fuses, PyTorch does not; the JAX flash kernel rounds
P to bf16).  First-layer K/V are computed before any attention and must be
bit-equal; later values may differ by a few bf16 ulps, so activations are
held to 2% of their largest magnitude and logits to 3% (measured: 1.5%).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu import config as jconfig
from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.serving.backends import SlotsBackend as JSlots
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.models import quantized
from quantumattention_tpu_torch.serving.backends import SlotsBackend as TSlots

LOGIT_REL = 0.03
KV_REL = 0.02


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), jl.tiny())


def _torch_params(jax_params, cfg):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), cfg, device="cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close(t, j, rel):
    a, b = _f32(j), _f32(t)
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=rel * np.abs(a).max(), rtol=0)


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (2, 40)).astype(np.int32), np.array([39, 20], np.int32)


def test_params_convert_bit_exact(jax_params):
    tp = _torch_params(jax_params, tl.tiny())
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(tp["layers"][1]["w_down"]), _f32(jax_params["layers"][1]["w_down"]))
    np.testing.assert_array_equal(tp["final_norm"].numpy(), np.asarray(jax_params["final_norm"]))


@pytest.mark.parametrize("impl", ["fp8", "bf16"])
def test_forward_prefill_matches_jax(jax_params, impl):
    tcfg, jcfg = tl.tiny(attention_impl=impl), jl.tiny(attention_impl=impl)
    tp = _torch_params(jax_params, tcfg)
    toks, last = _tokens()
    jlog, jkv = jl.forward_prefill(jax_params, jnp.asarray(toks), jcfg, last_pos=jnp.asarray(last))
    tlog, tkv = tl.forward_prefill(
        tp, torch.from_numpy(toks).long(), tcfg, last_pos=torch.from_numpy(last).long()
    )
    assert tlog.shape == (2, 256) and tlog.dtype == torch.float32
    _close(tlog, jlog, LOGIT_REL)
    np.testing.assert_array_equal(_f32(tkv[0][0]), _f32(jkv[0][0]))
    np.testing.assert_array_equal(_f32(tkv[0][1]), _f32(jkv[0][1]))
    for (tk, tv), (jk, jv) in zip(tkv[1:], jkv[1:]):
        _close(tk, jk, KV_REL)
        _close(tv, jv, KV_REL)


def test_forward_prefill_per_block_matches_jax(jax_params):
    """``scaling_method="per-block"`` through the model's prefill against
    JAX's, whose per-block runs its e4m3 container (``attention.fp8_dot``),
    the port's only one."""
    tcfg, jcfg = tl.tiny(scaling_method="per-block"), jl.tiny(scaling_method="per-block")
    tp = _torch_params(jax_params, tcfg)
    toks, last = _tokens()
    with jconfig.patch({"attention.fp8_dot": True}):
        jlog, jkv = jl.forward_prefill(jax_params, jnp.asarray(toks), jcfg,
                                       last_pos=jnp.asarray(last))
    tlog, tkv = tl.forward_prefill(
        tp, torch.from_numpy(toks).long(), tcfg, last_pos=torch.from_numpy(last).long()
    )
    _close(tlog, jlog, LOGIT_REL)
    for (tk, tv), (jk, jv) in zip(tkv[1:], jkv[1:]):
        _close(tk, jk, KV_REL)
        _close(tv, jv, KV_REL)


def test_forward_full_sequence_matches_jax(jax_params):
    tcfg, jcfg = tl.tiny(), jl.tiny()
    tp = _torch_params(jax_params, tcfg)
    toks, _ = _tokens()
    _close(
        tl.forward(tp, torch.from_numpy(toks[:, :24]).long(), tcfg),
        jl.forward(jax_params, jnp.asarray(toks[:, :24]), jcfg),
        LOGIT_REL,
    )


@pytest.mark.parametrize("impl", ["fp8", "bf16"])
def test_forward_decode_matches_jax(jax_params, impl):
    """Prefill two slots through each backend, then two decode steps."""
    tcfg, jcfg = tl.tiny(attention_impl=impl), jl.tiny(attention_impl=impl)
    tp = _torch_params(jax_params, tcfg)
    toks, last = _tokens()
    lens = [int(p) + 1 for p in last]
    jb = JSlots(jcfg, num_slots=2, max_len=64, cache_dtype=jnp.int8)
    tb = TSlots(tcfg, num_slots=2, max_len=64, cache_dtype=torch.int8, device="cpu")
    jb.prefill_and_write(
        functools.partial(jl.forward_prefill, cfg=jcfg), jax_params,
        jnp.asarray(toks), list(last), [0, 1], lens, 40,
    )
    tb.prefill_and_write(
        functools.partial(tl.forward_prefill, cfg=tcfg), tp,
        torch.from_numpy(toks).long(), list(last), [0, 1], lens, 40,
    )
    np.testing.assert_array_equal(tb.host_lengths(), jb.host_lengths())
    step_tokens = np.array([[7, 200], [31, 5]], np.int32)
    active = np.array([True, True])
    for cur in step_tokens:
        jlog = jb.decode(jax_params, cur, active, [0, 1])
        tlog = tb.decode(tp, cur, active, [0, 1])
        assert tlog.shape == (2, 256)
        _close(tlog, jlog, LOGIT_REL)
    np.testing.assert_array_equal(tb.host_lengths(), [42, 23])


def test_not_ported_configs_raise(jax_params):
    """A window and MoE, refused here before they were ported, now build:
    the window's prefill logits match JAX's (more in
    tests/test_torch_window.py), and an MoE config carries JAX's routing
    defaults (more in tests/test_torch_moe.py)."""
    jcfg, tcfg = jl.tiny(window=16), tl.tiny(window=16)
    tokens = np.random.default_rng(1).integers(0, 256, (1, 40)).astype(np.int32)
    want = np.asarray(jl.forward(jax_params, jnp.asarray(tokens), jcfg), np.float32)
    got = tl.forward(_torch_params(jax_params, tcfg), torch.from_numpy(tokens).long(), tcfg)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < LOGIT_REL
    moe_cfg = tl.tiny(num_experts=4)
    assert (moe_cfg.num_experts_per_tok, moe_cfg.capacity_factor) == (2, 1.25)
    assert "moe" in tl.init_params(torch.Generator().manual_seed(0), moe_cfg)["layers"][0]
    # Quantized trees serve; what the JAX package still refuses is training
    # one: int8 leaves are not differentiable (models/quantized.py:17-19).
    tp = tl.init_params(torch.Generator().manual_seed(0), tl.tiny())
    tp["layers"][0]["wq"] = quantized.quantize_matrix(tp["layers"][0]["wq"])
    tokens = torch.zeros((1, 4), dtype=torch.long)
    assert tl.forward(tp, tokens, tl.tiny()).shape == (1, 4, 256)
    with pytest.raises(TypeError, match="not differentiable"):
        tl.loss_and_grads(tp, tokens, tl.tiny())
    with pytest.raises(TypeError, match="not differentiable"):
        tl.train_step(tp, tokens, tl.tiny())


def test_init_params_shapes_and_seed():
    cfg = tl.tiny(tie_embeddings=True, qkv_bias=True)
    a = tl.init_params(torch.Generator().manual_seed(3), cfg)
    b = tl.init_params(torch.Generator().manual_seed(3), cfg)
    assert "lm_head" not in a and a["layers"][0]["bq"].shape == (cfg.q_dim,)
    assert a["layers"][0]["wk"].shape == (cfg.hidden_size, cfg.kv_dim)
    torch.testing.assert_close(a["embed"], b["embed"], atol=0, rtol=0)
    assert float(a["embed"].float().abs().max()) <= 3.0 / np.sqrt(cfg.vocab_size) + 1e-3
    logits = tl.forward(a, torch.zeros((1, 5), dtype=torch.long), cfg)
    assert logits.shape == (1, 5, cfg.vocab_size) and bool(torch.isfinite(logits).all())
