"""K8's plain version (ops/qmlp.fused_layer_tail) against the JAX package's
Pallas tail kernel in interpret mode, at the JAX suite's shapes
(tests/test_qmlp.py, tests/test_int4_weights.py), plus the routing gates
and ``models/llama._layer_tail``.

Layers are quantized by the JAX package and carried across bit for bit;
activations come from numpy with a seed.  Tolerances, as RMSE / std of the
JAX result: bf16 1e-2 (tests/test_qmlp.py:77 and
tests/test_int4_weights.py:123: the same rounding points, but sums taken
in other orders flip single bf16 ulps three products deep); fp32 1e-5
(every rounding point is then a no-op: the same fp32 products summed in
another order, ~1e-7 expected).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu.ops import qmlp as jqmlp
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops import qmlp

BAR = {jnp.float32: 1e-5, jnp.bfloat16: 1e-2}
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _qmat(rng, k, n, int4):
    w = jnp.asarray((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    return jq.quantize_matrix_int4(w) if int4 else jq.quantize_matrix(w)


def _layer(seed, e, inter, q_dim, int4=False, wo_int4=None):
    """A JAX tail layer: [gate | up] fused, int8 or int4 (wo on its own)."""
    rng = np.random.default_rng(seed)
    key = "q4" if int4 else "q"
    gate, up = _qmat(rng, e, inter, int4), _qmat(rng, e, inter, int4)
    return {
        "wo": _qmat(rng, q_dim, e, int4 if wo_int4 is None else wo_int4),
        "mlp_norm": jnp.asarray(np.abs(rng.standard_normal(e)).astype(np.float32) + 0.5),
        "w_gate_up": {key: jnp.concatenate([gate[key], up[key]], -1),
                      "s": jnp.concatenate([gate["s"], up["s"]], -1)},
        "w_down": _qmat(rng, inter, e, int4),
    }


def _acts(seed, m, e, q_dim, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, e)).astype(np.float32)
    a = rng.standard_normal((m, q_dim)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), jnp.asarray(a).astype(dtype)


def _rel(got, want):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.sqrt(np.mean((g - w) ** 2)) / (np.std(w) + 1e-9))


def _both(layer, x, attn, eps=1e-5, **fold):
    """(port, JAX) tails of the same layer and inputs."""
    want = jqmlp.fused_layer_tail(
        x, layer["mlp_norm"], layer["w_gate_up"], layer["w_down"], eps=eps,
        attn_out=attn, wo=None if attn is None else layer["wo"], interpret=True,
        **fold,
    )
    tfold = {k: _tree(v) for k, v in fold.items()}
    got = qmlp.fused_layer_tail(
        _t(x), _t(layer["mlp_norm"]), _tree(layer["w_gate_up"]), _tree(layer["w_down"]),
        eps=eps, attn_out=None if attn is None else _t(attn),
        wo=None if attn is None else _tree(layer["wo"]), **tfold,
    )
    return got, want


@pytest.mark.parametrize(
    "m,e,inter,q_dim,dtype",
    [(16, 256, 512, 384, jnp.float32), (16, 256, 512, 384, jnp.bfloat16),
     (9, 128, 384, 128, jnp.float32), (32, 128, 256, 512, jnp.bfloat16)],
)
def test_fused_tail_int8_matches_jax(m, e, inter, q_dim, dtype):
    layer = _layer(0, e, inter, q_dim)
    x, attn = _acts(1, m, e, q_dim, dtype)
    got, want = _both(layer, x, attn)
    assert got.dtype == TDT[dtype] and _rel(got, want) < BAR[dtype]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_tail_int4_matches_jax(dtype):
    layer = _layer(6, 256, 512, 512, int4=True)
    x, attn = _acts(7, 16, 256, 512, dtype)
    got, want = _both(layer, x, attn)
    assert _rel(got, want) < BAR[dtype]


def test_fused_tail_mixed_int8_wo_matches_jax():
    layer = _layer(9, 256, 512, 512, int4=True, wo_int4=False)
    x, attn = _acts(11, 8, 256, 512, jnp.float32)
    got, want = _both(layer, x, attn)
    assert _rel(got, want) < BAR[jnp.float32]


def test_fused_tail_without_wo_matches_jax():
    layer = _layer(1, 128, 256, 128)
    x, _ = _acts(2, 16, 128, 128, jnp.float32)
    got, want = _both(layer, x, None)
    assert _rel(got, want) < BAR[jnp.float32]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_fused_tail_qkv_fold_matches_jax(int4):
    e, q_dim, f = 256, 512, 1024
    layer = _layer(5, e, 512, q_dim, int4=int4)
    rng = np.random.default_rng(12)
    fold = dict(next_attn_norm=jnp.asarray(np.abs(rng.standard_normal(e)).astype(np.float32) + 0.5),
                next_w_qkv=_qmat(rng, e, f, int4))
    x, attn = _acts(13, 8, e, q_dim, jnp.float32)
    (y, qkv), (jy, jqkv) = _both(layer, x, attn, **fold)
    assert _rel(y, jy) < BAR[jnp.float32]
    assert qkv.shape == (8, f) and _rel(qkv, jqkv) < BAR[jnp.float32]


def _torch_layer(cfg):
    return _tree(_layer(4, cfg.hidden_size, cfg.intermediate_size, cfg.q_dim))


def test_tail_supported_gates():
    cfg = tl.tiny()
    layer = _torch_layer(cfg)
    x = torch.zeros((4, 1, cfg.hidden_size))
    assert not qmlp.tail_supported(cfg, layer, x)  # True routes CUDA tensors only
    with config.patch({"kernel.qmlp": "force"}):
        assert qmlp.tail_supported(cfg, layer, x)
        assert not qmlp.tail_supported(cfg, layer, torch.zeros((4, 512, cfg.hidden_size)))
        unfused = {k: v for k, v in layer.items() if k != "w_gate_up"}
        assert not qmlp.tail_supported(cfg, unfused, x)
        assert not qmlp.tail_supported(cfg, {**layer, "wo": torch.zeros((cfg.q_dim, cfg.hidden_size))}, x)
        moe_cfg = types.SimpleNamespace(num_experts=4)
        assert not qmlp.tail_supported(moe_cfg, layer, x)
        assert not qmlp.tail_supported(cfg, layer, torch.zeros((4, 1, cfg.hidden_size), dtype=torch.int32))
        nxt = {"attn_norm": torch.ones(cfg.hidden_size), "w_qkv": layer["w_down"]}
        assert not qmlp.qkv_fold_supported(cfg, layer, nxt, x)  # in-dim != E
        w_qkv = {"q": torch.zeros((cfg.hidden_size, 1024), dtype=torch.int8), "s": torch.ones((1, 1024))}
        assert qmlp.qkv_fold_supported(cfg, layer, {**nxt, "w_qkv": w_qkv}, x)
        assert not qmlp.qkv_fold_supported(cfg, layer, None, x)
        assert not qmlp.qkv_fold_supported(cfg, layer, {"attn_norm": nxt["attn_norm"]}, x)
    with config.patch({"kernel.qmlp": False}):
        assert not qmlp.tail_supported(cfg, layer, x)


def test_layer_tail_routing_force(monkeypatch):
    """``kernel.qmlp="force"`` sends ``llama._layer_tail`` through the
    wrapper on the CPU; the result matches the unfused composition."""
    cfg = tl.tiny(dtype=torch.float32)
    layer = _torch_layer(cfg)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 1, cfg.hidden_size)).astype(np.float32))
    attn = torch.from_numpy(rng.standard_normal((4, 1, cfg.q_dim)).astype(np.float32))
    calls = []
    real = qmlp.fused_layer_tail
    monkeypatch.setattr(qmlp, "fused_layer_tail", lambda *a, **k: calls.append(1) or real(*a, **k))
    with config.patch({"kernel.qmlp": "force"}):
        got, qkv_next = tl._layer_tail(cfg, layer, x, attn)
    assert calls == [1] and qkv_next is None
    want, _ = tl._layer_tail(cfg, layer, x, attn)  # unfused on the CPU
    assert calls == [1] and got.shape == want.shape == x.shape
    assert float(torch.sqrt(torch.mean((got - want) ** 2)) / want.std()) < 5e-3
