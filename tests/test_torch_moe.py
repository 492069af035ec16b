"""The port's MoE FFN (models/moe.py) and MoE trees against the JAX package.

Mirrors tests/test_moe.py:31-124 and :172-190 on the port (the expert-
parallel tests wait for ``parallel/``), then holds ``moe_ffn`` against
JAX's on the same numpy inputs and weights: float32 within 1e-5 of the
largest output, bf16 within 2e-2, with and without dropping (capacity
factor 1.0 and 4.0), the aux losses likewise.  Routing is compared where
the k-th and (k+1)-th logits differ by more than 1e-4 (the data is checked
to have no closer tie): a nearer tie may flip between two fp32 products.
Then the MoE trees: 3-D quantization equal to JAX's (codes within +-1 on
under 1% of entries, as tests/test_torch_quantized.py, scales within one
fp32 ulp), ``convert`` bit for bit, the model's forward against JAX's at
float32, the gates that keep MoE layers on the unfused step, and one
expert product a kernel call under the kernel route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import moe as jm
from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import convert, moe
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.models import quantized as tq
from quantumattention_tpu_torch.ops import megastep, qmlp, qmm
from quantumattention_tpu_torch.serving.backends import SlotsBackend

TIE_GAP = 1e-4


def _params(seed, e=8, h=64, i=128, dtype=torch.float32):
    return moe.init_moe_params(torch.Generator().manual_seed(seed), h, i, e, dtype=dtype)


def _dense_swiglu(w_gate, w_up, w_down, x):
    gate = x @ w_gate
    up = x @ w_up
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return act @ w_down


def _to_jax(tree):
    out = {}
    for k, v in tree.items():
        a = v.float().numpy()
        out[k] = jnp.asarray(a, jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
    return out


# ---------------------------------------------------------------------------
# tests/test_moe.py, mirrored
# ---------------------------------------------------------------------------


def test_router_topk_gates_renormalized():
    logits = torch.randn((32, 8), generator=torch.Generator().manual_seed(0))
    gates, experts = moe.router_topk(logits, 2)
    assert gates.shape == (32, 2) and experts.shape == (32, 2) and experts.dtype == torch.int32
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert bool((experts[:, 0] != experts[:, 1]).all())
    chosen = logits.gather(1, experts.long())
    assert bool((chosen[:, 0] >= chosen[:, 1]).all())


def test_dispatch_combine_shapes_and_conservation():
    n, e, k, cap = 64, 8, 2, 32
    logits = torch.randn((n, e), generator=torch.Generator().manual_seed(1))
    gates, experts = moe.router_topk(logits, k)
    dispatch, combine = moe.make_dispatch_combine(gates, experts, e, cap)
    assert dispatch.shape == combine.shape == (n, e, cap)
    assert dispatch.dtype == torch.bfloat16 and combine.dtype == torch.float32
    d = dispatch.float()
    assert float(d.sum(0).max()) <= 1.0 + 1e-6
    assert float(d.sum((1, 2)).max()) <= k + 1e-6
    assert bool((combine.sum((1, 2)) <= 1.0 + 1e-5).all())
    # The same gates and experts through JAX give the same tensors.
    jd, jc = jm.make_dispatch_combine(jnp.asarray(gates.numpy()), jnp.asarray(experts.numpy()), e, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd, np.float32))
    np.testing.assert_array_equal(combine.numpy(), np.asarray(jc))


@pytest.mark.parametrize("n,e,k,cf,want", [(64, 8, 2, 1.25, 24), (4, 8, 2, 1.25, 8), (1500, 8, 2, 1.25, 472),
                                           (1536, 8, 2, 1.25, 480), (32, 4, 2, 0.5, 8)])
def test_expert_capacity_matches_jax(n, e, k, cf, want):
    assert moe.expert_capacity(n, e, k, cf) == jm.expert_capacity(n, e, k, cf) == want


def test_identical_experts_equal_dense_mlp():
    p = _params(2)
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = p[name][:1].expand_as(p[name]).contiguous()
    x = torch.randn((4, 16, 64), generator=torch.Generator().manual_seed(3))
    y = moe.moe_ffn(p, x, num_experts_per_tok=2, capacity_factor=8.0)
    ref = _dense_swiglu(p["w_gate"][0], p["w_up"][0], p["w_down"][0], x)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)


def test_capacity_dropping_zeroes_overflow():
    """Capacity 8, every token routed to experts 0 then 1 (a rigged
    router): the first 8 tokens keep both choices, tokens past 16 none."""
    p = _params(4, e=4)
    p["w_router"] = torch.zeros_like(p["w_router"])
    p["w_router"][0, 0], p["w_router"][0, 1] = 100.0, 50.0
    n = 32
    x = torch.ones((n, 64)) * 0.1
    y, aux = moe.moe_ffn(p, x, num_experts_per_tok=2, capacity_factor=8 * 4 / (2 * n), return_aux=True)
    assert y.shape == (n, 64)
    assert bool((y[16:].abs() == 0).all()) and bool((y[:8].abs() > 0).any())
    assert np.isfinite(float(aux["load_balancing_loss"]))


def test_load_balancing_loss_uniform_is_one():
    n, e = 512, 8
    probs = torch.full((n, e), 1.0 / e)
    experts = torch.stack([torch.arange(n) % e, (torch.arange(n) + 1) % e], dim=1).to(torch.int32)
    np.testing.assert_allclose(float(moe.load_balancing_loss(probs, experts, e)), 1.0, rtol=1e-6)


def test_moe_grads_flow():
    p = {k: v.requires_grad_(True) for k, v in _params(5).items()}
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(6))
    y, aux = moe.moe_ffn(p, x, num_experts_per_tok=2, capacity_factor=4.0, return_aux=True)
    loss = (y.float() ** 2).mean() + 0.01 * aux["load_balancing_loss"] + 0.001 * aux["router_z_loss"]
    grads = torch.autograd.grad(loss, list(p.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().max()) > 0.0  # the router, through gates and the aux loss


def test_mixtral_style_decoder_forward_and_train():
    cfg = tl.tiny(num_experts=4, num_experts_per_tok=2, attention_impl="sdpa")
    params = tl.init_params(torch.Generator().manual_seed(10), cfg)
    assert "moe" in params["layers"][0] and "w_gate" not in params["layers"][0]
    tokens = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(11))
    logits = tl.forward(params, tokens, cfg)
    assert logits.shape == (2, 16, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    before = params["layers"][0]["moe"]["w_gate"].clone()
    router = params["layers"][0]["moe"]["w_router"].clone()
    new_params, loss = tl.train_step(params, tokens, cfg)
    assert np.isfinite(float(loss))
    assert float((new_params["layers"][0]["moe"]["w_gate"].float() - before.float()).abs().max()) > 0.0
    assert float((new_params["layers"][0]["moe"]["w_router"] - router).abs().max()) > 0.0


# ---------------------------------------------------------------------------
# moe_ffn against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_ffn_matches_jax(dtype, cf):
    p = _params(7, e=8, h=64, i=128, dtype=dtype)
    x = torch.randn((3, 24, 64), generator=torch.Generator().manual_seed(8)).to(dtype)
    logits = torch.matmul(x.reshape(-1, 64).float(), p["w_router"])
    top = torch.topk(logits, 3, dim=-1).values
    assert float((top[:, 1] - top[:, 2]).min()) > TIE_GAP  # no near-tie at the k-th choice

    jp = _to_jax(p)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jy, jaux = jm.moe_ffn(jp, jx, num_experts_per_tok=2, capacity_factor=cf, return_aux=True)
    y, aux = moe.moe_ffn(p, x, num_experts_per_tok=2, capacity_factor=cf, return_aux=True)
    assert y.dtype == dtype and y.shape == x.shape
    want = np.asarray(jy, np.float32)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(y.float().numpy(), want, atol=tol * np.abs(want).max(), rtol=0)
    for name in ("load_balancing_loss", "router_z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), rtol=1e-5)
    # The same routing and the same drops.
    jg, je = jm.router_topk(jnp.asarray(logits.numpy()), 2)
    g, ex = moe.router_topk(logits, 2)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    cap = moe.expert_capacity(x.shape[0] * x.shape[1], 8, 2, cf)
    jd, _ = jm.make_dispatch_combine(jg, je, 8, cap)
    d, _ = moe.make_dispatch_combine(g, ex, 8, cap)
    np.testing.assert_array_equal(d.float().numpy(), np.asarray(jd, np.float32))
    if cf == 1.0:
        assert float(d.float().sum()) < 2 * x.shape[0] * x.shape[1]  # something dropped


def test_init_moe_params_shapes_and_scale():
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 64, 96, 4, dtype=torch.bfloat16)
    assert p["w_router"].dtype == torch.float32 and p["w_router"].shape == (64, 4)
    assert p["w_gate"].shape == p["w_up"].shape == (4, 64, 96) and p["w_down"].shape == (4, 96, 64)
    assert p["w_gate"].dtype == torch.bfloat16
    assert float(p["w_down"].float().abs().max()) <= 3.0 / np.sqrt(96) + 1e-3
    assert float(p["w_up"].float().abs().max()) <= 3.0 / np.sqrt(64) + 1e-3


# ---------------------------------------------------------------------------
# MoE trees: presets, quantization, convert, the model
# ---------------------------------------------------------------------------


def test_mixtral_8x7b_fields_match_jax():
    t, j = tl.mixtral_8x7b(), jl.mixtral_8x7b()
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_q_heads",
                  "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps", "window",
                  "tie_embeddings", "qkv_bias", "num_experts", "num_experts_per_tok", "capacity_factor"):
        assert getattr(t, field) == getattr(j, field), field
    assert tl.LlamaConfig().num_experts_per_tok == 2 and tl.LlamaConfig().capacity_factor == 1.25
    assert tl.mixtral_8x7b(num_layers=2).num_layers == 2


def test_quantize_matrix_3d_matches_jax():
    w = (np.random.default_rng(0).standard_normal((4, 128, 256)) / np.sqrt(128)).astype(np.float32)
    t = tq.quantize_matrix(torch.from_numpy(w))
    j = jq.quantize_matrix(jnp.asarray(w))
    assert t["q"].shape == (4, 128, 256) and t["s"].shape == (4, 1, 256)
    diff = np.abs(t["q"].numpy().astype(np.int16) - np.asarray(j["q"]).astype(np.int16))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]), rtol=1.2e-7, atol=0)
    for e in range(4):  # per expert, per column: the 2-D quantizer on each slice
        one = tq.quantize_matrix(torch.from_numpy(w[e]))
        assert torch.equal(one["q"], t["q"][e]) and torch.equal(one["s"], t["s"][e])


MOE_WIDE = dict(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2, head_dim=64,
                num_experts=4)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_quantized_moe_trees(int4):
    cfg = tl.tiny(**MOE_WIDE)
    full = tl.init_params(torch.Generator().manual_seed(1), cfg)
    tree = (tq.quantize_params_int4 if int4 else tq.quantize_params)(full)
    layer = tree["layers"][0]
    assert tq.is_quantized4(layer["wq"]) == int4
    for k in ("w_gate", "w_up", "w_down"):  # int8 whatever the mode, per-expert scales
        assert tq.is_quantized(layer["moe"][k]) and layer["moe"][k]["s"].shape[:2] == (4, 1)
    assert torch.equal(layer["moe"]["w_router"], full["layers"][0]["moe"]["w_router"])
    # Drawn and quantized matrix by matrix: the same tree.
    streamed = tq.init_quantized_params(torch.Generator().manual_seed(1), cfg, int4=int4)
    for a, b in zip(tl.leaves(streamed), tl.leaves(tree)):
        for x, y in ((a, b),) if isinstance(a, torch.Tensor) else zip(a.values(), b.values()):
            assert torch.equal(x, y)
    # JAX quantizes the converted full tree to the same codes.
    jtree = (jq.quantize_params_int4 if int4 else jq.quantize_params)(
        jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(full)))
    for k in ("w_gate", "w_down"):
        diff = np.abs(layer["moe"][k]["q"].numpy().astype(np.int16)
                      - np.asarray(jtree["layers"][0]["moe"][k]["q"]).astype(np.int16))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    fused = tq.fuse_projections(tree)["layers"][0]
    assert "w_qkv" in fused and "w_gate_up" not in fused and fused["moe"] is layer["moe"]


def test_convert_moe_trees_bit_exact():
    jcfg = jl.tiny(num_experts=4)
    jp = jl.init_params(jax.random.PRNGKey(3), jcfg)
    for tree in (jp, jq.quantize_params(jp)):
        npt = jax.tree_util.tree_map(np.asarray, tree)
        tp = convert.params_from_numpy(npt, tl.tiny(num_experts=4), device="cpu")
        assert tp["layers"][0]["moe"]["w_router"].dtype == torch.float32
        back = convert.params_to_numpy(tp)
        flat_a = jax.tree_util.tree_leaves_with_path(npt)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, a in flat_a:
            b = flat_b[path]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_forward_matches_jax(cf):
    """A tiny Mixtral at float32 and SDPA attention: logits within 1e-4 of
    JAX's largest (the routing equal: float32 leaves no near-tie flipping)."""
    jcfg = jl.tiny(num_experts=4, dtype=jnp.float32, attention_impl="sdpa", capacity_factor=cf)
    tcfg = tl.tiny(num_experts=4, dtype=torch.float32, attention_impl="sdpa", capacity_factor=cf)
    jp = jl.init_params(jax.random.PRNGKey(4), jcfg)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jcfg))
    got = tl.forward(tp, torch.from_numpy(tokens).long(), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_moe_layers_take_the_unfused_step():
    """The lean decode, K8 and K9 all refuse MoE, as in JAX (llama.py:581,
    qmlp.py:232, megastep.py:383): a fused int8 MoE tree's decode step runs
    the generic decoder with neither kernel, even with both forced."""
    cfg = tl.tiny(**dict(MOE_WIDE, head_dim=128, num_q_heads=2, num_kv_heads=1))
    tree = tq.fuse_projections(tq.init_quantized_params(torch.Generator().manual_seed(2), cfg))
    assert not tl._lean_decode_supported(cfg, tree)
    slots = 16
    backend = SlotsBackend(cfg, num_slots=slots, max_len=64, cache_dtype=torch.int8, device="cpu")
    x = torch.zeros((slots, cfg.hidden_size), dtype=torch.bfloat16)
    with config.patch({"kernel.qmlp": "force", "kernel.megastep": "force", "kernel.qmm": "force"}):
        assert not qmlp.tail_supported(cfg, tree["layers"][0], x)
        assert not megastep.megastep_supported(cfg, tree, backend.caches[0], slots)
        assert backend.route(tree) == "unfused"
        k8, k9 = qmlp.fused_layer_tail.launches, megastep.fused_decode_layer.launches
        logits = backend.decode(tree, np.arange(slots) % 256, np.ones(slots, bool))
    assert logits.shape == (slots, 256) and bool(torch.isfinite(logits).all())
    assert (qmlp.fused_layer_tail.launches, megastep.fused_decode_layer.launches) == (k8, k9)


def test_expert_products_go_through_the_kernel_wrapper_per_expert(monkeypatch):
    """Under the kernel route an int8 expert stack runs one K5/K6 wrapper
    call per expert (on the CPU its plain version), 3 x E for one layer,
    and agrees with the plain einsum over the dequantized stacks."""
    cfg = tl.tiny(**MOE_WIDE)
    tree = tq.init_quantized_params(torch.Generator().manual_seed(3), cfg)
    layer = tree["layers"][0]
    x = torch.randn((2, 20, cfg.hidden_size), generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    calls = []
    wrapper = qmm.quantized_matmul

    def counting(xx, w, s, **kw):
        calls.append((tuple(xx.shape), tuple(w.shape)))
        return wrapper(xx, w, s, **kw)

    monkeypatch.setattr(qmm, "quantized_matmul", counting)
    with config.patch({"kernel.qmm": "force"}):
        y = moe.moe_ffn(layer["moe"], x, num_experts_per_tok=2, capacity_factor=1.25)
    assert len(calls) == 3 * cfg.num_experts
    cap = moe.expert_capacity(40, 4, 2, 1.25)
    assert calls[0] == ((cap, cfg.hidden_size), (cfg.hidden_size, cfg.intermediate_size))
    with config.patch({"kernel.qmm": False}):
        ref = moe.moe_ffn(layer["moe"], x, num_experts_per_tok=2, capacity_factor=1.25)
    assert len(calls) == 3 * cfg.num_experts
    err = float((y.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert err < 2.0 ** -6, err
