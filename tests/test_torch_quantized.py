"""Quantized weight trees (models/quantized.py) and the slice as a whole:
quantizers and packing against the JAX package, trees carried across by
``models/convert``, the model's forward, prefill and lean decode, and the
engine serving int8 and int4 fused trees.

Tolerances: int8/int4 codes equal the JAX package's up to +-1 flips on
under 1% of entries (tests/test_quantized_weights.py:94-113: the two
frameworks may round w / s on either side of .5), scales within 1 fp32
ulp.  Model logits within 3% of their largest magnitude, the bar of
tests/test_torch_llama.py (bf16 layers round at other places in the two
frameworks; the fused tail is forced on both sides).  The lean decode
equals the generic decode exactly: the same ops in the same order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu import config as jconfig
from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu.serving.backends import SlotsBackend as JSlots
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.models import quantized as tq
from quantumattention_tpu_torch.serving.backends import SlotsBackend as TSlots
from quantumattention_tpu_torch.serving.engine import Engine

LOGIT_REL = 0.03
#: int4 needs input dims in 256-row packing blocks (the JAX suite's CFG4).
WIDE = dict(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2, head_dim=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _codes_match(a, b):
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def _weights(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


def test_is_quantized_predicates():
    q = {"q": torch.zeros((2, 2), dtype=torch.int8), "s": torch.ones((1, 2))}
    q4 = {"q4": torch.zeros((128, 2), dtype=torch.int8), "s": torch.ones((2, 2))}
    assert tq.is_quantized(q) and not tq.is_quantized4(q)
    assert tq.is_quantized4(q4) and not tq.is_quantized(q4)
    assert not tq.is_quantized({"w": torch.zeros(2)}) and not tq.is_quantized(torch.zeros(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_match_jax(dtype):
    w = _weights(0, (512, 384))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    j8, t8 = jq.quantize_matrix(jw), tq.quantize_matrix(tw)
    _codes_match(t8["q"], j8["q"])
    np.testing.assert_array_max_ulp(t8["s"].numpy(), np.asarray(j8["s"]), maxulp=1)
    j4, t4 = jq.quantize_matrix_int4(jw), tq.quantize_matrix_int4(tw)
    assert t4["q4"].shape == (256, 384) and t4["s"].shape == (4, 384)
    _codes_match(tq.unpack_int4_rows(t4["q4"]), jq.unpack_int4_rows(j4["q4"]))
    np.testing.assert_array_max_ulp(t4["s"].numpy(), np.asarray(j4["s"]), maxulp=1)
    je, te = jq.quantize_embed(jw), tq.quantize_embed(tw)
    _codes_match(te["q"], je["q"])
    np.testing.assert_array_max_ulp(te["s"].numpy(), np.asarray(je["s"]), maxulp=1)
    with pytest.raises(ValueError, match="256"):
        tq.quantize_matrix_int4(torch.zeros((128, 64)))


def test_pack_roundtrip_tiles_and_dequantize_match_jax():
    q = np.random.default_rng(1).integers(-8, 8, (1024, 384)).astype(np.int8)
    p = tq.pack_int4_rows(torch.from_numpy(q))
    assert p.shape == (512, 384)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jq.pack_int4_rows(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4_rows(p).numpy(), q)
    # Any 128-packed-row tile unpacks to a contiguous original-row range.
    np.testing.assert_array_equal(tq.unpack_int4_rows(p[128:256]).numpy(), q[256:512])
    jw = jq.quantize_matrix_int4(jnp.asarray(_weights(2, (512, 256))))
    tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize_int4(tw, tdt).float().numpy(),
            np.asarray(jq.dequantize_int4(jw, jdt).astype(jnp.float32)),
        )


def test_engine_takes_its_device_from_a_quantized_embedding():
    """A quantized tree's embedding is a dict: the engine reads the device
    of its codes."""
    params = tq.quantize_params(tl.init_params(torch.Generator().manual_seed(0), tl.tiny()))
    assert isinstance(params["embed"], dict)
    eng = Engine(params, tl.tiny(), num_slots=1, max_len=32)
    assert eng.device == torch.device("cpu") and eng.caches[0].k.device.type == "cpu"


def test_quantized_tree_structure_matches_jax():
    """quantize_params / quantize_params_int4 / fuse_projections build the
    JAX package's tree: the same keys, int8-vs-int4 choices and shapes."""
    cfg = jl.tiny(**WIDE)
    jfp = jl.init_params(jax.random.PRNGKey(1), cfg)
    tfp = convert.params_from_numpy(_np(jfp), tl.tiny(**WIDE), device="cpu")
    for jfn, tfn in ((jq.quantize_params, tq.quantize_params),
                     (jq.quantize_params_int4, tq.quantize_params_int4)):
        jtree = jq.fuse_projections(jfn(jfp))
        ttree = convert.params_to_numpy(tq.fuse_projections(tfn(tfp)))
        jleaves, jdef = jax.tree_util.tree_flatten(jtree)
        tleaves, tdef = jax.tree_util.tree_flatten(ttree)
        assert jdef == tdef
        for a, b in zip(tleaves, jleaves):
            assert a.shape == b.shape and a.dtype == np.asarray(b).dtype
    layer = tq.fuse_projections(tq.quantize_params_int4(tfp))["layers"][0]
    assert "q4" in layer["w_qkv"] and "q4" in layer["w_gate_up"] and "wq" not in layer
    small = tq.quantize_params_int4(tl.init_params(torch.Generator().manual_seed(2), tl.tiny()))
    assert "q" in small["layers"][0]["wq"]  # hidden 128: int8 fallback
    assert "q4" in small["layers"][0]["wo"]  # q_dim 512: int4
    with pytest.raises(ValueError, match="mixed"):
        tq.fuse_projections({"layers": [{"wq": small["layers"][0]["wo"], "wk": small["layers"][0]["wq"],
                                         "wv": small["layers"][0]["wq"]}]})


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_init_quantized_params_equals_quantize_of_init(int4):
    cfg = tl.tiny(**WIDE, tie_embeddings=True)
    direct = tq.init_quantized_params(torch.Generator().manual_seed(3), cfg, int4=int4)
    quant = tq.quantize_params_int4 if int4 else tq.quantize_params
    ref = quant(tl.init_params(torch.Generator().manual_seed(3), cfg))
    a, b = convert.params_to_numpy(direct), convert.params_to_numpy(ref)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert "lm_head" not in direct and tq.is_quantized(direct["embed"])


def test_convert_carries_quantized_trees_bit_for_bit():
    jtree = jq.fuse_projections(jq.init_quantized_params(jax.random.PRNGKey(0), jl.tiny(**WIDE), int4=True))
    ttree = convert.params_from_numpy(_np(jtree), tl.tiny(**WIDE), device="cpu")
    assert ttree["layers"][0]["w_qkv"]["q4"].dtype == torch.int8
    back = convert.params_to_numpy(ttree)
    jl_, jdef = jax.tree_util.tree_flatten(_np(jtree))
    tl_, tdef = jax.tree_util.tree_flatten(back)
    assert jdef == tdef
    for a, b in zip(tl_, jl_):
        np.testing.assert_array_equal(a, b)


def test_embed_lookup_and_tied_head_match_jax():
    w = _weights(4, (256, 128))
    je = jq.quantize_embed(jnp.asarray(w))
    te = {k: torch.from_numpy(np.array(v)) for k, v in je.items()}  # the same codes
    toks = np.array([[3, 1, 255, 7]], np.int32)
    np.testing.assert_array_equal(
        tq.embed_lookup(te, torch.from_numpy(toks).long(), torch.float32).numpy(),
        np.asarray(jq.embed_lookup(je, jnp.asarray(toks), jnp.float32)),
    )
    x = np.random.default_rng(5).standard_normal((1, 2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tq.tied_head_matmul(torch.from_numpy(x), te).numpy(),
        np.asarray(jq.tied_head_matmul(jnp.asarray(x), je)), rtol=1e-5, atol=1e-5,
    )


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close(t, j, rel=LOGIT_REL):
    a, b = _f32(j), _f32(t)
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=rel * np.abs(a).max(), rtol=0)


@pytest.fixture(scope="module")
def trees():
    """JAX trees (int8 and int4, fused and unfused) and their ports."""
    out = {}
    for int4 in (False, True):
        base = jq.init_quantized_params(jax.random.PRNGKey(0), jl.tiny(**WIDE), int4=int4)
        for fused in (False, True):
            jtree = jq.fuse_projections(base) if fused else base
            out[int4, fused] = (jtree, convert.params_from_numpy(_np(jtree), tl.tiny(**WIDE), device="cpu"))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_quantized_model_matches_jax(trees, int4, fused):
    """Forward and prefill logits, then two decode steps through each
    package's slots backend (the lean decode path on fused trees), with the
    fused tail forced on both sides."""
    jtree, ttree = trees[int4, fused]
    jcfg, tcfg = jl.tiny(**WIDE, attention_impl="bf16"), tl.tiny(**WIDE, attention_impl="bf16")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 24)).astype(np.int32)
    last = np.array([23, 11], np.int32)
    with jconfig.patch({"kernel.qmlp": "force"}), config.patch({"kernel.qmlp": "force"}):
        _close(tl.forward(ttree, torch.from_numpy(toks[:, :8]).long(), tcfg),
               jl.forward(jtree, jnp.asarray(toks[:, :8]), jcfg))
        jb = JSlots(jcfg, num_slots=2, max_len=64, cache_dtype=jnp.int8)
        tb = TSlots(tcfg, num_slots=2, max_len=64, cache_dtype=torch.int8, device="cpu")
        lens = [int(p) + 1 for p in last]
        jlog = jb.prefill_and_write(functools.partial(jl.forward_prefill, cfg=jcfg), jtree,
                                    jnp.asarray(toks), list(last), [0, 1], lens, 24)
        tlog = tb.prefill_and_write(functools.partial(tl.forward_prefill, cfg=tcfg), ttree,
                                    torch.from_numpy(toks).long(), list(last), [0, 1], lens, 24)
        _close(tlog, jlog)
        assert tl._lean_decode_supported(tcfg, ttree) == fused
        for cur in np.array([[7, 200], [31, 5]], np.int32):
            jlog = jb.decode(jtree, cur, np.array([True, True]), [0, 1])
            tlog = tb.decode(ttree, cur, np.array([True, True]), [0, 1])
            assert tlog.shape == (2, 256)
            _close(tlog, jlog)


def test_lean_decode_equals_generic_decode(trees, monkeypatch):
    _, ttree = trees[False, True]
    cfg = tl.tiny(**WIDE, attention_impl="bf16")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16))).long()
    logits = []
    for lean in (True, False):
        monkeypatch.setattr(tl, "_lean_decode_supported", lambda *_: lean)
        tb = TSlots(cfg, num_slots=2, max_len=64, cache_dtype=torch.int8, device="cpu")
        tb.prefill_and_write(functools.partial(tl.forward_prefill, cfg=cfg), ttree, toks,
                             [15, 9], [0, 1], [16, 10], 16)
        logits.append(tb.decode(ttree, np.array([3, 4]), np.array([True, True]), [0, 1]))
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)


def test_quantized_engine_first_tokens_match_jax(trees):
    """A tiny int8 fused engine against the JAX engine, as
    tests/test_torch_engine.py does for bf16 trees: first tokens equal,
    later ones agree on all but one (near-ties of an untrained model)."""
    jtree, ttree = trees[False, True]
    prompts = [[3, 17, 42, 99, 7], [5, 9, 23, 51], [8, 9, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]
    je = JEngine(jtree, jl.tiny(**WIDE, attention_impl="bf16"), num_slots=2, max_len=128,
                 cache_dtype=jnp.int8)
    jr = [je.submit(p, max_new_tokens=5) for p in prompts]
    je.run_to_completion()
    te = Engine(ttree, tl.tiny(**WIDE, attention_impl="bf16"), num_slots=2, max_len=128,
                cache_dtype=torch.int8)
    assert te.device == torch.device("cpu")  # from the quantized embedding's codes
    tr = [te.submit(p, max_new_tokens=5) for p in prompts]
    te.run_to_completion()
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == 5 and b.output[0] == a.output[0]
        assert sum(x == y for x, y in zip(a.output, b.output)) >= 4, (a.output, b.output)
    assert te.stats == {k: je.stats[k] for k in te.stats}


def test_int4_engine_serves_with_fused_tail_forced(trees):
    _, ttree = trees[True, True]
    cfg = tl.tiny(**WIDE)
    with config.patch({"kernel.qmlp": "force", "kernel.qmm": "force"}):
        eng = Engine(ttree, cfg, num_slots=2, max_len=64, cache_dtype=torch.bfloat16)
        reqs = [eng.submit([3, 1, 4, 1, 5], max_new_tokens=4), eng.submit([2, 7], max_new_tokens=4)]
        eng.run_to_completion()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
