"""Tensor-parallel serving (``serving/tp.py``, ``Engine(mesh=...)``) against
the JAX package's (tests/test_tp_serving.py), on four gloo CPU ranks.

One world of four ranks (``tests/torch_dist_worker.py``) runs every case
once; the JAX side runs here while they work.  Inputs and parameters are
drawn once (numpy with a seed, or JAX's ``init_params`` converted) and go
to both.  Bars, the JAX tests' own: TP decode RMSE < 1e-3 of the
single-device decode; the prefill forward's logits within 1e-4 relative,
its K/V within 1e-4 RMSE; each rank's parameter slices equal to the shard
JAX's ``NamedSharding`` places on the matching device; the engine to first
tokens and the schedule invariants, never whole token sequences (they flip
on near-ties of an untrained model).

Port-only cases: an int4 tree whose row shards keep whole packing blocks
(through K7's wrapper), its refusal where they would not, and the
refusal of a fused tree.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu.ops.decode import decode_attention
from quantumattention_tpu.ops.quant import dynamically_quantize_int8
from quantumattention_tpu.parallel import mesh as jmesh
from quantumattention_tpu.serving.engine import Engine as JEngine
from torch_dist_worker import World

JCFG = jl.tiny(attention_impl="sdpa", dtype=jnp.float32)
PROMPT = [5, 9, 23, 51, 7, 12]
LONG_PROMPT = [(3 * i) % 97 + 1 for i in range(150)]


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def flat(tree, prefix="p."):
    """A parameter tree as {"p.layers.0.wq.q": tensor, ...}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = to_torch(tree)
    return out


def decode_inputs():
    rng = np.random.default_rng(0)
    b, hq, hkv, s, d = 4, 8, 4, 256, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32).astype(ml_dtypes.bfloat16)
    kc, ks = dynamically_quantize_int8(jnp.asarray(rng.standard_normal((b, hkv, s, d), dtype=np.float32)))
    vc, vs = dynamically_quantize_int8(jnp.asarray(rng.standard_normal((b, hkv, s, d), dtype=np.float32)))
    int8 = {"q": q, "k": np.asarray(kc), "v": np.asarray(vc), "ks": np.asarray(ks), "vs": np.asarray(vs),
            "lengths": np.array([256, 100, 17, 256], np.int32)}
    rng = np.random.default_rng(1)
    bf16 = {n: rng.standard_normal(shape, dtype=np.float32).astype(ml_dtypes.bfloat16)
            for n, shape in (("q", (2, 8, 64)), ("k", (2, 4, 512, 64)), ("v", (2, 4, 512, 64)))}
    bf16["lengths"] = np.array([512, 300], np.int32)
    return int8, bf16


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def jax_qparams():
    return jq.quantize_params(jl.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params, jax_qparams):
    int8, bf16 = decode_inputs()
    tree = flat(jax.tree_util.tree_map(np.asarray, jax_params))
    inputs = {
        "tp_decode_int8": {k: to_torch(v) for k, v in int8.items()},
        "tp_decode_bf16_window": {k: to_torch(v) for k, v in bf16.items()},
        "tp_prefill": {**tree, "tokens": torch.tensor([[3, 17, 42, 99, 7, 23, 5, 1]])},
        "param_specs_quantized": flat(jax.tree_util.tree_map(np.asarray, jax_qparams)),
        "tp_decode_validation": {}, "engine_serves": tree, "engine_quantized_burst": {},
        "engine_chunked": tree, "engine_rejects": tree, "int4_tree": {},
    }
    w = World(4, tmp_path_factory.mktemp("tp_world"), inputs)
    yield w
    w.close()


@pytest.fixture(scope="module")
def mesh():
    return jmesh.make_mesh((4,), ("tp",))


def gathered(res, dim, key="out"):
    return torch.cat([r[key] for r in res], dim=dim).float().numpy()


def test_tp_decode_matches_single_device(world):
    """Head-sharded decode (K4 on each rank's heads of a cache cut by
    ``shard_cache``) == single-device decode."""
    int8, _ = decode_inputs()
    single = decode_attention(*(jnp.asarray(int8[n]) for n in ("q", "k", "v", "lengths")),
                              k_scale=jnp.asarray(int8["ks"]), v_scale=jnp.asarray(int8["vs"]))
    res = world.case("tp_decode_int8")
    assert all(int(r["cache_heads"]) == 1 for r in res)
    assert rmse(gathered(res, 1), single) < 1e-3


def test_tp_decode_bf16_and_window(world):
    _, bf16 = decode_inputs()
    single = decode_attention(*(jnp.asarray(bf16[n]) for n in ("q", "k", "v", "lengths")), window=(63, 0))
    assert rmse(gathered(world.case("tp_decode_bf16_window"), 1), single) < 1e-3


def test_tp_decode_validation(world):
    """6 query heads cannot split over 4 ranks (refused where the rank's
    heads are cut); a (B, Hq, T, D) verify query is refused by the TP
    decode."""
    for res in world.case("tp_decode_validation"):
        assert "divisible" in res["heads"] and "ValueError" in res["heads"]
        assert "single-token" in res["verify"] and "ValueError" in res["verify"]


def test_tp_prefill_forward_close(world, jax_params):
    """forward_prefill_tp's logits and K/V match the single-device
    forward_prefill (the same math; all-reduced row-split products)."""
    tokens = jnp.asarray([[3, 17, 42, 99, 7, 23, 5, 1]], jnp.int32)
    logits, kv = jax.jit(lambda p, t: jl.forward_prefill(p, t, JCFG))(jax_params, tokens)
    res = world.case("tp_prefill")
    denom = float(jnp.std(logits))
    for r in res:  # every rank holds the whole logits
        assert rmse(r["logits"].numpy(), logits) / denom < 1e-4
    for i, (k, v) in enumerate(kv):
        assert rmse(gathered(res, 1, f"k{i}"), k) < 1e-4
        assert rmse(gathered(res, 1, f"v{i}"), v) < 1e-4


def test_param_specs_for_quantized_tree(world, jax_qparams, mesh):
    """The specs of a w8a16 tree keep the scales unsharded on their size-1
    dims, and each rank's slices equal JAX's shard on the matching device."""
    specs = jmesh.param_specs_for(jax_qparams, JCFG)
    sharded = jmesh.shard_params(jax_qparams, mesh, specs)
    res = world.case("param_specs_quantized")
    want = [(None, "tp"), (None, "tp"), ("tp", None), (None, None), ("tp", None), ("tp", None)]
    leaves = {"wq": sharded["layers"][0]["wq"], "wo": sharded["layers"][0]["wo"], "embed": sharded["embed"]}
    for r, out in enumerate(res):
        assert [tuple(s) for s in out["specs"]] == want
        device = mesh.devices.flat[r]
        for name, leaf in leaves.items():
            for part in ("q", "s"):
                (shard,) = [s for s in leaf[part].addressable_shards if s.device == device]
                np.testing.assert_array_equal(out[f"{name}.{part}"].numpy(), np.asarray(shard.data))


def test_engine_tp_serves(world, jax_params):
    """The mesh engine completes the request with the single-device JAX
    engine's first token (the first token comes from prefill logits on
    both sides), and its cache holds the rank's KV heads only."""
    solo = JEngine(jax_params, JCFG, num_slots=2, max_len=256, cache_dtype=jnp.int8)
    rs = solo.submit(PROMPT, max_new_tokens=4)
    solo.run_to_completion()
    for r in world.case("engine_serves"):
        (out,), (done,) = r["outputs"], r["done"]
        assert done and len(out) == 4
        assert out[0] == rs.output[0], (out, rs.output)
        assert int(r["cache_heads"]) == JCFG.num_kv_heads // 4
    assert len({tuple(r["outputs"][0]) for r in world.case("engine_serves")}) == 1


def test_engine_tp_quantized_weights_burst(world):
    """w8a16 weights + mesh + decode bursts (a loop of steps under a mesh,
    no graph): every request completes with the tokens of the same engine
    stepping one token a call, and the first tokens are the
    single-process engine's over the same tree."""
    for r in world.case("engine_quantized_burst"):
        assert all(r["done"]) and all(len(o) == 9 for o in r["outputs"])
        assert int(r["generated"]) == 18 and int(r["bursts"]) > 0 and int(r["captures"]) == 0
        assert r["outputs"] == r["stepwise"]
        assert [o[0] for o in r["outputs"]] == r["solo_first"]


def test_engine_tp_chunked_prefill(world, jax_params):
    """Mixed prefill/decode under the mesh: the long prompt prefills in
    chunks (K1 over each rank's KV-head shard of the prefix) while the
    short stream decodes every step; first tokens match the single-device
    JAX engine's chunked run."""
    eng = JEngine(jax_params, JCFG, num_slots=2, max_len=256, cache_dtype=jnp.int8, prefill_chunk=64)
    short = eng.submit([5, 9, 23], max_new_tokens=8)
    eng.step()
    long_req = eng.submit(list(LONG_PROMPT), max_new_tokens=3)
    eng.run_to_completion()
    for r in world.case("engine_chunked"):
        (s_out, l_out), produced = r["outputs"], r["produced"]
        assert all(r["done"]) and len(l_out) == 3 and len(s_out) == 8
        assert all(b > a or b == 8 for a, b in zip(produced, produced[1:])), produced
        assert l_out[0] == long_req.output[0]
        assert s_out[0] == short.output[0]


def test_engine_tp_rejects_unsupported(world):
    for r in world.case("engine_rejects"):
        assert "slots" in r["paged"] and "ValueError" in r["paged"]
        assert "divisible" in r["heads"] and "ValueError" in r["heads"]
        assert "single-chip" in r["draft"] and "ValueError" in r["draft"]
        assert "ROADMAP" in r["block_kv"] and "NotImplementedError" in r["block_kv"]
        assert "fused projection" in r["fused"] and "ValueError" in r["fused"]


def test_int4_tree_under_mesh(world):
    """An int4 tree (row shards of whole 256-row packing blocks) serves its
    prefill through K7's wrapper on each rank's shards, within 1e-4
    relative of the single-process forward; a tree whose row shards would
    cut a packing block is refused."""
    for r in world.case("int4_tree"):
        denom = float(r["single"].std())
        assert rmse(r["logits"].numpy(), r["single"].numpy()) / denom < 1e-4
        assert int(r["k7_calls"]) > 0
        assert "packing blocks" in r["misaligned"] and "ValueError" in r["misaligned"]
