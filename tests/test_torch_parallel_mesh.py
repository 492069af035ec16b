"""Head-parallel and Ulysses attention, pod meshes, the pipeline, expert
parallelism and the two-process bootstrap against the JAX package's
(tests/test_parallel.py, and the expert-parallel tests of
tests/test_moe.py:126-151), on four gloo CPU ranks; see
``test_torch_parallel.py`` for how the world runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from quantumattention_tpu.models import moe as jmoe
from quantumattention_tpu.ops.sdpa import sdpa_reference
from quantumattention_tpu.parallel import mesh as jmesh
from quantumattention_tpu.parallel.tp import head_parallel_attention as jhead
from quantumattention_tpu.parallel.ulysses import ulysses_attention as julysses
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import moe as tmoe
from quantumattention_tpu_torch.models import quantized as tquantized
from torch_dist_worker import World
from torch_parallel_common import (
    RMSE_TOL, check, expert_inputs, gathered, moe_inputs, pipeline_attention_inputs, pipeline_inputs,
    qkv, qkv_inputs, rmse, to_torch,
)


def inputs():
    out = {name: qkv_inputs(name) for name in ("head_parallel", "head_parallel_indivisible", "ulysses",
                                               "ulysses_indivisible")}
    out["pod_mesh"] = {}
    out["pipeline_sequential"] = {k: to_torch(v) for k, v in pipeline_inputs().items()}
    out["pipeline_attention"] = {k: to_torch(v) for k, v in pipeline_attention_inputs().items()}
    out["expert_parallel"] = {k: to_torch(v) for k, v in expert_inputs().items()}
    out["expert_parallel_int8"] = {k: to_torch(v) for k, v in expert_inputs(128, 256).items()}
    out["expert_parallel_bad_shapes"] = {**{k: to_torch(v) for k, v in moe_inputs(9, 6).items()},
                                         **{k + "8": to_torch(v) for k, v in moe_inputs(9, 8).items()}}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("mesh_world"), inputs())
    yield w
    w.close()


@pytest.fixture(scope="module")
def sp_mesh():
    return jmesh.make_mesh((4,), ("sp",))


@pytest.fixture(scope="module")
def tp_mesh():
    return jmesh.make_mesh((4,), ("tp",))


@pytest.fixture(scope="module")
def tp_mesh():
    return jmesh.make_mesh((4,), ("tp",))

def test_head_parallel_vs_oracle(world, tp_mesh):
    q, k, v = map(jnp.asarray, qkv("head_parallel"))
    want = jhead(q, k, v, mesh=tp_mesh, is_causal=True, block_q=128, block_kv=128)
    check(gathered(world.case("head_parallel"), 1), want, sdpa_reference(q, k, v, is_causal=True))


def test_head_parallel_rejects_indivisible(world):
    for res in world.case("head_parallel_indivisible"):
        assert "divisible" in res["error"] and "ValueError" in res["error"]


def test_ulysses_attention_vs_oracle(world, sp_mesh):
    q, k, v = map(jnp.asarray, qkv("ulysses"))
    want = julysses(q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128)
    check(gathered(world.case("ulysses"), 2), want, sdpa_reference(q, k, v, is_causal=True))


def test_ulysses_rejects_indivisible_heads(world):
    for res in world.case("ulysses_indivisible"):
        assert "divisible" in res["error"] and "ValueError" in res["error"]


def test_pod_mesh_and_local_batch(world):
    """dp x sp x tp over the four ranks (tp absorbs the rest: 1); the
    single-process call of initialize_distributed is a no-op (checked in
    test_multihost_two_process_ring)."""
    for res in world.case("pod_mesh"):
        assert res["sizes"].tolist() == [2, 2, 1]
        assert int(res["local"]) == 8
        assert all("divisible" in e for e in res["errors"])


def test_pipeline_parallel_matches_sequential(world):
    """GPipe over 4 stages equals the stages applied in sequence (JAX)."""
    p = pipeline_inputs()
    ref = jnp.asarray(p["x"])
    for s in range(4):
        ref = jnp.tanh(ref @ p["w"][s] + p["b"][s])
    for res in world.case("pipeline_sequential"):  # replicated on every rank
        assert res["out"].shape == p["x"].shape
        np.testing.assert_allclose(res["out"].numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_pipeline_parallel_attention_stage(world):
    """Two stages of an attention block (K1's plain version) on the pp axis
    of a dp x pp mesh, against JAX's attention applied in sequence."""
    import quantumattention_tpu as qa

    p = pipeline_attention_inputs()
    heads, s, d = 2, 128, 64

    def stage_fn(wo, a):
        b = a.shape[0]
        qkv_ = a.reshape(b, s, heads, d).transpose(0, 2, 1, 3).astype(jnp.bfloat16)
        att = qa.attn_func(qkv_, qkv_, qkv_, is_causal=True)
        return a + att.transpose(0, 2, 1, 3).reshape(b, s, heads * d).astype(jnp.float32) @ wo

    ref = jnp.asarray(p["x"])
    for st in range(2):
        ref = stage_fn(p["wo"][st], ref.reshape(-1, s, heads * d)).reshape(p["x"].shape)
    for res in world.case("pipeline_attention"):
        assert rmse(res["out"].numpy(), ref) < 1e-2


def test_multihost_two_process_ring(tmp_path):
    """Two processes join through ``initialize_distributed`` (WORLD_SIZE
    and RANK from the environment, a file store), build the pod mesh with
    sp across both, and run ring attention across the process boundary;
    a one-process call is a no-op."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 256, 64), dtype=np.float32) for _ in range(3))
    w = World(2, tmp_path, {"ring_across_processes": dict(zip("qkv", map(to_torch, (q, k, v))))},
              timeout_s=120.0, init="env")
    try:
        res = w.case("ring_across_processes")
    finally:
        w.close()
    assert all("backend gloo" in log for log in w.logs)
    assert all(bool(r["single"]) for r in res)
    ref = sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True)
    assert rmse(gathered(res, 2), ref) < RMSE_TOL


def test_expert_parallel_matches_single_device(world):
    """EP over 4 ranks == the unsharded layer when nothing drops."""
    p = expert_inputs()
    ref = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items() if k != "x"}, jnp.asarray(p["x"]),
                       num_experts_per_tok=2, capacity_factor=4.0)
    np.testing.assert_allclose(gathered(world.case("expert_parallel"), 0), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_expert_parallel_int8_experts(world):
    """int8 expert stacks sliced to 2 a rank run through K5/K6's wrapper,
    one call an expert product (3 products x 2 local experts), and equal
    the single-device int8 layer."""
    p = expert_inputs(128, 256)
    moe = {"w_router": to_torch(p["w_router"]),
           **{k: tquantized.quantize_matrix(to_torch(p[k])) for k in ("w_gate", "w_up", "w_down")}}
    with config.patch({"kernel.qmm": "force"}):
        ref = tmoe.moe_ffn(moe, to_torch(p["x"]), num_experts_per_tok=2, capacity_factor=4.0)
    res = world.case("expert_parallel_int8")
    assert all(int(r["local_experts"]) == 2 and int(r["k5_calls"]) == 6 for r in res)
    np.testing.assert_allclose(gathered(res, 0), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_expert_parallel_rejects_bad_shapes(world):
    for res in world.case("expert_parallel_bad_shapes"):
        assert "num_experts" in res["experts"] and "ValueError" in res["experts"]
        assert "batch" in res["batch"] and "ValueError" in res["batch"]
