"""Ring attention (``parallel/ring.py``) against the JAX package's
(tests/test_parallel.py), on four gloo CPU ranks.

One world of four ranks (``tests/torch_dist_worker.py``) runs every case
of this file once, started with the module's first test; the JAX side
runs here, on the 8-device CPU mesh of tests/conftest.py, while the ranks
work.  The parity tests of the parallel layer are split over three files
(this one, ``test_torch_parallel_quantized.py``,
``test_torch_parallel_mesh.py``) so that each stays short; their inputs
and bars are in ``tests/torch_parallel_common.py``.

JAX's ``test_ring_attention_natural_exp_domain`` has no twin: the port's
K1 has no natural-exp mode (``config.kernel.use_exp2``), so its ring
merges in base 2 only.  JAX's sp=8 ring test runs here at sp=4, with the
launches counted instead (rank r runs r + 1 of its 4 shards, causal).
"""

import jax
import jax.numpy as jnp
import pytest

from quantumattention_tpu.ops.sdpa import sdpa_reference
from quantumattention_tpu.parallel import mesh as jmesh
from quantumattention_tpu.parallel.ring import ring_attention as jring
from torch_dist_worker import World
from torch_parallel_common import RMSE_TOL, check, gathered, qkv, qkv_inputs, rmse


def inputs():
    out = {name: qkv_inputs(name) for name in (
        "ring_noncausal", "ring_causal", "ring_gqa_window", "ring_vs_ulysses", "ring_causal_skip",
        "ring_bad_scale_rank")}
    local = qkv_inputs("ring_local_inputs")
    out["ring_local_inputs"] = {  # each rank is handed its own shards only
        f"{n}{r}": t.chunk(4, dim=2)[r].clone() for n, t in local.items() for r in range(4)}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("ring_world"), inputs())
    yield w
    w.close()


@pytest.fixture(scope="module")
def sp_mesh():
    return jmesh.make_mesh((4,), ("sp",))


@pytest.mark.parametrize("is_causal", [False, True])
def test_ring_attention_vs_oracle(world, sp_mesh, is_causal):
    name = "ring_causal" if is_causal else "ring_noncausal"
    q, k, v = map(jnp.asarray, qkv(name))
    want = jring(q, k, v, mesh=sp_mesh, is_causal=is_causal, block_q=128, block_kv=128)
    check(gathered(world.case(name), 2), want, sdpa_reference(q, k, v, is_causal=is_causal))


def test_ring_attention_gqa_window(world, sp_mesh):
    """Rows that see no key of a shard (the window's left edge) merge with
    weight zero: no NaN, and the oracle's result."""
    q, k, v = map(jnp.asarray, qkv("ring_gqa_window"))
    want = jring(q, k, v, mesh=sp_mesh, is_causal=True, window=(192, 0), block_q=128, block_kv=128)
    ref = sdpa_reference(q, k, v, is_causal=True, window=(192, None))
    check(gathered(world.case("ring_gqa_window"), 2), want, ref)


def test_ring_attention_local_inputs(world, sp_mesh):
    """The twin of JAX's jit test with sharded inputs: each rank is handed
    only its own shards and never sees the whole arrays."""
    q, k, v = map(jnp.asarray, qkv("ring_local_inputs"))
    spec = jax.sharding.NamedSharding(sp_mesh, jax.sharding.PartitionSpec(None, None, "sp", None))
    fn = jax.jit(lambda q, k, v: jring(q, k, v, mesh=sp_mesh, is_causal=True))
    want = fn(*(jax.device_put(t, spec) for t in (q, k, v)))
    check(gathered(world.case("ring_local_inputs"), 2), want, sdpa_reference(q, k, v, is_causal=True))


def test_ring_matches_ulysses(world):
    res = world.case("ring_vs_ulysses")
    r, u = gathered(res, 2, "ring"), gathered(res, 2, "ulysses")
    assert rmse(r, u) < 2e-3
    q, k, v = map(jnp.asarray, qkv("ring_vs_ulysses"))
    assert rmse(r, sdpa_reference(q, k, v, is_causal=True)) < RMSE_TOL


def test_ring_rejects_bad_scale_rank(world):
    for res in world.case("ring_bad_scale_rank"):
        assert "rank" in res["error"] and "ValueError" in res["error"]


def test_ring_causal_skips_above_diagonal(world):
    """Causal ring: rank r launches K1 on the r + 1 shards at or below its
    diagonal only; the result still matches the oracle."""
    res = world.case("ring_causal_skip")
    assert [int(r["calls"]) for r in res] == [1, 2, 3, 4]
    q, k, v = map(jnp.asarray, qkv("ring_causal_skip"))
    assert rmse(gathered(res, 2), sdpa_reference(q, k, v, is_causal=True)) < RMSE_TOL
