"""K9 (ops/megastep.fused_decode_layer) and the fused decode step against
the JAX package, at the JAX suite's shapes (tests/test_megastep.py: E 256,
I 256, Hq 4, Hkv 2, D 128, 2 layers, 16 slots).

The JAX kernel runs as its own tests run it, in interpret mode under
``kernel.megastep = kernel.qmlp = "force"``; the port runs the kernel's
plain version (CPU tensors).  Weights come from the JAX quantized fused
tree, carried across bit for bit with ``models/convert``; activations and
cache contents come from numpy with a seed, and both packages get the same
values.

Bounds, as RMSE / std of the JAX result:
- one K9 layer, the same inputs in both: 5e-3.  The attention's head
  output rounds at the same points in both (at 128 rows it equals the JAX
  kernel's bit for bit); the layer's bf16 result then goes through K8's
  plain tail, whose fp32 sums in other orders than the JAX tail's flip
  single bf16 ulps of about half the outputs (measured 3.1e-3 to 3.7e-3;
  tests/test_torch_qmlp.py holds that tail to 1e-2).  An error of the
  attention or of the wo fold is of order 1.
- the decode step, fused against the port's unfused step (lean decode,
  K4's and K8's plain versions): equal logits and cache state, bit for
  bit.  Both plain versions round the unnormalized P at the same point,
  take the one-shot softmax in the same order, and share K8's plain tail.
- the decode step against JAX's fused step: logits within 2e-2, twice the
  JAX suite's 1e-2 (tests/test_megastep.py:97-130).  The port's K8 plain
  tail flips the bf16 ulps above, so the port sits 0.89e-2 to 0.96e-2
  from JAX on these cases, fused and unfused alike (JAX's own two routes
  sit 2.3e-3 to 3.2e-3 apart); a wrong layer is off by order 1.  The
  cache state: equal lengths; layer 0's written rows equal bit for bit
  (the JAX suite allows codes within 1); later layers' codes within 3, as
  in the JAX suite, and scales within 2e-2.  Their rows come from the
  previous layer's output, whose bf16 flips move up to 17% of the int8
  codes by 1 or 2 and the scales by up to 1.2%; a row written to the
  wrong place is off by up to 254.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu import config as jconfig
from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu.ops import megastep as jmega
from quantumattention_tpu.ops import quant as jquant
from quantumattention_tpu.serving import kv_cache as jkvc
from quantumattention_tpu.serving.backends import SlotsBackend as JSlots
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops import megastep
from quantumattention_tpu_torch.serving import kv_cache as kvc
from quantumattention_tpu_torch.serving.backends import SlotsBackend

import jax

SHAPES = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_layers=2,
              num_q_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10000.0)
LAYER_BAR = 5e-3
STEP_BAR = 2e-2
SLOTS = 16
FORCE = {"kernel.megastep": "force", "kernel.qmlp": "force"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """(JAX fused int8 tree, the port's copy, JAX config, port config)."""
    jcfg, tcfg = jl.LlamaConfig(**SHAPES), tl.LlamaConfig(**SHAPES)
    jtree = jq.fuse_projections(jq.init_quantized_params(jax.random.PRNGKey(0), jcfg))
    return jtree, convert.params_from_numpy(_np(jtree), tcfg, device="cpu"), jcfg, tcfg


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _rel(got, want):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.sqrt(np.mean((g - w) ** 2)) / max(float(np.std(w)), 1e-6))


def _cache_values(seed, n_layers, s_max):
    """Per layer (k, k_scale, v, v_scale): token-wise int8 from the JAX
    quantizer, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (SLOTS, SHAPES["num_kv_heads"], s_max, SHAPES["head_dim"])
    out = []
    for _ in range(n_layers):
        kq, ks = jquant.dynamically_quantize_int8(
            jnp.asarray(rng.standard_normal(shape, dtype=np.float32)), reduction_dim=-1)
        vq, vs = jquant.dynamically_quantize_int8(
            jnp.asarray(rng.standard_normal(shape, dtype=np.float32)), reduction_dim=-1)
        out.append(tuple(np.asarray(a) for a in (kq, ks, vq, vs)))
    return out


# ---------------------------------------------------------------------------
# K9 alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_max,fold,window", [
    (128, False, None),   # one JAX cache block, last layer (no next QKV)
    (128, True, None),    # with the next layer's QKV
    (512, True, None),    # two JAX cache blocks of 256 rows
    (128, True, 40),      # a sliding window on the column mask
])
def test_fused_decode_layer_plain_matches_jax(trees, s_max, fold, window):
    jtree, ttree, _, _ = trees
    rng = np.random.default_rng(s_max + 7 * fold)
    e, hq, hkv, d = 256, 4, 2, 128
    positions = np.array([0, 5, 37, s_max - 1, s_max - 2, 1, 90, 64] + [9] * 8, np.int32)
    active = np.ones(SLOTS, bool)
    active[0] = False  # a slot of length 0 (zero output rows)
    x = jnp.asarray(rng.standard_normal((SLOTS, e), dtype=np.float32)).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((SLOTS, hq, d), dtype=np.float32)).astype(jnp.bfloat16)
    kq, ks, vq, vs = _cache_values(s_max, 1, s_max)[0]
    bkv = jmega._pick_bkv(s_max, SLOTS, d, hkv)
    wl = None if window is None else window - 1
    jctx = jmega.build_decode_ctx(jnp.asarray(positions), jnp.asarray(active), s_max, bkv,
                                  window_left=wl)
    nxt = jtree["layers"][1]
    kw = dict(next_attn_norm=nxt["attn_norm"], next_w_qkv=nxt["w_qkv"]) if fold else {}
    with jconfig.patch(FORCE):
        want = jmega.fused_decode_layer(
            x, q, jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs), jctx,
            jtree["layers"][0], eps=1e-5, **kw)
    tctx = megastep.build_decode_ctx(torch.from_numpy(positions), torch.from_numpy(active), s_max,
                                     window_left=wl)
    tnxt = ttree["layers"][1]
    tkw = dict(next_attn_norm=tnxt["attn_norm"], next_w_qkv=tnxt["w_qkv"]) if fold else {}
    before = megastep.fused_decode_layer.launches
    got = megastep.fused_decode_layer(
        _t(x), _t(q), _t(kq), _t(vq), _t(ks), _t(vs), tctx, ttree["layers"][0], eps=1e-5, **tkw)
    assert megastep.fused_decode_layer.launches == before  # the plain version launches nothing
    assert _rel(got[0], want[0]) < LAYER_BAR
    if fold:
        assert got[1].shape == (SLOTS, 1024) and _rel(got[1], want[1]) < LAYER_BAR
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("window_left", [None, 7])
def test_decode_masks_rebuild_the_jax_context(window_left):
    positions = np.array([0, 3, 31, 30, 8, 0] + [1] * 10, np.int32)
    active = np.array([1, 1, 1, 0, 1, 0] + [1] * 10, bool)
    jctx = jmega.build_decode_ctx(jnp.asarray(positions), jnp.asarray(active), 32, 32,
                                  window_left=window_left)
    tctx = megastep.build_decode_ctx(torch.from_numpy(positions), torch.from_numpy(active), 32,
                                     window_left=window_left)
    cmask, auxz = megastep.decode_masks(tctx)
    np.testing.assert_array_equal(cmask.numpy(), np.asarray(jctx["cmask"]))
    np.testing.assert_array_equal(auxz.numpy(), np.asarray(jctx["auxz"])[:, 0])
    np.testing.assert_array_equal(tctx["lengths"].numpy(), positions + active)


def test_fused_decode_layer_refuses_what_it_does_not_take(trees):
    _, ttree, _, _ = trees
    x = torch.zeros((SLOTS, 256), dtype=torch.bfloat16)
    q = torch.zeros((SLOTS, 4, 128), dtype=torch.bfloat16)
    cache = kvc.init_cache(SLOTS, 2, 64, 128, device="cpu")
    ctx = megastep.build_decode_ctx(cache.lengths, torch.ones(SLOTS, dtype=torch.bool), 64)
    args = (x, q, cache.k, cache.v, cache.k_scale, cache.v_scale, ctx, ttree["layers"][0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        megastep.fused_decode_layer(*args, side={"k": cache.k}, eps=1e-5)
    with pytest.raises(ValueError, match="together"):
        megastep.fused_decode_layer(*args, next_attn_norm=torch.ones(256), eps=1e-5)
    with pytest.raises(ValueError, match="scales"):
        megastep.fused_decode_layer(*args[:4], cache.k_scale[:, :, :8], *args[5:], eps=1e-5)
    x_out, qkv = megastep.fused_decode_layer(*args, eps=1e-5)
    assert qkv is None and x_out.shape == x.shape and torch.isfinite(x_out.float()).all()


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def _port_cfg(tcfg, **kw):
    """The port's config fields with overrides, as a plain namespace (the
    gate reads fields only)."""
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    fields.update(kw)
    return types.SimpleNamespace(**fields, q_dim=fields["num_q_heads"] * fields["head_dim"])


def _gate_case(trees, *, batch=SLOTS, max_len=128, cache_dtype="int8", fused=True,
               side_tokens=0, **cfg_kw):
    """(JAX decision, port decision) for one configuration."""
    jtree, ttree, jcfg, tcfg = trees
    jcfg = dataclasses.replace(jcfg, **cfg_kw)
    tc = _port_cfg(tcfg, **cfg_kw)
    hkv = cfg_kw.get("num_kv_heads", SHAPES["num_kv_heads"])
    jdt, tdt = (jnp.int8, torch.int8) if cache_dtype == "int8" else (jnp.bfloat16, torch.bfloat16)
    jcache = jkvc.init_cache(batch, hkv, max_len, 128, jdt)
    tcache = kvc.init_cache(batch, hkv, max_len, 128, tdt, device="cpu")
    if fused and "num_q_heads" not in cfg_kw:
        jp, tp = jtree, ttree
    else:
        base = jq.init_quantized_params(jax.random.PRNGKey(0), jcfg)
        jp = jq.fuse_projections(base) if fused else base
        tp = convert.params_from_numpy(_np(jp), tl.LlamaConfig(**{**SHAPES, **cfg_kw}), device="cpu")
    with jconfig.patch({"kernel.megastep": "force"}), config.patch({"kernel.megastep": "force"}):
        return (bool(jmega.megastep_supported(jcfg, jp, jcache, batch, side_tokens=side_tokens)),
                bool(megastep.megastep_supported(tc, tp, tcache, batch, side_tokens=side_tokens)))


@pytest.mark.parametrize("case,want", [
    (dict(), True),
    (dict(window=32), True),                     # the window rides the column mask
    (dict(window=32, side_tokens=64), False),    # a burst side buffer past the window
    (dict(cache_dtype="bf16"), False),           # no cache scales
    (dict(fused=False), False),                  # unfused tree
    (dict(batch=12), False),                     # batch not a multiple of 16
    (dict(batch=272), False),                    # more than 256 slots
    (dict(qkv_bias=True), False),
    (dict(head_dim=64), False),
], ids=["base", "window", "window_side", "bf16_cache", "unfused", "batch12", "batch272",
        "qkv_bias", "head_dim64"])
def test_gate_matches_jax(trees, case, want):
    assert _gate_case(trees, **case) == (want, want)


def test_gate_cases_where_the_port_differs(trees):
    """Dropping the Mosaic VMEM terms changes two decisions, each on
    purpose: a max_len that no Mosaic cache block divides (JAX's
    ``_pick_bkv`` finds none) routes to K9, whose 64-row tiles mask the
    ragged edge; a group of 16 query heads per KV head does not, since
    K9's group output tile must share shared memory with its cache and wo
    rings (``megastep.MAX_GROUP``)."""
    assert _gate_case(trees, max_len=200) == (False, True)
    assert _gate_case(trees, num_q_heads=16, num_kv_heads=1) == (True, False)


def test_gate_routes_by_flag_and_device(trees):
    _, ttree, _, tcfg = trees
    cache = kvc.init_cache(SLOTS, 2, 128, 128, device="cpu")
    assert not megastep.megastep_supported(tcfg, ttree, cache, SLOTS)  # True: CUDA caches only
    with config.patch({"kernel.megastep": False}):
        assert not megastep.megastep_supported(tcfg, ttree, cache, SLOTS)
    with config.patch({"kernel.megastep": "force"}):
        assert megastep.megastep_supported(tcfg, ttree, cache, SLOTS)
        assert not megastep.megastep_supported(tcfg, ttree, cache, SLOTS, mesh=object())


# ---------------------------------------------------------------------------
# The fused decode step
# ---------------------------------------------------------------------------


def _fill(backend, values, lengths):
    """The same cache state in a JAX or a port backend."""
    if isinstance(backend, JSlots):
        backend.caches = [
            dataclasses.replace(c, k=jnp.asarray(kq), v=jnp.asarray(vq), k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs), lengths=jnp.asarray(lengths, jnp.int32))
            for c, (kq, ks, vq, vs) in zip(backend.caches, values)
        ]
        return
    for c, (kq, ks, vq, vs) in zip(backend.caches, values):
        for dst, src in ((c.k, kq), (c.k_scale, ks), (c.v, vq), (c.v_scale, vs)):
            dst.copy_(torch.from_numpy(src))
        c.lengths.copy_(torch.as_tensor(lengths, dtype=torch.int32))


def _port_step(ttree, tcfg, max_len, values, lengths, tokens, active, flag):
    be = SlotsBackend(tcfg, num_slots=SLOTS, max_len=max_len, device="cpu")
    _fill(be, values, lengths)
    with config.patch({"kernel.megastep": flag, "kernel.qmlp": "force"}):
        assert be.route(ttree) == ("mega" if flag else "unfused")
        logits = be.decode(ttree, tokens, active)
    return be.caches, logits


def _cache_stats(ref, got):
    """Per layer (max code difference, share of codes off, max relative
    scale difference) over the valid rows; the lengths must be equal."""
    out = []
    for cr, cm in zip(ref, got):
        lengths = np.asarray(cr.lengths)
        np.testing.assert_array_equal(lengths, np.asarray(cm.lengths))
        worst, flips, total, srel = 0, 0, 0, 0.0
        for b in range(SLOTS):
            n = int(lengths[b])
            for a, c in ((cr.k, cm.k), (cr.v, cm.v)):
                diff = np.abs(np.asarray(a[b, :, :n]).astype(np.int32)
                              - np.asarray(c[b, :, :n]).astype(np.int32))
                worst = max(worst, int(diff.max(initial=0)))
                flips += int((diff != 0).sum())
                total += diff.size
            for a, c in ((cr.k_scale, cm.k_scale), (cr.v_scale, cm.v_scale)):
                sa, sc = np.asarray(a[b, :, :n]), np.asarray(c[b, :, :n])
                srel = max(srel, float(np.max(np.abs(sa - sc) / sa, initial=0.0)))
        out.append((worst, flips / max(total, 1), srel))
    return out


@pytest.mark.parametrize("max_len,lengths,active", [
    # one cache block, ragged lengths, inactive and empty slots
    (128, [5, 37, 127, 0, 17, 90, 1, 33] + [9] * 8, [1, 1, 0, 1, 1, 1, 0, 1] + [1] * 8),
    # all-empty first step
    (128, [0] * 16, [1] * 16),
    # a long cache: many rows far below the longest slot
    (2048, [1500, 5, 0, 1023, 1024, 1025, 40, 7] + [64] * 8, [1] * 6 + [0, 1] + [1] * 8),
], ids=["ragged", "empty", "long"])
def test_mega_step_matches_unfused_and_jax(trees, max_len, lengths, active):
    jtree, ttree, jcfg, tcfg = trees
    values = _cache_values(max_len, 2, max_len)
    tokens = np.arange(SLOTS, dtype=np.int32) % 256
    active = np.asarray(active, bool)

    caches_ref, logits_ref = _port_step(ttree, tcfg, max_len, values, lengths, tokens, active, False)
    caches_mega, logits_mega = _port_step(ttree, tcfg, max_len, values, lengths, tokens, active, "force")
    jbe = JSlots(jcfg, num_slots=SLOTS, max_len=max_len, cache_dtype=jnp.int8)
    _fill(jbe, values, lengths)
    with jconfig.patch(FORCE):
        jcaches, jlogits = jbe._decode_step_impl(jtree, jbe.caches, jnp.asarray(tokens),
                                                 jnp.asarray(active))

    assert torch.equal(logits_mega, logits_ref)
    for cr, cm in zip(caches_ref, caches_mega):
        for name in ("k", "v", "k_scale", "v_scale", "lengths"):
            assert torch.equal(getattr(cr, name), getattr(cm, name)), name
    assert _rel(logits_mega, jlogits) < STEP_BAR
    (codes0, share0, scale0), *later = _cache_stats(jcaches, caches_mega)
    assert codes0 == 0 and share0 == 0.0 and scale0 == 0.0  # layer 0: the same inputs
    for codes, _, scale in later:
        assert codes <= 3 and scale < 2e-2
