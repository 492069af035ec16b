"""The tail product's persistent schedule (ops/qmlp.tail_schedule), on the CPU.

K8's and K9's products run as (128-column tile, 128-row k-block) units
shared by one or two CTAs per SM in a fixed order (csrc/tail.cu).  The kernels
compute the same closed form as the Python function; these tests hold the
Python function to what the kernels rely on: every unit covered once,
shares within one unit of each other, every tile's partial sums added in
k order from distinct slots, and int4's 256-row packing blocks never split
by a unit.  The card tests hold the card's schedule to this one.
"""

import numpy as np
import pytest

from quantumattention_tpu_torch.ops import qmlp

#: (E, I, Q, F) of Llama-3-8B, Phi-3-mini (microsoft/Phi-3-mini-4k-instruct
#: config.json) and the narrow test shape of tests/test_torch_cuda.py.
MODELS = {
    "llama3_8b": (4096, 14336, 4096, 6144),
    "phi3_mini": (3072, 8192, 3072, 9216),
    "narrow": (256, 512, 256, 384),
}
ROWS = [1, 8, 9, 64, 65, 256]


def _products(model):
    """(N, K) of the tail's four products: wo, w_gate_up, w_down, w_qkv."""
    e, i, q, f = MODELS[model]
    return {"wo": (e, q), "w_gate_up": (2 * i, e), "w_down": (e, i), "w_qkv": (f, e)}


def _cases():
    return [(model, name, m) for model in MODELS for name in _products(model) for m in ROWS]


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("model,name,m", _cases())
def test_every_unit_once_and_balanced(model, name, m, sms):
    n, k = _products(model)[name]
    s = qmlp.tail_schedule(m, n, k, sms)
    assert s.width >= m and s.width in (8, 16, 32, 64, 128, 256)
    assert s.ctas == min(qmlp.tail_ctas_per_sm(s.width) * sms, s.units)
    assert s.tiles * 128 == n and s.kblocks * 128 == k
    seen = np.zeros((s.tiles, s.kblocks), np.int32)
    shares = []
    for c in range(s.ctas):
        u0, u1 = s.cta_units(c)
        shares.append(u1 - u0)
        for u in range(u0, u1):
            seen[u // s.kblocks, u % s.kblocks] += 1
    assert (seen == 1).all()
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    assert s.cta_units(s.ctas - 1)[1] == s.units


@pytest.mark.parametrize("model,name,m", _cases())
def test_reduction_order_is_fixed(model, name, m):
    """Each tile's segments cover its k-blocks in order, one (CTA, tile)
    pair a slot, every slot inside the workspace; the order the reductions
    add them is the CTAs' order, whatever the rows."""
    n, k = _products(model)[name]
    s = qmlp.tail_schedule(m, n, k)
    segs = s.segments()
    slots = [seg[4] for seg in segs]
    assert len(set(slots)) == len(slots) and max(slots) < s.ctas + s.tiles
    assert s.partial_floats(m) == (s.ctas + s.tiles) * m * 128
    for t in range(s.tiles):
        mine = [seg for seg in segs if seg[1] == t]
        assert [seg[4] for seg in mine] == s.tile_slots(t)
        assert [seg[0] for seg in mine] == sorted(seg[0] for seg in mine)
        bounds = [(kb0, kb1) for _, _, kb0, kb1, _ in mine]
        assert bounds[0][0] == 0 and bounds[-1][1] == s.kblocks
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # Rows move only the width and, through it, the CTAs an SM.
    other = qmlp.tail_schedule(m + 1 if m < 256 else m - 1, n, k)
    if qmlp.tail_ctas_per_sm(other.width) == qmlp.tail_ctas_per_sm(s.width):
        assert other._replace(width=s.width) == s


@pytest.mark.parametrize("m", [1, 9, 65])
@pytest.mark.parametrize("sms", [132, 5])
def test_segment_sums_give_the_product(m, sms):
    """Summing each tile's segment products in slot order gives x @ w (the
    reduction the kernels run, in float64 on a narrow shape)."""
    n, k = 384, 1024
    rng = np.random.default_rng(m + sms)
    x, w = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    s = qmlp.tail_schedule(m, n, k, sms)
    partial = {}
    for _, t, kb0, kb1, slot in s.segments():
        rows = slice(128 * kb0, 128 * kb1)
        partial[slot] = x[:, rows] @ w[rows, 128 * t: 128 * (t + 1)]
    out = np.concatenate(
        [sum(partial[slot] for slot in s.tile_slots(t)) for t in range(s.tiles)], axis=1)
    np.testing.assert_allclose(out, x @ w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("k", [256, 1024, 4096, 14336])
def test_int4_units_never_straddle_a_packing_block(k):
    """An int4 unit kb stages packed rows [64 kb, 64 kb + 64), whose low
    nibbles are rows [256g + 64j, +64) and high nibbles [256g + 128 + 64j,
    +64), g = kb // 2, j = kb % 2 (the kernel's TMA coordinates): both in
    the packing block g, and every row of K exactly once."""
    s = qmlp.tail_schedule(4, 128, k)
    covered = np.zeros(k, np.int32)
    for kb in range(s.kblocks):
        packed, (lo, hi) = qmlp.tail_unit_rows(kb, int4=True)
        assert packed.start // 128 == (packed.stop - 1) // 128 == kb // 2
        for rows in (lo, hi):
            assert rows.start // 256 == (rows.stop - 1) // 256 == packed.start // 128
            covered[rows] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("k", [128, 4096])
def test_int8_units_are_contiguous_rows(k):
    s = qmlp.tail_schedule(4, 128, k)
    covered = np.zeros(k, np.int32)
    for kb in range(s.kblocks):
        packed, (lo, hi) = qmlp.tail_unit_rows(kb, int4=False)
        assert packed == range(128 * kb, 128 * kb + 128)
        assert lo.stop == hi.start and lo.start == 128 * kb and hi.stop == 128 * kb + 128
        covered[lo] += 1
        covered[hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m,width", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (33, 64),
                                     (64, 64), (65, 128), (129, 256), (256, 256)])
def test_width_rounds_rows_up(m, width):
    assert qmlp.tail_width(m) == width


def test_width_refuses_rows_past_the_tail():
    with pytest.raises(ValueError, match="1..256 rows"):
        qmlp.tail_width(257)
    with pytest.raises(ValueError, match="% 128"):
        qmlp.tail_schedule(4, 100, 128)
