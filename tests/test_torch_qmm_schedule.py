"""The K5/K6/K7 kernel's schedule and column permutation (ops/qmm), on the CPU.

K5, K6 and K7 run on one register-A, swap-AB wgmma kernel (csrc/qgemm.cu):
up to 128 activation rows as stream-K over (128-column tile, 128-row
k-block) units with fp32 partial sums added in CTA order by the tail
product's reduction kernel, more rows as whole (256-column, 128-row) output
tiles.  Its A fragments hold the weight
columns in a permuted order that the epilogue undoes.  The kernel computes
the same closed forms as the Python functions; these tests hold the Python
functions to what the kernel relies on: every unit run exactly once,
shares within one unit of each other, partial slots unique and in CTA
order, whole tiles covered once, the permutation a bijection that the
epilogue's stores invert.  The card tests hold the card's schedule and
permutation to these.
"""

import numpy as np
import pytest
import torch

from quantumattention_tpu_torch.ops import qmm

#: (N, K) of Llama-3-8B's five projections (models/llama.llama3_8b: hidden
#: 4096, 32/8 heads of 128, intermediate 14336, vocab 128256).
LLAMA3_8B = {
    "w_qkv": (6144, 4096),
    "wo": (4096, 4096),
    "w_gate_up": (28672, 4096),
    "w_down": (4096, 14336),
    "lm_head": (128256, 4096),
}
#: Narrow and ragged shapes of the card tests (N % 256 == 128 among them).
SMALL = {"one_tile": (128, 256), "three_tiles": (384, 512), "ragged": (640, 1024), "deep": (256, 2048)}
ROWS = [1, 4, 9, 16, 17, 64, 65, 128, 129, 256, 257, 1536]


def _cases():
    shapes = {**LLAMA3_8B, **SMALL}
    return [(name, m) for name in shapes for m in ROWS], shapes


CASES, SHAPES = _cases()


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("name,m", CASES)
def test_every_unit_once_and_balanced(name, m, sms):
    n, k = SHAPES[name]
    s = qmm.qgemm_schedule(m, n, k, sms)
    assert s.kblocks * 128 == k
    if s.whole:
        assert m > 128 and s.width == 128 and s.row_tiles * 128 >= m > (s.row_tiles - 1) * 128
        assert s.col_tiles * 256 >= n > (s.col_tiles - 1) * 256
        assert s.ctas == min(sms, s.row_tiles * s.col_tiles)
    else:
        assert s.width in (8, 16, 32, 64, 128) and s.width >= m and (s.width == 8 or s.width < 2 * m)
        assert s.row_tiles == 1 and s.col_tiles * 128 == n
        assert s.ctas == min(qmm.qgemm_ctas_per_sm(s.width, False) * sms, s.col_tiles * s.kblocks)
    seen = np.zeros((s.row_tiles, s.col_tiles * (2 if s.whole else 1), s.kblocks), np.int32)
    shares = []
    for c in range(s.ctas):
        shares.append(s.cta_units(c))
        for i in range(s.cta_units(c)):
            col0, row0, kb, _ = s.unit(c, i)
            for half in range(2 if s.whole else 1):
                if col0 + 128 * half < n:
                    seen[row0 // 128, col0 // 128 + half, kb] += 1
    cols = n // 128
    assert (seen[:, :cols] == 1).all() and (seen[:, cols:] == 0).all()
    assert sum(shares) == s.units and min(shares) >= 1
    if s.whole:
        assert all(u % s.kblocks == 0 for u in shares)  # whole tiles: every k-block of a tile
        per = [u // s.kblocks for u in shares]
        assert max(per) - min(per) <= 1
    else:
        assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("name,m", [c for c in CASES if c[1] <= 128])
def test_stream_k_slots_are_unique_and_in_cta_order(name, m):
    """Each tile's segments cover its k-blocks in order, one (CTA, tile)
    pair a slot, every slot inside the workspace: the order the reduction
    adds them is the CTAs' order, whatever the rows."""
    n, k = SHAPES[name]
    s = qmm.qgemm_schedule(m, n, k)
    segs = s.segments()
    slots = [seg[4] for seg in segs]
    assert len(set(slots)) == len(slots) and max(slots) < s.ctas + s.col_tiles
    assert s.partial_floats(m) == (s.ctas + s.col_tiles) * m * 128
    for t in range(s.col_tiles):
        mine = [seg for seg in segs if seg[1] == t]
        assert [seg[0] for seg in mine] == sorted(seg[0] for seg in mine)
        assert [seg[4] for seg in mine] == sorted(seg[4] for seg in mine)
        bounds = [(kb0, kb1) for _, _, kb0, kb1, _ in mine]
        assert bounds[0][0] == 0 and bounds[-1][1] == s.kblocks
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_whole_tiles_raster_rows_first(name):
    """Above 128 rows the CTAs resident at once run the row tiles of one
    column tile together (row tiles fastest), so they share its weights
    through L2; each tile's k-blocks run in order inside one CTA."""
    n, k = SHAPES[name]
    s = qmm.qgemm_schedule(1536, n, k)
    assert s.whole and s.partial_floats(1536) == 0
    first = [s.unit(c, 0) for c in range(s.ctas)]
    assert [u[3] for u in first] == list(range(s.ctas))
    for c, (col0, row0, kb, tile) in enumerate(first):
        assert (row0, col0, kb) == ((c % s.row_tiles) * 128, (c // s.row_tiles) * 256, 0)
    for c in range(min(s.ctas, 3)):
        kbs = [s.unit(c, i)[2] for i in range(s.cta_units(c))]
        assert kbs == list(range(s.kblocks)) * (len(kbs) // s.kblocks)


def test_column_permutation_is_a_bijection_the_epilogue_inverts():
    perm = [qmm.qgemm_column(mt, r) for mt in range(2) for r in range(64)]
    assert sorted(perm) == list(range(128))
    for warp in range(4):
        for g in range(8):
            # The epilogue (csrc/qgemm.cu, finish) stores thread (warp, lane
            # 4g + t)'s sums of (tile mt, row half h) -- accumulator rows 16
            # warp + g + 8h -- at columns 4 (8 warp + g) + 2 mt + h.
            q = 8 * warp + g
            held = [qmm.qgemm_column(mt, 16 * warp + g + 8 * h) for mt in range(2) for h in range(2)]
            assert held == [4 * q + 2 * mt + h for mt in range(2) for h in range(2)]


def test_one_shared_load_feeds_four_fragments_without_bank_conflicts():
    """A thread's four columns are one aligned 32-bit word of a depth row,
    and the 32 lanes of a load (rows 2t + d of a k16 step, two 16-byte
    chunks a row under the 128-byte swizzle) hit 32 distinct banks."""
    for warp in range(4):
        for d in (0, 1, 8, 9):
            for r0 in (0, 16, 48, 112):
                banks = set()
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    q, r = 8 * warp + g, r0 + 2 * t + d
                    addr = r * 128 + (((q >> 2) ^ (r & 7)) << 4) + 4 * (q & 3)
                    banks.add((addr // 4) % 32)
                assert len(banks) == 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_activation_takes_bf16_and_float32(dtype):
    """Fault 10: K5, K6 and K7 take float32 activations on the card, as
    JAX's kernels do (qmm.py:178-188, 311-320); K8 and K9 keep bf16."""
    x = torch.zeros((4, 256), dtype=dtype)
    qmm.check_activation(x, "K5")
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="bfloat16 activations"):
            qmm.check_activation(x, "K8", (torch.bfloat16,))
    with pytest.raises(ValueError, match="float16"):
        qmm.check_activation(x.half(), "K5")
    with pytest.raises(ValueError, match="contiguous"):
        qmm.check_activation(torch.zeros((4, 512), dtype=dtype)[:, ::2], "K5")


@pytest.mark.parametrize("name,m", [(n, m) for n in {**LLAMA3_8B, **SMALL} for m in (1, 4, 64, 128, 129)])
def test_stream_k_reduction_order(name, m):
    """The stream-K reduction (K6's split and every stream-K K5/K7 call):
    each column tile sums the slots of the consecutive CTAs whose shares
    hold its k-blocks (owner of its first k-block to owner of its last), in
    CTA order, each slot once over the call; a CTA shares at most two tiles
    with other CTAs (its first and its last)."""
    n, k = {**LLAMA3_8B, **SMALL}[name]
    sched = qmm.qgemm_schedule(m, n, k)
    if sched.whole:
        assert sched.partial_floats(m) == 0
        return
    order = [[] for _ in range(sched.col_tiles)]
    for _, t, _, _, slot in sched.segments():
        order[t].append(slot)
    owner = lambda u: next(c for c in range(sched.ctas) if sched._start(c) <= u < sched._start(c + 1))  # noqa: E731
    shared = {c: 0 for c in range(sched.ctas)}
    seen = set()
    for t, slots in enumerate(order):
        ctas = [slot - t for slot in slots]
        first, last = owner(t * sched.kblocks), owner((t + 1) * sched.kblocks - 1)
        assert ctas == list(range(first, last + 1))
        assert not seen & set(slots)
        seen |= set(slots)
        assert max(slots) < sched.ctas + sched.col_tiles  # inside partial_floats' slots
        if len(ctas) > 1:
            for c in ctas:
                shared[c] += 1
    assert max(shared.values()) <= 2
    covered = sorted((t, kb) for _, t, kb0, kb1, _ in sched.segments() for kb in range(kb0, kb1))
    assert covered == [(t, kb) for t in range(sched.col_tiles) for kb in range(sched.kblocks)]


@pytest.mark.parametrize("name,m,streams,want", [
    ("wo", 4, None, True), ("w_qkv", 4, None, True), ("w_down", 64, None, True),
    ("w_gate_up", 4, None, False), ("lm_head", 4, None, False), ("wo", 1536, None, False),
    ("wo", 4, 1, False), ("w_gate_up", 4, 4, True), ("wo", 129, None, False),
])
def test_is_split_k_follows_the_split_rule(name, m, streams, want):
    """A bf16 call counts as K6 where the card's rule splits it (up to 128
    rows and fewer 128-column tiles than the SMs) or the caller asks for
    more than one K range."""
    n = {**LLAMA3_8B, **SMALL}[name][0]
    assert qmm.is_split_k(m, n, streams) is want
