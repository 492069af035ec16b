"""The decode-attention core's persistent schedule (ops/decode.decode_schedule), on the CPU.

K4 and K10 run on one split-KV core (csrc/decode_attn.cuh): a grid of CTAs
sized from the card, each taking an equal contiguous share of the valid
64-row tiles of every (slot, KV head, query split, column split) segment,
and a merge that sums each segment's partials in CTA order.  The kernels
compute the same closed form as the Python function; these tests hold the
Python function to what the kernels rely on: every valid tile covered once,
no tile at or past a length, shares within one tile of each other (and of
at least MIN_TILES tiles where there are enough: fewer CTAs then take
part), one
partial slot per (CTA, segment) run, a fixed merge order, and no work for
an empty slot.  The card tests hold the card's split to this one.
"""

import numpy as np
import pytest

from quantumattention_tpu_torch.ops import decode


def _k10_lengths():
    """chip_smoke.py's K10 point: 16 slots up to 1024, one empty, one full."""
    lens = np.random.default_rng(10).integers(1, 1025, 16)
    lens[0], lens[1] = 0, 1024
    return lens


#: (lengths, segments a slot, max rows): the 4-slot serving point (8 KV
#: heads), K10's 16 slots / 1024, and 64 slots / 512.
SHAPES = {
    "slots4": ([0, 57, 900, 2047], 8, 2048),
    "slots16_1024": (_k10_lengths(), 8, 1024),
    "slots64_512": (np.random.default_rng(64).integers(0, 513, 64), 8, 512),
}


def _check(sched, lens, rows, max_rows):
    """Every invariant the kernels rely on, for one schedule."""
    lens = np.clip(np.asarray(lens), 0, max_rows)
    segs = sched.segments
    covered = {}
    counts, slots_written, writers = [], set(), {}
    for c in range(sched.ctas):
        u0, u1 = sched.cta_tiles(c)
        counts.append(u1 - u0)
        runs = sched.runs(c)
        assert sum(stop - first for _, first, stop in runs) == u1 - u0
        assert [s for s, _, _ in runs] == sorted({s for s, _, _ in runs})  # one run a segment
        for seg, first, stop in runs:
            piece = c + seg
            assert piece not in slots_written and piece < sched.ctas + len(lens) * segs
            slots_written.add(piece)
            writers.setdefault(seg, []).append(c)
            assert (stop - 1) * rows < lens[seg // segs]  # never at or past the length
            for i in range(first, stop):
                covered[seg, i] = covered.get((seg, i), 0) + 1
    want = {(b * segs + j, i) for b, n in enumerate(lens) for j in range(segs)
            for i in range(-(-int(n) // rows))}
    assert set(covered) == want and all(v == 1 for v in covered.values())
    active = counts[: sched.active]
    assert max(active) - min(active) <= 1  # balanced
    assert min(active) >= min(decode.MIN_TILES, sched.total)
    assert not any(counts[sched.active:])
    assert sched.active == sched.ctas or sched.active * (decode.MIN_TILES + 1) > sched.total
    assert sum(counts) == sched.total == len(want)
    for seg in range(len(lens) * segs):
        order = sched.merge_order(seg)
        assert order == writers.get(seg, []) == sorted(order)
        if lens[seg // segs] == 0:
            assert order == []


@pytest.mark.parametrize("rows", [16, 32, 64])
@pytest.mark.parametrize("ctas", [1, 7, 132, 264])
@pytest.mark.parametrize("name", list(SHAPES))
def test_serving_shapes(name, ctas, rows):
    lens, segs, max_rows = SHAPES[name]
    _check(decode.decode_schedule(lens, segs, rows, ctas, max_rows), lens, rows, max_rows)


@pytest.mark.parametrize("seed", range(12))
def test_random_ragged_lengths(seed):
    """Ragged lengths with empty slots (some all empty), tile sizes
    16/32/64, segment counts 1-24, CTA counts 1-264."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 20))
    max_rows = int(rng.integers(1, 700))
    lens = rng.integers(0, max_rows + 40, b)  # some past max_rows: clamped
    lens[rng.random(b) < 0.3] = 0
    if seed == 0:
        lens[:] = 0
    rows = int(rng.choice([16, 32, 64]))
    segs = int(rng.integers(1, 25))
    for ctas in (1, int(rng.integers(2, 133)), 264):
        _check(decode.decode_schedule(lens, segs, rows, ctas, max_rows), lens, rows, max_rows)


@pytest.mark.parametrize("lens,segs,rows,ctas,max_rows", [
    ([5, 300, 0, 77], 3, 64, 10, 512),
    ([0, 57, 900, 2047], 8, 64, 132, 2048),     # the 4-slot point on one CTA a SM
    ([0, 57, 900, 2047], 8, 64, 264, 2048),     # two a SM: fewer take part
    ([0, 57, 900, 2047], 16, 16, 7, 2048),      # few CTAs, many tiles each
    ([1] * 9, 4, 32, 5, 64),                    # one tile a segment
    ([64, 65, 63, 128], 2, 64, 3, 128),         # lengths at tile edges
    ([1024, 0, 0, 1000], 1, 64, 256, 1024),     # two slots, most CTAs idle
    ([0, 0, 17], 5, 16, 1, 1024),               # one CTA takes every tile
    (list(range(0, 513, 8)), 8, 32, 132, 512),  # 65 slots of every 8th length
])
def test_owner_inverts_the_shares(lens, segs, rows, ctas, max_rows):
    """owner(u) is the CTA whose share holds tile u, for every tile."""
    sched = decode.decode_schedule(lens, segs, rows, ctas, max_rows)
    for c in range(sched.ctas):
        u0, u1 = sched.cta_tiles(c)
        assert all(sched.owner(u) == c for u in range(u0, u1))
    assert sorted(sched.owner(u) for u in range(sched.total)) == [sched.owner(u) for u in range(sched.total)]


def test_empty_call_has_no_work():
    sched = decode.decode_schedule([0, 0, 0], 8, 64, 264, 1024)
    assert sched.total == 0
    assert all(sched.runs(c) == [] for c in range(sched.ctas))
    assert all(sched.merge_order(s) == [] for s in range(24))


@pytest.mark.parametrize("hq,hkv,d,kind,want", [
    (64, 2, 128, "int8", 2 * 2),      # G = 32: two query splits a KV head (K10, fault 11)
    (32, 8, 128, "int4", 8),          # Llama-3-8B, head-dim-packed int4: one split
    (16, 8, 512, "int4", 8 * 2),      # int4 at 512: its two nibble halves
    (16, 8, 320, "e4m3", 8 * 2),      # 1-byte codes at 512 wide: 256 columns a split
    (16, 8, 320, "bf16", 8 * 5),      # bf16 at 512 wide: 64 columns a split
    (96, 2, 96, "int4_pages", 2 * 3),  # G = 48 over token-packed pages
])
def test_core_segments(hq, hkv, d, kind, want):
    assert decode.core_segments(hq, hkv, d, decode.KINDS[kind]) == want


@pytest.mark.parametrize("ps", [8, 128, 512])
@pytest.mark.parametrize("ctas", [1, 132, 256])
def test_k10_group_split_schedule(ctas, ps):
    """K10 at G = 32 (two query splits a KV head) over pages of 8, 128 and
    512 tokens: the schedule K10 now shares with K4 covers each tile once,
    balanced, in a fixed merge order (the page size changes where a tile's
    rows come from, not the tiles)."""
    lens = np.random.default_rng(ps).integers(0, 4 * ps + 1, 6)
    segs = decode.core_segments(64, 2, 128, decode.KINDS["int8"])
    _check(decode.decode_schedule(lens, segs, decode.ROWS_PER_TILE, ctas, 4 * ps), lens,
           decode.ROWS_PER_TILE, 4 * ps)


@pytest.mark.parametrize("hq,hkv,d,kind,t,want", [
    (32, 8, 128, "int8", 5, 8 * 2),    # Llama-3-8B verifying 5: 20 rows, two query splits
    (32, 8, 128, "int8", 4, 8),        # 16 rows: one split
    (32, 8, 128, "int4", 2, 8),        # 8 rows
    (64, 8, 128, "bf16", 5, 8 * 3),    # G = 8, T = 5: 40 rows, three splits
    (8, 8, 64, "f16", 2, 8),           # G = 1
    (16, 8, 320, "f16", 1, 8 * 5),     # fp16 at 512 wide: 64 columns a split, as bf16
    (32, 8, 128, "f32", 1, 8),         # fp32 up to 128 wide: one column split
    (16, 8, 256, "f32", 5, 8 * 4),     # fp32 at 256: 64 columns a split
    (8, 2, 512, "f32", 2, 2 * 8),      # fp32 at 512: 64 columns a split
    (64, 2, 128, "int4_pages", 3, 2 * 6),  # G = 32, T = 3 over token-packed pages
])
def test_core_segments_verify(hq, hkv, d, kind, t, want):
    """A KV head's G * T query rows take ceil(G * T / 16) query splits."""
    assert decode.core_segments(hq, hkv, d, decode.KINDS[kind], t) == want


@pytest.mark.parametrize("ctas", [1, 132, 256])
@pytest.mark.parametrize("t", [2, 5])
def test_verify_schedule(ctas, t):
    """Verification lengths (each active slot at least T, an empty slot)
    over Llama-3-8B's heads: the schedule with the T-wide query splits
    covers each tile once, balanced, in a fixed merge order."""
    lens = np.random.default_rng(t).integers(t, 1025, 16)
    lens[0] = 0
    segs = decode.core_segments(32, 8, 128, decode.KINDS["int8"], t)
    _check(decode.decode_schedule(lens, segs, decode.ROWS_PER_TILE, ctas, 1024), lens,
           decode.ROWS_PER_TILE, 1024)
