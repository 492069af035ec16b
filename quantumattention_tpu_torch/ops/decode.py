"""Fused GQA decode attention over a ragged KV cache (counterpart of
quantumattention_tpu/ops/decode.py).

``decode_attention`` is the wrapper of kernel K4 (``csrc/decode.cu``, the
port of the Pallas ``_decode_kernel``, decode.py:56).  A CPU tensor runs the
kernel's plain version, :func:`decode_attention_plain`; a CUDA tensor runs
the kernel or raises.  ``decode_attention.launches`` counts launches.

K4 and K10 (``ops/paged.py``) run on one split-KV decode-attention core
(``csrc/decode_attn.cuh``): a persistent grid whose CTAs each take an equal
contiguous share of the valid 64-row tiles of every (slot, KV head, query
split, column split) segment, and one merge kernel that sums each
segment's partials in CTA order.  :func:`decode_schedule` is that schedule
in Python; :func:`card_plan` reads the card's plan of a call (CTAs, and how
its query heads and columns are split into segments).

Covered: (B, Hq, D) float queries (bf16; float32 and float16 enter the
kernel rounded to bf16, as K1's do), and the (B, Hq, T, D) queries of
speculative verification (decode.py:359-363): T candidates a head whose
``lengths`` already count all T, candidate t seeing the rows below
``lengths - (T - 1 - t)``, each KV head's G * T rows packed t-fastest as
in JAX (decode.py:433-440); caches of int8 or e4m3 with token-wise fp32
scales, packed int4 (minor dim D/2, element d in the low nibble and
d + D/2 in the high nibble of byte d, ``quant.pack_int4``) with the same
scales, or bf16, float16 or float32 without; ragged lengths including 0
(zero output rows), any GQA group, any head dim JAX takes (a multiple of 8
up to 512, run at an instantiated width of 64, 128, 256 or 512 with zero
columns), bf16 output as JAX returns, and sliding windows ``window = (left,
0)`` (or ``(left, None)``): candidate t also skips the rows below ``lengths
- 1 - left - (T - 1 - t)`` (decode.py:200-207), and the kernel starts each
slot at the first 64-row tile that candidate 0 can see, so a window model
reads about a window of rows a step (``decode_schedule``'s ``window_left``
mirrors that).  8-bit queries are refused, as in JAX.  Not ported: the
``decode_int8_qk``/``decode_int8_pv`` variants (int8 MXU experiments, off
by default in JAX) and ``_auto_window_block_kv`` (TPU block sizing); see
ROADMAP, "Do not port these TPU workarounds".

``decode_attention.verify_launches`` counts the launches of T > 1 calls
and ``.window_launches`` those with a window (both are in ``launches``
too).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import checks, shapes
from . import _native, quant
from .sdpa import DEFAULT_MASK_VALUE

LOG2E = math.log2(math.e)
#: Cache rows of one tile of the decode-attention core (csrc/decode_attn.cuh, kRows).
ROWS_PER_TILE = 64
#: Query rows one segment holds; more query heads a KV head are split.
MAX_QUERY_ROWS = 16
#: Tiles a CTA takes at least, where there are enough (kMinTiles).
MIN_TILES = 2
#: The core's element kinds (csrc/decode_attn.cuh, Kind): int4 is packed
#: along the head dim in K4's slot cache, along a page's tokens in K10's.
KINDS = {"int8": 0, "e4m3": 1, "bf16": 2, "int4": 3, "int4_pages": 4, "f16": 5, "f32": 6}
#: The kinds whose rows carry no token scales.
FLOAT_KINDS = (KINDS["bf16"], KINDS["f16"], KINDS["f32"])


def cache_kind(dtype, int4: bool = False, pages: bool = False) -> int:
    """The core's element kind of a cache or page pool."""
    if int4:
        return KINDS["int4_pages" if pages else "int4"]
    names = {torch.int8: "int8", torch.float8_e4m3fn: "e4m3", torch.bfloat16: "bf16",
             torch.float16: "f16", torch.float32: "f32"}
    if dtype not in names:
        raise ValueError(
            f"the decode kernels take int8, e4m3, int4, bf16, float16 or float32 caches, got {dtype}"
        )
    return KINDS[names[dtype]]


def kernel_query(q: torch.Tensor, kind: int) -> torch.Tensor:
    """The query as the core reads it: rounded to bf16 (the plain
    versions' input), then for an fp16 cache converted to fp16 for the
    fp16 products, one more launch.  That conversion is exact only in
    fp16's normal range: a |q| above 65504 becomes inf (and the output NaN)
    and one below 2^-14 loses bits, where the plain version and JAX's
    kernel keep the bf16 value."""
    q = q.to(torch.bfloat16)
    return (q.to(torch.float16) if kind == KINDS["f16"] else q).contiguous()


def core_segments(hq: int, hkv: int, d: int, kind: int, qtokens: int = 1) -> int:
    """Segments a slot in the core's schedule (``plan``): KV heads x query
    splits (a KV head's G * T query rows in splits of MAX_QUERY_ROWS) x
    column splits of the output width a CTA owns (``v_cols``).  Used with
    :func:`decode_schedule` for K4 and K10 alike."""
    w = shapes.kernel_width(d)
    if kind == KINDS["f32"]:
        vw = w if w <= 128 else 64
    elif w <= 256:
        vw = w
    else:
        vw = 64 if kind in (KINDS["bf16"], KINDS["f16"]) else 256
    csplits = w // vw if kind == KINDS["int4"] else -(-d // vw)
    return hkv * -(-(hq // hkv * qtokens) // MAX_QUERY_ROWS) * csplits


@dataclass(frozen=True)
class DecodeSchedule:
    """The core's persistent schedule over one call's lengths.

    Tiles are numbered slot by slot, segment by segment, row by row; a
    slot's ``tiles`` start at its tile ``first`` (0 without a window).  The
    first ``active`` CTAs (at most ``ctas``, each with at least MIN_TILES
    tiles where there are that many) share them: CTA c takes ``base``
    tiles, one more when c < ``rem``, from c * base + min(c, rem) on.  A
    run of a CTA's tiles inside one segment writes one partial, at index
    cta + segment (segment = slot * segments + j), and the merge sums a
    segment's partials in CTA order."""

    ctas: int
    segments: int     # segments a slot
    tiles: tuple      # tiles of each slot's segments
    total: int        # tiles of the call
    first: tuple = () # each slot's first tile (its rows from first * rows_per_tile on)

    @property
    def active(self) -> int:
        return max(1, min(self.ctas, self.total // MIN_TILES))

    @property
    def base(self) -> int:
        return self.total // self.active

    @property
    def rem(self) -> int:
        return self.total % self.active

    def cta_tiles(self, c: int) -> tuple:
        """The tiles [u0, u1) of CTA c's share (empty past ``active``)."""
        if c >= self.active:
            return self.total, self.total
        u0 = c * self.base + min(c, self.rem)
        return u0, u0 + self.base + (1 if c < self.rem else 0)

    def segment_tiles(self, seg: int) -> tuple:
        """The tiles [t0, t1) of segment seg (slot seg // segments)."""
        b, j = divmod(seg, self.segments)
        t0 = int(self._slot_starts[b]) + j * self.tiles[b]
        return t0, t0 + self.tiles[b]

    @functools.cached_property
    def _slot_starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.tiles)[:-1]]).astype(np.int64) * self.segments

    def owner(self, u: int) -> int:
        """The CTA whose share holds tile u."""
        big = self.rem * (self.base + 1)
        return u // (self.base + 1) if u < big else self.rem + (u - big) // self.base

    def runs(self, c: int) -> list:
        """CTA c's runs in order: (segment, first tile, stop tile) of each
        segment its share touches, tiles numbered within the segment (its
        tile i holds the slot's tile ``first[slot] + i``)."""
        u0, u1 = self.cta_tiles(c)
        out = []
        if u0 == u1:
            return out
        b = int(np.searchsorted(self._slot_starts, u0, side="right")) - 1
        while b < len(self.tiles) and self._slot_starts[b] < u1:
            for j in range(self.segments if self.tiles[b] else 0):
                seg = b * self.segments + j
                t0, t1 = self.segment_tiles(seg)
                lo, hi = max(t0, u0), min(t1, u1)
                if lo < hi:
                    out.append((seg, lo - t0, hi - t0))
            b += 1
        return out

    def merge_order(self, seg: int) -> list:
        """The CTAs whose partials the merge sums for segment seg, in order
        (partial index cta + seg); empty for an empty slot."""
        t0, t1 = self.segment_tiles(seg)
        if t0 == t1:
            return []
        return list(range(self.owner(t0), self.owner(t1 - 1) + 1))


def decode_schedule(lengths, segments: int, rows_per_tile: int, ctas: int,
                    max_rows: Optional[int] = None, window_left: Optional[int] = None,
                    qtokens: int = 1) -> DecodeSchedule:
    """The schedule of ``ctas`` CTAs over slots of these lengths (clamped to
    [0, max_rows]), each slot ``segments`` segments of its tiles
    (csrc/decode_attn.cuh: find_share, share, owner, first_tile): ceil(length
    / rows_per_tile) of them, or with a window those from the first tile
    that candidate 0 of ``qtokens`` sees, (length - qtokens - window_left)
    // rows_per_tile."""
    lens = np.clip(np.asarray(lengths, np.int64), 0, max_rows)
    first = np.zeros_like(lens)
    if window_left is not None:
        first = np.maximum(lens - qtokens - window_left, 0) // rows_per_tile
    tiles = tuple(int(t) for t in -(-lens // rows_per_tile) - first)
    return DecodeSchedule(ctas, segments, tiles, sum(tiles) * segments,
                          tuple(int(f) for f in first))


def card_plan(kind: int, batch: int, hq: int, hkv: int, d: int, smax: int, ps: int = 0,
              qtokens: int = 1) -> dict:
    """The plan the card computes for a call of ``qtokens`` query tokens a
    head (``qa_decode_attn_plan``): CTAs, splits, partial sizes, and
    whether rows go by TMA boxes (K10: ``ps`` its page size; 0 for K4)."""
    out = (ctypes.c_int * 8)()
    _native.check(_native.library().qa_decode_attn_plan(kind, batch, hq, hkv, d, qtokens, smax, ps,
                                                        out),
                  "qa_decode_attn_plan")
    ctas, qsplits, csplits, qrows, ccols, segs, tma, width = list(out)
    return {"ctas": ctas, "qsplits": qsplits, "csplits": csplits, "qrows": qrows,
            "ccols": ccols, "segments": segs, "tma": bool(tma), "width": width}


def core_scratch(plan: dict, batch: int, device) -> tuple:
    """The partials' fp32 scratch of one call: (acc, (m, l))."""
    pieces = plan["ctas"] + batch * plan["segments"]
    acc = torch.empty((pieces, plan["qrows"], plan["ccols"]), dtype=torch.float32, device=device)
    ml = torch.empty((pieces, plan["qrows"], 2), dtype=torch.float32, device=device)
    return acc, ml


def window_left_of(window, name: str) -> Optional[int]:
    """The left extent of a decode ``window`` (None for none), with JAX's
    rule that the right extent is 0 or None (decode.py:399-408)."""
    if window is None:
        return None
    left, right = window
    if right not in (None, 0):
        raise ValueError(
            f"{name} window must be (left, 0) or (left, None): queries are "
            f"the newest tokens, got right={right}"
        )
    if left is None:
        return None
    if int(left) < 0:
        raise ValueError(f"{name} window's left extent must be >= 0, got {left}")
    return int(left)


def window_valid(lengths: torch.Tensor, rows: int, window_left: Optional[int]) -> torch.Tensor:
    """(B, rows) bool: the rows a one-token query at position lengths - 1
    sees, [0, lengths) or with a window [lengths - 1 - window_left, lengths)."""
    pos = torch.arange(rows, device=lengths.device)[None, :]
    valid = pos < lengths[:, None]
    if window_left is not None:
        valid &= pos >= (lengths - 1 - window_left)[:, None]
    return valid


def decode_attention_plain(
    q, k_cache, v_cache, lengths, k_scale=None, v_scale=None, sm_scale=None, window_left=None,
) -> torch.Tensor:
    """K4's plain version in fp32: q rounded to bf16 (the kernel's input),
    the cache's exact values (a packed int4 cache unpacked as
    ``quant.unpack_int4``), mask rows >= lengths[b], exp2 softmax with
    sm_scale * log2(e) and the K scale folded into the scores, the
    unnormalized P (times the V scale) rounded to bf16 as the kernel does,
    P.V divided by the softmax sum, zeros for empty slots.  With
    ``window_left`` also the rows below lengths - 1 - window_left masked.  A
    (B, Hq, T, D) q gives (B, Hq, T, D): candidate t is the one-query call
    at lengths - (T - 1 - t)."""
    if q.ndim == 4:
        return candidates(lambda qt, lens: decode_attention_plain(
            qt, k_cache, v_cache, lens, k_scale, v_scale, sm_scale, window_left), q, lengths)
    batch, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.to(torch.bfloat16).float().reshape(batch, hkv, group, d)
    if k_cache.shape[-1] * 2 == d:
        k_cache = quant.unpack_int4(k_cache)
        v_cache = quant.unpack_int4(v_cache)
    k = k_cache.float()
    v = v_cache.float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k) * (sm_scale * LOG2E)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    valid = window_valid(lengths.to(q.device), s_max, window_left)
    s = s.masked_fill(~valid[:, None, None, :], DEFAULT_MASK_VALUE)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) / l
    o = torch.where((lengths.to(q.device) > 0)[:, None, None, None], o, 0.0)
    return o.reshape(batch, hq, d).to(torch.bfloat16)


def candidates(one_query, q, lengths) -> torch.Tensor:
    """A plain version's multi-query call: candidate t of the (B, Hq, T, D)
    q is ``one_query(q[:, :, t], lengths - (T - 1 - t))`` (the rows it may
    see), stacked along T.  A slot shorter than T leaves its first
    candidates no row: they come out as zeros, where the kernels and JAX
    give some average of V (no caller reads them)."""
    t_max = q.shape[2]
    return torch.stack([one_query(q[:, :, t], lengths - (t_max - 1 - t)) for t in range(t_max)], dim=2)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """GQA decode attention; returns (B, Hq, D), or (B, Hq, T, D), in bf16.

    q (B, Hq, D) float, or (B, Hq, T, D): T candidate tokens a slot
    (speculative verification), ``lengths`` counting all T and candidate t
    seeing the rows below ``lengths - (T - 1 - t)``; k_cache/v_cache (B,
    Hkv, Smax, D) int8 or e4m3, or (B, Hkv, Smax, D/2) packed int4 in an
    int8 container, with ``k_scale``/``v_scale`` (B, Hkv, Smax) fp32, or
    bf16, float16 or float32 without scales; lengths (B,) int32 valid rows
    per slot (0 = empty slot, zero output); ``window`` (left, 0) or (left,
    None): the query at position lengths - 1 sees the rows from
    lengths - 1 - left on (HF's window w is left = w - 1).
    """
    window_left = window_left_of(window, "decode_attention")
    if q.ndim not in (3, 4):
        raise ValueError(f"q must be (B, Hq, D) or (B, Hq, T, D), got {tuple(q.shape)}")
    batch, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k_cache and v_cache must be equal (B, Hkv, Smax, D)")
    _, hkv, s_max, cache_dim = k_cache.shape
    int4 = cache_dim * 2 == d
    if int4 and k_cache.dtype != torch.int8:
        raise ValueError(
            "packed-int4 cache (minor dim = head_dim/2) must use an int8 "
            f"container, got {k_cache.dtype}"
        )
    if (not int4 and cache_dim != d) or k_cache.shape[0] != batch:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if checks.is_8bit_dtype(q.dtype):
        raise ValueError(
            "decode_attention expects float queries (the cache may be "
            "8-bit, but q has no dequant-scale path)"
        )
    if hq % hkv != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    quantized = k_scale is not None
    if checks.is_8bit_dtype(k_cache.dtype) and not quantized:
        raise ValueError("8-bit KV cache requires k_scale/v_scale")
    if quantized and (k_scale.shape != (batch, hkv, s_max) or v_scale.shape != k_scale.shape):
        raise ValueError("k_scale/v_scale must be (B, Hkv, Smax)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, k_scale, v_scale, sm_scale,
                                      window_left)
    return _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale, sm_scale, window_left)


decode_attention.launches = 0
decode_attention.verify_launches = 0
decode_attention.window_launches = 0


def _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale, sm_scale, window_left=None):
    """Check what the kernel takes, launch it on the current stream."""
    checks.require_hopper(q.device)
    kind = cache_kind(k_cache.dtype, int4=k_cache.shape[-1] * 2 == q.shape[-1])
    if v_cache.dtype != k_cache.dtype:
        raise ValueError("K4's k and v caches must share a type")
    if (kind in FLOAT_KINDS) != (k_scale is None):
        raise ValueError(
            "K4 takes token scales with int8, e4m3 and int4 caches, none with bf16, float16 or float32"
        )
    q = kernel_query(q, kind)  # float32 / float16 queries enter rounded
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if k_scale is not None and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("cache scales must be float32")
    tensors = [q, k_cache, v_cache, lengths] + [
        t for t in (k_scale, v_scale) if t is not None
    ]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all K4 operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("K4 operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("K4's q and caches must be 16-byte aligned")
    batch, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    qtokens = q.shape[2] if q.ndim == 4 else 1
    _, hkv, s_max, _ = k_cache.shape
    shapes.check_kernel_head_dim("K4", d)
    plan = card_plan(kind, batch, hq, hkv, d, s_max, qtokens=qtokens)
    part_acc, part_ml = core_scratch(plan, batch, q.device)
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    err = _native.library().qa_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), batch, hq, hkv, s_max, d, qtokens, kind,
        -1 if window_left is None else window_left, float(sm_scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "qa_decode")
    decode_attention.launches += 1
    decode_attention.verify_launches += qtokens > 1
    decode_attention.window_launches += window_left is not None
    return out
