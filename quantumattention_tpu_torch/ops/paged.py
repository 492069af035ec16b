"""Paged decode attention (counterpart of quantumattention_tpu/ops/paged.py).

``paged_decode_attention`` is the wrapper of kernel K10 (``csrc/paged.cu``,
the port of the Pallas ``_paged_kernel``, paged.py:77): GQA decode over a
pool of KV pages, each sequence's pages named by its row of a page table,
one query token a head or the T candidates of speculative verification.  A CPU tensor runs the kernel's plain version,
:func:`paged_decode_attention_plain`; a CUDA tensor runs the kernel or
raises.  ``paged_decode_attention.launches`` counts launches.

The math is that of the JAX kernel's DMA path (paged.py:230-293), not of
K4: each page row of K and V is dequantized per element to bf16 (code times
the row's scale, rounded once), the unnormalized P is rounded to bf16 before
P.V, and the sum l divides at the end; K4 puts the scales on the scores.  It
is not JAX's ``_gathered_reference`` either (paged.py:344-410, the interpret
mode's default), so the parity tests run the JAX kernel with
``use_dma=True``.

The wrapper reads nothing back to the host: the kernel runs on the
split-KV decode-attention core it shares with K4 (``csrc/decode_attn.cuh``,
``ops/decode.decode_schedule``), whose grid comes from the card and the
shapes, never from the lengths, so a decode step that calls it can be
captured in a CUDA graph.  It takes the folded (Hkv, P, ps/128, 128) scale layout of the JAX
package (a Mosaic DMA rule, serving/paged_cache.py) as a view of the flat
(Hkv, P, ps) one.

Covered: (B, Hq, D) float queries (float32 and float16 enter the kernel
rounded to bf16) and the multi-query (B, Hq, T, D) of speculative
verification (paged.py:459-463: ``lengths`` count all T candidates,
candidate t sees the rows below ``lengths - (T - 1 - t)``, rows packed
t-fastest as in K4), int8 or e4m3 pages with token-wise fp32 scales,
token-packed int4 pages (``serving/paged_cache``: (Hkv, P, ps/2, D) bytes,
byte row i of a page holding token i in its low nibble and i + ps/2 in its
high nibble, scales (Hkv, P, ps) per real token) and bf16, float16 or
float32 pages; any GQA group, any page size (even for int4), any head dim
JAX takes (a multiple of 8 up to 512, run at an instantiated width of 64,
128, 256 or 512 with zero columns), and sliding windows ``window = (left,
0)`` as K4 takes them (paged.py:272-276): the kernel starts each sequence
at the first 64-token tile that candidate 0 can see, so the pages below a
window are never looked up.  8-bit queries are refused, as in JAX.
``side`` (the burst side buffer, paged.py:446-457) exists for XLA's
scatter copy and is not ported (ROADMAP, "Do not port these TPU
workarounds").  ``paged_decode_attention.verify_launches`` counts the
launches of T > 1 calls and ``.window_launches`` those with a window (both
are in ``launches`` too).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import checks, shapes
from . import _native, quant
from .decode import (
    FLOAT_KINDS,
    cache_kind,
    candidates,
    card_plan,
    core_scratch,
    kernel_query,
    window_left_of,
    window_valid,
)
from .sdpa import DEFAULT_MASK_VALUE

LOG2E = math.log2(math.e)


def _scale_rows(sp: torch.Tensor) -> int:
    if sp.ndim == 4:
        if sp.shape[3] != 128:
            raise ValueError(
                f"folded scale pages must have a 128-lane minor, got {tuple(sp.shape)}"
            )
        return sp.shape[2] * sp.shape[3]
    return sp.shape[2]


def _flat_scales(sp: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(Hkv, P, ps) scales; the folded layout as a view of the same memory."""
    if sp is None or sp.ndim == 3:
        return sp
    return sp.reshape(sp.shape[0], sp.shape[1], -1)


def paged_decode_attention_plain(
    q, k_pages, v_pages, lengths, page_indices, k_scale_pages=None, v_scale_pages=None,
    sm_scale=None, window_left=None,
) -> torch.Tensor:
    """K10's plain version, on (Hkv, P, ps) scale pages: gather each
    sequence's pages through its table row (entries past its pages are
    replaced by page 0 and masked, never used), unpack token-packed int4
    pages (``quant.unpack_int4`` along the page's token axis), dequantize
    K and V per element to bf16, q rounded to bf16, fp32 scores times
    sm_scale * log2(e), rows at or past the length masked, exp2 softmax with
    the unnormalized P rounded to bf16 before P.V, division by the sum at
    the end, zeros for an empty slot; with ``window_left`` also the rows
    below lengths - 1 - window_left masked.  Returns (B, Hq, D) bf16; a
    (B, Hq, T, D) q gives (B, Hq, T, D), candidate t the one-query call at
    lengths - (T - 1 - t)."""
    if q.ndim == 4:
        return candidates(lambda qt, lens: paged_decode_attention_plain(
            qt, k_pages, v_pages, lens, page_indices, k_scale_pages, v_scale_pages, sm_scale,
            window_left), q, lengths)
    batch, hq, d = q.shape
    if k_scale_pages is not None and k_scale_pages.shape[2] == 2 * k_pages.shape[2]:
        k_pages = quant.unpack_int4(k_pages, axis=2)
        v_pages = quant.unpack_int4(v_pages, axis=2)
    hkv, _, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    lengths = lengths.to(dev).long()
    live = torch.arange(pps, device=dev)[None, :] < ((lengths + ps - 1) // ps)[:, None]
    table = torch.where(live, page_indices.to(dev).long(), 0)

    def gather(pages, scales):
        x = pages[:, table].permute(1, 0, 2, 3, 4).reshape(batch, hkv, pps * ps, d)
        if scales is not None:
            s = scales[:, table].permute(1, 0, 2, 3).reshape(batch, hkv, pps * ps)
            x = (x.float() * s.float()[..., None]).to(torch.bfloat16)
        return x.to(torch.bfloat16).float()

    k, v = gather(k_pages, k_scale_pages), gather(v_pages, v_scale_pages)
    qg = q.to(torch.bfloat16).float().reshape(batch, hkv, group, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k) * (sm_scale * LOG2E)
    valid = window_valid(lengths, pps * ps, window_left)
    s = s.masked_fill(~valid[:, None, None, :], DEFAULT_MASK_VALUE)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(torch.bfloat16).float(), v) / l
    o = torch.where((lengths > 0)[:, None, None, None], o, 0.0)
    return o.reshape(batch, hq, d).to(torch.bfloat16)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_scale_pages: Optional[torch.Tensor] = None,
    v_scale_pages: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    pages_per_block: int = 4,
    window=None,
    side: Optional[dict] = None,
) -> torch.Tensor:
    """Decode attention over paged KV; returns bf16 of q's shape.

    q (B, Hq, D) float, or (B, Hq, T, D): T candidates a sequence,
    ``lengths`` counting all T; k_pages/v_pages (Hkv, num_pages, page_size,
    D) int8 or e4m3, or token-packed int4 (Hkv, num_pages, page_size/2, D),
    with ``k_scale_pages``/``v_scale_pages`` (Hkv, num_pages, page_size)
    fp32 (or the folded (Hkv, num_pages, page_size/128, 128)), or bf16,
    float16 or float32 without;
    lengths (B,) int32 valid tokens per sequence (0 = empty, zero
    output); page_indices (B, pages_per_seq) int32, entries past a
    sequence's pages ignored.  ``pages_per_block`` must divide
    pages_per_seq, as in JAX; it sizes the TPU's DMA blocks, and the card's
    kernel tiles the pages its own way.  ``window`` (left, 0) or (left,
    None): the newest query sees the tokens from lengths - 1 - left on.
    """
    if q.ndim not in (3, 4):
        raise ValueError(f"q must be (B, Hq, D) or (B, Hq, T, D), got {tuple(q.shape)}")
    batch, num_q_heads, head_dim = q.shape[0], q.shape[1], q.shape[-1]
    num_kv_heads, _, page_rows, _ = k_pages.shape
    pages_per_seq = page_indices.shape[1]
    if num_q_heads % num_kv_heads != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    quantized = k_scale_pages is not None
    if quantized != (v_scale_pages is not None):
        raise ValueError("k_scale_pages and v_scale_pages go together")
    if checks.is_8bit_dtype(k_pages.dtype) and not quantized:
        raise ValueError("8-bit KV pages require scale pages")
    int4 = False
    if quantized:
        scale_rows = _scale_rows(k_scale_pages)
        if scale_rows == 2 * page_rows:
            int4 = True
        elif scale_rows != page_rows:
            raise ValueError(
                f"scale pages carry {scale_rows} token rows per page, but "
                f"the KV pages have {page_rows} byte rows: expected exactly "
                f"{page_rows} (int8 layout) or {2 * page_rows} (token-packed "
                "int4 layout)"
            )
        if _scale_rows(v_scale_pages) != scale_rows or v_scale_pages.ndim != k_scale_pages.ndim:
            raise ValueError(
                f"k/v scale pages disagree on layout: "
                f"{tuple(k_scale_pages.shape)} vs {tuple(v_scale_pages.shape)}"
            )
    if int4 and k_pages.dtype != torch.int8:
        raise ValueError("int4 pages must use an int8 container")
    if checks.is_8bit_dtype(q.dtype):
        raise ValueError(
            "paged_decode_attention expects float queries (the pages may be "
            "8-bit, but q has no dequant-scale path)"
        )
    if pages_per_seq % pages_per_block != 0:
        raise ValueError(
            f"pages_per_seq ({pages_per_seq}) must be a multiple of "
            f"pages_per_block ({pages_per_block})"
        )
    window_left = window_left_of(window, "paged_decode_attention")
    if side is not None:
        raise NotImplementedError(
            "paged_decode_attention: the burst side buffer is a TPU workaround "
            "for XLA's scatter copy and is not ported (ROADMAP, \"Do not port "
            "these TPU workarounds\"); the port writes pages in place"
        )
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    ks, vs = _flat_scales(k_scale_pages), _flat_scales(v_scale_pages)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, page_indices, ks, vs, sm_scale, window_left
        )
    return _paged_cuda(q, k_pages, v_pages, lengths, page_indices, ks, vs, sm_scale, int4,
                       window_left)


paged_decode_attention.launches = 0
paged_decode_attention.verify_launches = 0
paged_decode_attention.window_launches = 0


def _paged_cuda(q, k_pages, v_pages, lengths, page_indices, ks, vs, sm_scale, int4,
                window_left=None):
    """Check what the kernel takes, launch it on the current stream."""
    checks.require_hopper(q.device)
    batch, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    qtokens = q.shape[2] if q.ndim == 4 else 1
    hkv, num_pages, rows, _ = k_pages.shape
    ps = 2 * rows if int4 else rows
    pps = page_indices.shape[1]
    kind = cache_kind(k_pages.dtype, int4=int4, pages=True)
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("K10's k and v pages must share a type")
    if (kind in FLOAT_KINDS) != (ks is None):
        raise ValueError(
            "K10 takes scale pages with int8, e4m3 and int4 pages, none with bf16, float16 or float32"
        )
    q = kernel_query(q, kind)  # float32 / float16 queries enter rounded
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("K10's lengths and page_indices must be int32")
    if ks is not None and (ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError("K10's scale pages must be float32")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(
            f"page shapes {tuple(k_pages.shape)}, {tuple(v_pages.shape)} do not match q {tuple(q.shape)}"
        )
    if tuple(lengths.shape) != (batch,) or page_indices.shape[0] != batch:
        raise ValueError("lengths (B,) and page_indices (B, pages_per_seq) must match q's B")
    shapes.check_kernel_head_dim("K10", d)
    tensors = [q, k_pages, v_pages, lengths, page_indices] + [t for t in (ks, vs) if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all K10 operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("K10 operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("K10's operands must be 16-byte aligned")
    plan = card_plan(kind, batch, hq, hkv, d, pps * ps, ps, qtokens=qtokens)
    part_acc, part_ml = core_scratch(plan, batch, q.device)
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    err = _native.library().qa_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), batch, hq, hkv, num_pages, ps, pps, d, qtokens, kind,
        -1 if window_left is None else window_left, float(sm_scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "qa_paged_decode")
    paged_decode_attention.launches += 1
    paged_decode_attention.verify_launches += qtokens > 1
    paged_decode_attention.window_launches += window_left is not None
    return out
