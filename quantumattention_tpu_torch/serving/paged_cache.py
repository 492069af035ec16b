"""Paged KV cache: a page pool per layer and per-sequence page tables
(counterpart of quantumattention_tpu/serving/paged_cache.py).

One logical page id addresses the same page in every layer's pool, so the
allocator and the page tables are shared across layers while each layer
owns its page tensors:

  k / v:               (Hkv, num_pages, page_size, D)  int8, e4m3, bf16,
                       float16 or float32;
                       (Hkv, num_pages, page_size/2, D) token-packed int4
  k_scale / v_scale:   (Hkv, num_pages, page_size)     fp32 (8-bit pages)

The scales keep this (Hkv, P, ps) layout at every page size.  The JAX
package folds pages wider than 128 tokens to (Hkv, P, ps/128, 128)
(``scale_shape``), a Mosaic DMA tiling rule; the port does not (ROADMAP,
"Do not port these TPU workarounds").  :func:`write_tokens` writes the
page tensors IN PLACE, as ``kv_cache.append`` does: a pool holds gigabytes
at serving sizes.

Host state (numpy, Python scheduler work): the free list, the page tables
(num_slots, pages_per_seq), lengths, allocated counts, and the refcounted
prefix cache with its LRU pool of idle pages (``PageAllocator``).

Token-packed int4 pages (``int4=True``, paged_cache.py:69-83) hold two
tokens a byte along the page's token axis, split halves within each page
(``quant.pack_int4``): byte row i holds token i in its low nibble and
token i + page_size/2 in its high nibble; the scales stay one per real
token, and a scale extent twice the byte rows marks the layout.  Writes
into them read, modify and write the bytes (:func:`write_tokens`,
:func:`write_lanes`, :func:`write_block`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import quant
from ..utils import checks
from .kv_cache import quantize_tokens


def hash_pages(prompt: Sequence[int], page_size: int) -> List[bytes]:
    """Chained content hashes of a prompt's WHOLE pages: ``h[i]`` names the
    page of tokens ``[i*ps, (i+1)*ps)`` and everything before it, so two
    prompts share page i only when they agree on ``[0, (i+1)*ps)`` (the
    vLLM automatic-prefix-caching scheme).  A partial last page is never
    hashed, so never shared."""
    out: List[bytes] = []
    h = b""
    for i in range(len(prompt) // page_size):
        chunk = np.asarray(prompt[i * page_size : (i + 1) * page_size], np.int32).tobytes()
        h = hashlib.sha1(h + chunk).digest()
        out.append(h)
    return out


@dataclasses.dataclass
class LayerPages:
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_layer_pages(
    num_kv_heads: int, num_pages: int, page_size: int, head_dim: int,
    dtype=torch.int8, int4: bool = False, device=None,
) -> LayerPages:
    """Zeroed pages; 8-bit pages carry fp32 token scales that start at
    ones.  ``int4=True``: token-packed pages (Hkv, P, page_size/2, D) with
    one scale a real token (the module docstring).  On the CUDA card
    unless ``device`` says otherwise."""
    rows = page_size
    if int4:
        if dtype != torch.int8:
            raise ValueError("int4 pages use an int8 container")
        if page_size % 2 != 0:
            raise ValueError("int4 pages need an even page_size")
        rows = page_size // 2
    device = checks.default_device(device)
    shape = (num_kv_heads, num_pages, rows, head_dim)
    pages = LayerPages(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
    if checks.is_8bit_dtype(dtype):
        scales = (num_kv_heads, num_pages, page_size)
        pages.k_scale = torch.ones(scales, dtype=torch.float32, device=device)
        pages.v_scale = torch.ones(scales, dtype=torch.float32, device=device)
    return pages


def is_int4(pages: LayerPages) -> bool:
    """Token-packed int4 pages: a scale row per token, two tokens a byte row."""
    return pages.k_scale is not None and pages.k_scale.shape[2] == 2 * pages.k.shape[2]


def quantize_page_tokens(t: torch.Tensor, dtype, int4: bool):
    """(..., D) float -> values and token scales for pages: int4 values
    unpacked (the pages pack the token axis), else as ``quantize_tokens``."""
    if int4:
        return quant.quantize_int4_values(t, reduction_dim=-1)
    return quantize_tokens(t, dtype)


def write_lanes(pages: LayerPages, page: torch.Tensor, off: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """One token a lane, in place: lane b's (Hkv, D) k/v rows go to token
    ``off[b]`` of page ``page[b]`` (int64 (B,) each).  Token-packed int4
    pages get nibble writes (backends.py:1134-1207): the byte row
    ``off % (ps/2)`` is read, its low nibble (first half of the page) or
    high nibble (second half) replaced, and written back."""
    int4 = is_int4(pages)
    kq, ks = quantize_page_tokens(k_new, pages.k.dtype, int4)
    vq, vs = quantize_page_tokens(v_new, pages.v.dtype, int4)
    if int4:
        half = pages.k.shape[2]
        low = (off < half)[None, :, None]
        row = torch.where(off < half, off, off - half)
        for dst, val in ((pages.k, kq), (pages.v, vq)):
            old = dst[:, page, row].to(torch.int32)
            new = val.transpose(0, 1).to(torch.int32) & 0xF
            dst[:, page, row] = torch.where(low, (old & ~0xF) | new, (old & 0xF) | (new << 4)).to(torch.int8)
    else:
        pages.k[:, page, off] = kq.transpose(0, 1)
        pages.v[:, page, off] = vq.transpose(0, 1)
    if ks is not None:
        pages.k_scale[:, page, off] = ks.transpose(0, 1)
        pages.v_scale[:, page, off] = vs.transpose(0, 1)


def write_block(pages: LayerPages, page: torch.Tensor, off: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """T tokens a lane, in place (the ``t_width`` lanes of the JAX
    package's ``_write_quantized``, backends.py:1077-1207): lane b's token t,
    (Hkv, D) rows of the (B, Hkv, T, D) ``k_new``/``v_new``, goes to token
    ``off[b, t]`` of page ``page[b, t]`` (int64 (B, T) each).  Token-packed
    int4 pages take one :func:`write_lanes` a token position, so that two
    tokens of one byte row (i and i + ps/2, both in a block where the page
    is shorter than 2T) are read and written in turn; other pages take all
    B * T lanes in one write."""
    t = k_new.shape[2]
    if is_int4(pages):
        for i in range(t):
            write_lanes(pages, page[:, i], off[:, i], k_new[:, :, i], v_new[:, :, i])
        return
    lanes = k_new.shape[0] * t

    def flat(x):
        return x.transpose(1, 2).reshape(lanes, x.shape[1], x.shape[3])

    write_lanes(pages, page.reshape(-1), off.reshape(-1), flat(k_new), flat(v_new))


def write_tokens(
    pages: LayerPages,
    page_ids: Sequence[int],
    offset_in_first_page: int,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
) -> LayerPages:
    """Write (Hkv, T, D) float tokens starting at ``offset_in_first_page``
    of ``page_ids[0]`` and running on through the following pages, in
    place; returns ``pages``.  ``page_ids`` are host ints (a list, numpy
    array or CPU tensor) covering [offset, offset + T).  Token-packed int4
    pages are unpacked a page at a time, spliced and packed again."""
    int4 = is_int4(pages)
    page_size = pages.k_scale.shape[2] if int4 else pages.k.shape[2]
    kq, ks = quantize_page_tokens(k_new, pages.k.dtype, int4)
    vq, vs = quantize_page_tokens(v_new, pages.v.dtype, int4)
    ids = [int(p) for p in page_ids]
    t = k_new.shape[1]

    def write_page(dst, values, page, pos, take, src):
        if not int4:
            dst[:, page, pos : pos + take] = values[:, src : src + take]
            return
        full = quant.unpack_int4(dst[:, page], torch.int8, axis=1)
        full[:, pos : pos + take] = values[:, src : src + take]
        dst[:, page] = quant.pack_int4(full, axis=1)

    pos, src, pi = offset_in_first_page, 0, 0
    while src < t:
        take = min(page_size - pos, t - src)
        page = ids[pi]
        write_page(pages.k, kq, page, pos, take, src)
        write_page(pages.v, vq, page, pos, take, src)
        if ks is not None:
            pages.k_scale[:, page, pos : pos + take] = ks[:, src : src + take]
            pages.v_scale[:, page, pos : pos + take] = vs[:, src : src + take]
        src += take
        pos = 0
        pi += 1
    return pages


class PageAllocator:
    """Host-side free-list allocator and per-slot page tables, with
    automatic prefix caching (vLLM-style): whole prompt pages are
    content-addressed by chained hash (:func:`hash_pages`), refcounted while
    a slot's table points at them, and parked in an LRU pool when idle,
    reusable by a later prompt with the same prefix and evictable when the
    free list runs dry.  Shared pages need no copy-on-write because the
    engine writes only a slot's OWN pages: prefill resumes after the adopted
    prefix, and decode appends past the prompt."""

    def __init__(self, num_pages: int, num_slots: int, pages_per_seq: int):
        self.num_pages = num_pages
        self.pages_per_seq = pages_per_seq
        self.free: List[int] = list(range(num_pages))
        # Entry 0 is a safe default: a table entry is always a page id.
        self.tables = np.zeros((num_slots, pages_per_seq), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.allocated = np.zeros((num_slots,), np.int32)
        # Prefix cache: content hash -> page id, live refcounts, and the
        # idle (refcount-0) pages in LRU order.
        self.cache: Dict[bytes, int] = {}
        self.page_hash: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        self.idle: "collections.OrderedDict[int, None]" = collections.OrderedDict()

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def evictable_pages(self) -> int:
        return len(self.idle)

    def pages_for(self, n_tokens: int, page_size: int) -> int:
        return -(-n_tokens // page_size)

    def can_fit(self, n_tokens: int, page_size: int) -> bool:
        return self.pages_for(n_tokens, page_size) <= len(self.free) + len(self.idle)

    def _take_free(self) -> int:
        if self.free:
            return self.free.pop()
        if self.idle:  # evict the least recently used cached prefix page
            page, _ = self.idle.popitem(last=False)
            del self.cache[self.page_hash.pop(page)]
            self.refs.pop(page, None)
            return page
        raise MemoryError("out of KV pages")

    def allocate(self, slot: int, n_tokens: int, page_size: int) -> np.ndarray:
        """Reserve pages so the slot can hold n_tokens in all; returns the
        newly allocated page ids (possibly none)."""
        have = int(self.allocated[slot])
        need = max(have, self.pages_for(n_tokens, page_size))
        if need > self.pages_per_seq:
            raise ValueError(
                f"{n_tokens} tokens need {need} pages > pages_per_seq ({self.pages_per_seq})"
            )
        new = []
        for i in range(have, need):
            page = self._take_free()
            self.tables[slot, i] = page
            new.append(page)
        self.allocated[slot] = need
        return np.asarray(new, np.int32)

    def release(self, slot: int) -> None:
        for i in range(int(self.allocated[slot])):
            page = int(self.tables[slot, i])
            if page in self.page_hash:
                self.refs[page] -= 1
                if self.refs[page] == 0:
                    self.idle[page] = None  # evictable, newest last
            else:
                self.free.append(page)
        self.tables[slot] = 0
        self.lengths[slot] = 0
        self.allocated[slot] = 0

    # -- prefix cache ------------------------------------------------------

    def match_prefix(self, hashes: Sequence[bytes]) -> List[int]:
        """The longest cached run of ``hashes`` from the start, as page ids
        (takes no references: see :meth:`adopt`)."""
        pages: List[int] = []
        for h in hashes:
            page = self.cache.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def adopt(self, slot: int, pages: Sequence[int]) -> None:
        """Point the slot's first ``len(pages)`` table entries at shared
        pages (refcounted).  Must run before :meth:`allocate` for the slot."""
        if int(self.allocated[slot]):
            raise ValueError("adopt() requires an empty slot")
        for i, page in enumerate(pages):
            self.tables[slot, i] = page
            self.refs[page] = self.refs.get(page, 0) + 1
            self.idle.pop(page, None)  # back in use
        self.allocated[slot] = len(pages)

    def register(self, slot: int, hashes: Sequence[bytes]) -> None:
        """Publish the slot's first ``len(hashes)`` OWN pages under their
        content hashes (the first writer wins; adopted or registered pages
        are skipped).  The slot keeps using them; later prompts may adopt
        them, and they turn idle and evictable when every holder has
        released them."""
        for i, h in enumerate(hashes):
            page = int(self.tables[slot, i])
            if page in self.page_hash:  # adopted or already registered
                continue
            if h in self.cache:  # the same content published by another slot
                continue
            self.cache[h] = page
            self.page_hash[page] = h
            self.refs[page] = self.refs.get(page, 0) + 1
