"""Quantized ragged KV cache for decode serving (counterpart of
quantumattention_tpu/serving/kv_cache.py).

  k / v:            (num_slots, Hkv, Smax, D)   int8 (default), e4m3, bf16,
                    float16 or float32;
                    (num_slots, Hkv, Smax, D/2) packed int4 (int8 container)
  k_scale/v_scale:  (num_slots, Hkv, Smax)      fp32 (8-bit caches only)
  lengths:          (num_slots,)                int32 valid lengths

Token-wise quantization (reduction over D).  Unlike the JAX package, whose
arrays are immutable, :func:`append` and :func:`free_slots` write the
cache's tensors IN PLACE (indexed assignment / slice copies) and return the
same object: a cache holds gigabytes at serving sizes, and a copy per
token would dominate the decode step.

A packed int4 cache (``int4=True``) holds element d in the low nibble and
element d + D/2 in the high nibble of byte d (``quant.pack_int4``); it is
recognised by its halved minor dim, as in JAX.  ``flush_side``
is not ported: it persists the TPU burst's side buffer, a workaround for
XLA copying a scatter that feeds a Pallas call (ROADMAP, "Do not port these
TPU workarounds"); the port's burst appends to the cache in place every
step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import quant
from ..utils import checks


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(
    num_slots: int, num_kv_heads: int, max_len: int, head_dim: int,
    dtype=torch.int8, int4: bool = False, device=None,
) -> KVCache:
    """An empty cache; 8-bit scales start at ones (kv_cache.py:76-78).
    ``int4=True`` stores packed 4-bit values, two an int8 byte (minor dim
    head_dim/2): half the int8 cache's bytes, about twice its rounding
    error.  On the CUDA card unless ``device`` says otherwise."""
    if int4:
        if dtype != torch.int8:
            raise ValueError("int4 cache uses an int8 container")
        if head_dim % 2 != 0:
            raise ValueError("int4 cache requires an even head_dim")
        head_dim //= 2
    device = checks.default_device(device)
    shape = (num_slots, num_kv_heads, max_len, head_dim)
    cache = KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
    )
    if checks.is_8bit_dtype(dtype):
        cache.k_scale = torch.ones(shape[:3], dtype=torch.float32, device=device)
        cache.v_scale = torch.ones(shape[:3], dtype=torch.float32, device=device)
    return cache


def quantize_tokens(t: torch.Tensor, dtype, int4: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., D) float -> (values, (...) scales or None) in the cache or
    container (kv_cache.py:83-94): int4 packed along D, int8 or e4m3
    token-wise, any other type a cast."""
    if not checks.is_8bit_dtype(dtype):
        return t.to(dtype), None
    if int4:
        return quant.dynamically_quantize_int4(t, reduction_dim=-1)
    if dtype == torch.int8:
        return quant.dynamically_quantize_int8(t, reduction_dim=-1)
    return quant.dynamically_quantize_fp8(t, reduction_dim=-1)


def append(
    cache: KVCache,
    slot_ids: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offsets: torch.Tensor,
    n_valid: Optional[torch.Tensor] = None,
) -> KVCache:
    """Write n_valid[i] new tokens for each slot and bump its length, in place.

    slot_ids (N,) distinct cache slots; k_new/v_new (N, Hkv, T, D) float
    tokens (T = 1 for decode, a padded prompt width for prefill, the T
    candidates of speculative verification); offsets (N,) write positions;
    n_valid (N,) how many of the T tokens are real, or None: all T
    (verification's block, ``_verify_impl``, backends.py:698-705).

    At T = 1, or with n_valid None, every row must lie below max_len (the
    engine decodes and verifies only with room for them): one indexed
    write per tensor, with no host synchronisation, and a row past max_len
    is an index error where the JAX package clamps the write.  A padded
    prefill (T > 1 with n_valid) writes slot by slot, all T rows clipped at
    max_len (rows past n_valid hold garbage that the lengths mask).
    """
    int4 = cache.k.shape[-1] * 2 == k_new.shape[-1]  # the packed layout
    kq, ks = quantize_tokens(k_new, cache.k.dtype, int4)
    vq, vs = quantize_tokens(v_new, cache.v.dtype, int4)
    t = k_new.shape[2]
    if t == 1 or n_valid is None:
        slots = slot_ids.to(torch.int64)[:, None]
        rows = offsets.to(torch.int64)[:, None]
        if t > 1:
            rows = rows + torch.arange(t, device=offsets.device)[None, :]
        # [slots, :, rows] indexes (N, T, Hkv, ...): the blocks' T axis first.
        cache.k[slots, :, rows] = kq.transpose(1, 2)
        cache.v[slots, :, rows] = vq.transpose(1, 2)
        if ks is not None:
            cache.k_scale[slots, :, rows] = ks.transpose(1, 2)
            cache.v_scale[slots, :, rows] = vs.transpose(1, 2)
    else:
        for i, (slot, off) in enumerate(zip(slot_ids.tolist(), offsets.tolist())):
            n = min(t, cache.max_len - off)
            cache.k[slot, :, off : off + n] = kq[i, :, :n]
            cache.v[slot, :, off : off + n] = vq[i, :, :n]
            if ks is not None:
                cache.k_scale[slot, :, off : off + n] = ks[i, :, :n]
                cache.v_scale[slot, :, off : off + n] = vs[i, :, :n]
    cache.lengths[slot_ids] = (offsets + (t if n_valid is None else n_valid)).to(torch.int32)
    return cache


def append_quantized_token(
    cache: KVCache,
    kq: torch.Tensor,
    ks: Optional[torch.Tensor],
    vq: torch.Tensor,
    vs: Optional[torch.Tensor],
    offsets: torch.Tensor,
    n_valid: torch.Tensor,
) -> KVCache:
    """Decode write of ONE already-quantized token per slot, in place: the
    T = 1 branch of :func:`append` for values the caller has quantized
    (the fused decode layer's step quantizes k and v once).

    kq/vq (B, Hkv, D) values in the cache container, ks/vs (B, Hkv) fp32
    token scales (None for a bf16 cache), offsets (B,) write rows, n_valid
    (B,) 0/1 length bumps.  A row must lie below max_len: the JAX package
    drops such a write, the indexed write here faults, and the engine's
    burst clamp keeps every slot's row in range."""
    slots = torch.arange(cache.k.shape[0], device=cache.k.device)
    rows = offsets.to(torch.int64)
    cache.k[slots, :, rows] = kq
    cache.v[slots, :, rows] = vq
    if ks is not None:
        cache.k_scale[slots, :, rows] = ks
        cache.v_scale[slots, :, rows] = vs
    cache.lengths.copy_(offsets + n_valid)
    return cache


def free_slots(cache: KVCache, slot_ids: torch.Tensor) -> KVCache:
    """Mark slots empty (lengths 0), in place; data is overwritten later."""
    cache.lengths[slot_ids] = 0
    return cache
