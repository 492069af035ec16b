"""Fused GQA decode attention over a ragged KV cache (counterpart of
quantumattention_tpu/ops/decode.py).

``decode_attention`` is the wrapper of kernel K4 (``csrc/decode.cu``, the
port of the Pallas ``_decode_kernel``, decode.py:56).  A CPU tensor runs the
kernel's plain version, :func:`decode_attention_plain`; a CUDA tensor runs
the kernel or raises.  ``decode_attention.launches`` counts launches.

Covered: (B, Hq, D) bf16 queries, an int8 cache with token-wise fp32 scales
or a bf16 cache, ragged lengths including 0 (zero output rows), GQA, bf16
output.  Not yet (ROADMAP queue 1, items 12a-c): the 4-D multi-query q of
speculative verification, packed int4 caches, ``window``, and the
``decode_int8_qk``/``decode_int8_pv`` variants.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import checks
from . import _native
from .sdpa import DEFAULT_MASK_VALUE

LOG2E = math.log2(math.e)


def decode_attention_plain(
    q, k_cache, v_cache, lengths, k_scale=None, v_scale=None, sm_scale=None
) -> torch.Tensor:
    """K4's plain version in fp32: dequantize, mask rows >= lengths[b],
    exp2 softmax with sm_scale * log2(e) folded into the scores, the
    unnormalized P (times the V scale) rounded to bf16 as the kernel does,
    P.V divided by the softmax sum, zeros for empty slots."""
    batch, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(batch, hkv, group, d)
    k = k_cache.float()
    v = v_cache.float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k) * (sm_scale * LOG2E)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    valid = torch.arange(s_max, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], DEFAULT_MASK_VALUE)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) / l
    o = torch.where((lengths.to(q.device) > 0)[:, None, None, None], o, 0.0)
    return o.reshape(batch, hq, d).to(torch.bfloat16)


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
    """Single-step GQA decode attention; returns (B, Hq, D) in bf16.

    q (B, Hq, D) bf16; k_cache/v_cache (B, Hkv, Smax, D) int8 with
    ``k_scale``/``v_scale`` (B, Hkv, Smax) fp32, or bf16 without scales;
    lengths (B,) int32 valid rows per slot (0 = empty slot, zero output).
    """
    if window is not None:
        raise NotImplementedError(
            "decode_attention: sliding windows are not ported yet "
            "(ROADMAP queue 1, item 12c)"
        )
    if q.ndim != 3:
        raise NotImplementedError(
            "decode_attention: only (B, Hq, D) queries; the multi-query "
            "verify mode is not ported yet (ROADMAP queue 1, item 12b)"
        )
    batch, hq, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k_cache and v_cache must be equal (B, Hkv, Smax, D)")
    _, hkv, s_max, cache_dim = k_cache.shape
    if cache_dim * 2 == d:
        raise NotImplementedError(
            "decode_attention: packed int4 caches are not ported yet "
            "(ROADMAP queue 1, item 12a)"
        )
    if cache_dim != d or k_cache.shape[0] != batch:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if hq % hkv != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    quantized = k_scale is not None
    if k_cache.dtype == torch.int8 and not quantized:
        raise ValueError("8-bit KV cache requires k_scale/v_scale")
    if k_cache.dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(f"decode_attention: {k_cache.dtype} caches are not ported yet")
    if quantized and (k_scale.shape != (batch, hkv, s_max) or v_scale.shape != k_scale.shape):
        raise ValueError("k_scale/v_scale must be (B, Hkv, Smax)")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention expects bf16 queries, got {q.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, k_scale, v_scale, sm_scale)
    return _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale, sm_scale)


decode_attention.launches = 0


def _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale, sm_scale):
    """Check what the kernel takes, launch it on the current stream."""
    checks.require_hopper(q.device)
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
    batch, hq, d = q.shape
    _, hkv, s_max, _ = k_cache.shape
    if d % 4:
        raise ValueError(f"K4 needs head_dim % 4 == 0, got {d}")
    lib = _native.library()
    nsplit = lib.qa_decode_num_splits(s_max)
    out = torch.empty((batch, hq, d), dtype=torch.bfloat16, device=q.device)
    group = hq // hkv
    part_acc = torch.empty((batch, hkv, nsplit, group, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((batch, hkv, nsplit, group, 2), dtype=torch.float32, device=q.device)
    err = lib.qa_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), batch, hq, hkv, s_max, d,
        _native.dtype_code(k_cache.dtype), float(sm_scale * LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "qa_decode")
    decode_attention.launches += 1
    return out
