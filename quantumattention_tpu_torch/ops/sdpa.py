"""Reference scaled-dot-product attention (counterpart of
quantumattention_tpu/ops/sdpa.py).

Plain PyTorch in fp32.  It is at once the numerical definition of every
fused attention op (an fp8 op is dequantize-then-SDPA), the accuracy oracle
of the tests and of ``chip_smoke.py``, the plain version of the flash
kernel K1 (ops/flash.py), and the fallback of the ``*_with_fallback``
entry points.  It calls no fused PyTorch operator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: Large-negative logit used instead of -inf so fully-masked rows do not
#: produce NaNs through exp(-inf - (-inf)).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _dequantize(t: torch.Tensor, scale: Optional[torch.Tensor], dtype):
    t = t.to(dtype)
    if scale is not None:
        scale = scale.to(dtype)
        while scale.ndim < t.ndim:
            scale = scale[..., None]
        t = t * scale
    return t


def position_keep(
    q_len: int, kv_len: int, is_causal: bool, window: Optional[tuple],
    q_offset: int = 0, kv_offset: int = 0, device=None,
) -> Optional[torch.Tensor]:
    """(Sq, Skv) bool of the keys each query sees by position, or None
    when every query sees every key.  Query row i sits at global position
    ``q_offset + i``, key row j at ``kv_offset + j``; with ``is_causal``
    position p sees keys at p and below, and ``window = (left, right)``
    bounds them to [p - left, p + right] (``None`` an unbounded side)."""
    if not is_causal and (window is None or window == (None, None)):
        return None
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :] + kv_offset
    keep = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if is_causal:
        keep &= kv_pos <= q_pos
    if window is not None:
        left, right = window
        if left is not None:
            keep &= kv_pos >= q_pos - left
        if right is not None:
            keep &= kv_pos <= q_pos + right
    return keep


def segment_keep(q_segment_ids, kv_segment_ids) -> Optional[torch.Tensor]:
    """(B, 1, Sq, Skv) bool of the keys of each query's segment, or None
    when neither is given (JAX sdpa.py:114-118); raises when only one is."""
    if q_segment_ids is None and kv_segment_ids is None:
        return None
    if q_segment_ids is None or kv_segment_ids is None:
        raise ValueError("both q/kv segment ids must be provided")
    return (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None]


def sdpa_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Optional[torch.Tensor] = None,
    scale_k: Optional[torch.Tensor] = None,
    window: Optional[tuple] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
    out_dtype=None,
) -> torch.Tensor:
    """Unfused attention over (B, H, S, D) tensors.

    GQA when ``num_q_heads % num_kv_heads == 0`` (K/V heads repeated).
    Causal masking is top-left aligned: query i sees key j iff j <= i.
    ``scale_q``/``scale_k`` dequantize pre-quantized inputs first.
    ``window`` is ``(left, right)``: query i sees key j when
    ``i - left <= j <= i + right``, ``None`` an unbounded side (JAX
    sdpa.py:59-110).  ``q_segment_ids`` (B, Sq) and ``kv_segment_ids``
    (B, Skv), both or neither, keep the keys of each query's segment
    (packed documents).  ``dropout_p > 0`` draws its keep mask from
    ``generator``.
    """
    if out_dtype is None:
        out_dtype = value.dtype
    _, num_q_heads, q_len, head_dim = query.shape
    num_kv_heads, kv_len = key.shape[1], key.shape[2]
    if num_q_heads % num_kv_heads != 0:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be divisible by num_kv_heads "
            f"({num_kv_heads})"
        )
    q = _dequantize(query, scale_q, compute_dtype)
    k = _dequantize(key, scale_k, compute_dtype)
    v = value.to(compute_dtype)
    if num_kv_heads != num_q_heads:
        rep = num_q_heads // num_kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    sm_scale = 1.0 / math.sqrt(head_dim) if scale is None else scale
    logits = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    keep = position_keep(q_len, kv_len, is_causal, window, device=q.device)
    seg = segment_keep(q_segment_ids, kv_segment_ids)
    if seg is not None:
        keep = seg if keep is None else keep & seg
    if keep is not None:
        logits = logits.masked_fill(~keep, DEFAULT_MASK_VALUE)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, DEFAULT_MASK_VALUE)
        else:
            logits = logits + attn_mask.to(compute_dtype)
    weights = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(
            weights.shape, generator=generator, device=weights.device
        ) < (1.0 - dropout_p)
        weights = torch.where(keep, weights / (1.0 - dropout_p), 0.0)
    return torch.matmul(weights, v).to(out_dtype)
