"""Public functional API (counterpart of quantumattention_tpu/interface.py).

  attn_func / attn_func_with_fallback
  fp8_attn_func / fp8_attn_func_with_fallback
  fp8_token_wise_attn_func / fp8_token_wise_attn_func_with_fallback

The ``*_with_fallback`` variants run the fused kernel when
``can_use_attention`` accepts the inputs and the PyTorch SDPA reference
otherwise.  Float inputs are differentiable (dispatch.py: the backward
kernels K2/K3, straight-through for the fp8 quantization); pre-quantized
inputs are forward-only.  ``scaling_method`` takes "head-wise",
"token-wise", "per-block" and "auto" (``fp8_attn_func``).
``window = (left, right)`` is a sliding window:
query position i sees the keys at [i - left, i + right] (``None`` an
unbounded side; with ``is_causal`` a right extent other than 0 or None is
refused with JAX's reason), on the kernels and the fallback alike.
``attn_func`` also takes segment ids (packed documents) and ``block_mask``,
a (ceil(Sq/128), ceil(Skv/128)) bitmap of 128 x 128 granules
(splash-style block sparsity), forward-only, through K1 (ops/flash.py).
``attn_func_with_fallback`` keeps JAX's signature, which has neither.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import dispatch

__all__ = [
    "attn_func",
    "attn_func_with_fallback",
    "fp8_attn_func",
    "fp8_attn_func_with_fallback",
    "fp8_token_wise_attn_func",
    "fp8_token_wise_attn_func_with_fallback",
]


def attn_func(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    window=None, q_segment_ids=None, kv_segment_ids=None, block_mask=None,
):
    """Fused bf16/fp16 attention; raises ``ValueError`` when the fused
    kernel cannot serve the inputs.  ``q_segment_ids`` (B, Sq) and
    ``kv_segment_ids`` (B, Skv): a query sees only the keys of its segment;
    ``block_mask``: a (ceil(Sq/128), ceil(Skv/128)) bool or integer bitmap,
    a query seeing the keys of its row's active 128 x 128 granules.  With
    either the call is forward-only (inputs that require grad raise), and
    rows that see no key give zeros."""
    return dispatch.attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, window=window, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, block_mask=block_mask,
    )


def attn_func_with_fallback(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    window=None, generator: Optional[torch.Generator] = None,
):
    """``attn_func`` that degrades to the SDPA reference path."""
    supported, _ = dispatch.can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, window=window,
    )
    if supported:
        return attn_func(
            query, key, value, attn_mask, dropout_p, is_causal, scale=scale, window=window
        )
    return dispatch.sdpa_fallback(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, window=window, generator=generator,
    )


def fp8_attn_func(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    scale_q: Any = None, scale_k: Any = None,
    scaling_method: Optional[str] = None, window=None,
):
    """FP8 fused attention, head-wise scales by default.

    ``scaling_method``: "head-wise" (default), "token-wise", "per-block"
    (float Q and K quantized per block of rows: the quantizer kernel, then
    K1; JAX's in-kernel quantization), or "auto" (the fastest of bf16,
    head-wise, per-block and SDPA for the shape class, timed once and
    cached on disk: ``autotune.py``)."""
    return dispatch.fp8_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method=scaling_method, window=window,
    )


def fp8_attn_func_with_fallback(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    scale_q: Any = None, scale_k: Any = None,
    scaling_method: Optional[str] = None, window=None,
    generator: Optional[torch.Generator] = None,
):
    """``fp8_attn_func`` with graceful degradation.  The fallback
    dequantizes pre-quantized inputs, so it is correct for any scales."""
    if scaling_method is None:
        scaling_method = "head-wise"
    supported, _ = dispatch.can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method=scaling_method, window=window,
    )
    # Float inputs are quantized in dispatch.fp8_attention, which always gives
    # kernel-compatible scales: the float shapes are what must pass.
    if supported or (
        scale_q is None
        and dispatch.can_use_attention(
            query, key, value, attn_mask, dropout_p, is_causal, scale=scale, window=window
        )[0]
    ):
        return fp8_attn_func(
            query, key, value, attn_mask, dropout_p, is_causal,
            scale=scale, scale_q=scale_q, scale_k=scale_k,
            scaling_method=scaling_method, window=window,
        )
    return dispatch.sdpa_fallback(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k, window=window, generator=generator,
    )


def fp8_token_wise_attn_func(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    scale_q: Any = None, scale_k: Any = None, window=None,
):
    """FP8 attention pinned to token-wise scaling."""
    return fp8_attn_func(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method="token-wise", window=window,
    )


def fp8_token_wise_attn_func_with_fallback(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    scale_q: Any = None, scale_k: Any = None, window=None,
    generator: Optional[torch.Generator] = None,
):
    """Token-wise FP8 attention with graceful degradation."""
    return fp8_attn_func_with_fallback(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method="token-wise", window=window, generator=generator,
    )
