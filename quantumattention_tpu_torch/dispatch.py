"""Dispatch, validation and in-graph quantization (counterpart of
quantumattention_tpu/dispatch.py).

Validation returns ``(ok, reason)`` with the JAX package's reason strings
(dispatch.py:52-196); ``can_use_attention`` brackets them by backend
(``[cuda: ...]``).  Float inputs to ``fp8_attention`` are quantized here,
then run through the flash kernel.  The 8-bit container is always e4m3:
the int8 choice of the JAX package (dispatch.py:474-478) is a TPU MXU gate.

Gradients: float inputs to ``attention`` go through
``ops/autodiff.attention_with_vjp`` (K1 forward, K2/K3 backward), and the
float path of ``fp8_attention`` through a straight-through Function
(``_Fp8Attention``, dispatch.py:501-548): its backward is the gradient of
exact bf16 attention at the float inputs.  Pre-quantized inputs are
forward-only, as in JAX.  ``window = (left, right)`` (sliding windows) runs
through every entry point, the kernels' and the fallback's, with JAX's
validation (dispatch.py:103-104).

``scaling_method="per-block"`` quantizes float Q and K per block of rows
(``flash_attention(fused_block_quant=True)``: the quantizer kernel, then
K1), with the same straight-through backward.  ``"auto"`` picks, once per
shape class, the fastest of bf16 K1 (``"none"``), head-wise e4m3,
per-block e4m3 and SDPA (``"sdpa"``) by a timed sweep whose winner the
autotuner caches on disk (``autotune.py``; JAX dispatch.py:365-454).  With
``config.kernel.autotune`` off, on CPU tensors or while a graph is captured,
a miss takes ``"per-block"`` untimed.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from . import autotune, config
from .ops import quant
from .ops.autodiff import attention_with_vjp, exact_attention_bwd, needs_grad
from .ops.flash import flash_attention
from .ops.sdpa import sdpa_reference
from .utils import checks, shapes

#: The head dims JAX names; any other multiple of 8 up to 512 is taken too.
SUPPORTED_HEAD_DIMS = shapes.SUPPORTED_HEAD_DIMS

_FLOAT_QK_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_FP8_QK_DTYPES = (torch.float8_e4m3fn,)


def _dtype_ok_qk(dtype) -> bool:
    return dtype in _FLOAT_QK_DTYPES or dtype in _FP8_QK_DTYPES or dtype == torch.int8


def validate_flash_input(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Any = None,
    scale_k: Any = None,
    scaling_method: Optional[str] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> Tuple[bool, str]:
    """Shape/dtype/feature validation for the fused kernel; ``(ok, reason)``.

    Takes what the JAX package takes: head dims 64/128/256 and any other
    multiple of 8 up to 512 (the kernels round them up to an instantiated
    width with zero columns), and fp32 Q/K/V, which K1 reads rounded to bf16
    and returns in fp32.
    """
    if attn_mask is not None:
        return False, "attn_mask is not supported by the fused kernel"
    if dropout_p != 0.0:
        return False, "dropout is not supported by the fused kernel"
    for name, t in (("query", query), ("key", key), ("value", value)):
        if t.ndim != 4:
            return False, f"{name} must be 4-D (B, H, S, D), got {t.ndim}-D"
    b_q, h_q, s_q, d_q = query.shape
    b_k, h_k, s_k, d_k = key.shape
    b_v, h_v, s_v, d_v = value.shape
    if not (b_q == b_k == b_v):
        return False, f"batch mismatch: {b_q}, {b_k}, {b_v}"
    if h_k != h_v:
        return False, f"key/value head mismatch: {h_k} vs {h_v}"
    if h_q % h_k != 0:
        return False, (
            f"num query heads ({h_q}) must be a multiple of kv heads ({h_k})"
        )
    if s_k != s_v:
        return False, f"key/value length mismatch: {s_k} vs {s_v}"
    if d_q != d_k:
        return False, f"query/key head_dim mismatch: {d_q} vs {d_k}"
    if d_q != d_v:
        return False, f"query/value head_dim mismatch: {d_q} vs {d_v}"
    if not shapes.head_dim_supported(d_q):
        return False, shapes.head_dim_reason(d_q)
    if is_causal and window is not None and window[1] not in (None, 0):
        return False, "is_causal with a right window extent is contradictory"
    if not _dtype_ok_qk(query.dtype):
        return False, f"query dtype {query.dtype} unsupported"
    if not _dtype_ok_qk(key.dtype):
        return False, f"key dtype {key.dtype} unsupported"
    if not (value.dtype in _FLOAT_QK_DTYPES or value.dtype in _FP8_QK_DTYPES):
        return False, f"value dtype {value.dtype} unsupported"

    has_scales = scale_q is not None or scale_k is not None
    if (scale_q is None) != (scale_k is None):
        return False, "scale_q and scale_k must be provided together"
    if checks.is_8bit_dtype(query.dtype) or checks.is_8bit_dtype(key.dtype):
        if query.dtype == torch.int8 and not has_scales:
            return False, "int8 query/key require scale_q/scale_k"
    if has_scales:
        if scale_q.ndim not in (2, 3):
            return False, (
                "scales must be head-wise (B, H) or token-wise (B, H, S), "
                f"got rank {scale_q.ndim}"
            )
        if scale_q.ndim != scale_k.ndim:
            return False, "scale_q/scale_k rank mismatch"
        expected = {"head-wise": 2, "token-wise": 3}.get(scaling_method)
        if expected is not None and scale_q.ndim != expected:
            return False, (
                f"scaling_method={scaling_method!r} expects rank-{expected} "
                f"scales, got rank {scale_q.ndim}"
            )
        if tuple(scale_q.shape[:2]) != (b_q, h_q):
            return False, (
                f"scale_q leading dims {tuple(scale_q.shape[:2])} != (B, Hq) "
                f"({b_q}, {h_q})"
            )
        if tuple(scale_k.shape[:2]) != (b_k, h_k):
            return False, (
                f"scale_k leading dims {tuple(scale_k.shape[:2])} != (B, Hkv) "
                f"({b_k}, {h_k})"
            )
        if scale_q.ndim == 3 and (
            scale_q.shape[2] != s_q or scale_k.shape[2] != s_k
        ):
            return False, "token-wise scale length mismatch"
    return True, ""


def can_use_attention(
    query: Any,
    key: Any,
    value: Any,
    attn_mask: Any = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    *,
    scale: Optional[float] = None,
    scale_q: Any = None,
    scale_k: Any = None,
    scaling_method: Optional[str] = None,
    window=None,
) -> Tuple[bool, str]:
    """Aggregate capability check with self-explaining reason strings."""
    if config.attention.skip_supported_check:
        return True, ""
    if config.attention.force_fallback:
        return False, "[cuda: disabled by config.attention.force_fallback]"
    if not config.attention.enable_cuda_kernel:
        return False, "[cuda: disabled by config.attention.enable_cuda_kernel]"
    ok, reason = validate_flash_input(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method=scaling_method, window=window,
    )
    return (True, "") if ok else (False, f"[cuda: {reason}]")


def attention(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None, window=None,
    q_segment_ids=None, kv_segment_ids=None, block_mask=None,
):
    """bf16/fp16 fused attention dispatch; raises ``ValueError`` with the
    aggregated reason when the fused kernel cannot serve the inputs.
    Segment ids and ``block_mask`` go to the raw kernel, forward-only (JAX
    dispatch.py:224-238): with inputs that require grad they raise rather
    than return an output cut from the graph."""
    supported, reason = can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal, scale=scale, window=window
    )
    if not supported:
        raise ValueError(f"attention is not supported for the input: {reason}")
    masks = q_segment_ids is not None or kv_segment_ids is not None or block_mask is not None
    if masks and needs_grad(query, key, value):
        raise ValueError(
            "attention with segment ids or a block mask is forward-only: "
            "its inputs must not require grad"
        )
    if masks or checks.is_8bit_dtype(query.dtype) or checks.is_8bit_dtype(key.dtype):
        # Pre-quantized operands are not differentiable: the raw kernel.
        return flash_attention(
            query, key, value, is_causal=is_causal, sm_scale=scale, window=window,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, block_mask=block_mask,
        )
    return attention_with_vjp(query, key, value, is_causal=is_causal, sm_scale=scale, window=window)


def _quantize_for(t, scaling_method: str):
    """Dynamic e4m3 quantization at the requested granularity."""
    if scaling_method == "head-wise":
        return quant.quantize_head_wise(t, torch.float8_e4m3fn)
    if scaling_method == "token-wise":
        return quant.quantize_token_wise(t, torch.float8_e4m3fn)
    raise ValueError(f"unknown scaling_method: {scaling_method!r}")


class _Fp8Attention(torch.autograd.Function):
    """Quantize-in-graph fp8 forward with a straight-through backward.

    The forward quantizes q and k to e4m3 (head-wise, token-wise, or per
    block on the quantizer kernel) and runs K1, saving only the float
    (q, k, v).  The backward recomputes the bf16 forward with its
    residuals (K1) and runs K2/K3: the gradient of exact attention at the
    float inputs, the standard STE treatment of the quantization casts."""

    @staticmethod
    def forward(ctx, query, key, value, scaling_method, is_causal, scale, window):
        ctx.is_causal, ctx.scale, ctx.window = is_causal, scale, window
        ctx.save_for_backward(query, key, value)
        return _fp8_forward(query, key, value, scaling_method, is_causal, scale, window)

    @staticmethod
    def backward(ctx, grad_out):
        grads = exact_attention_bwd(*ctx.saved_tensors, grad_out, ctx.is_causal, ctx.scale,
                                    ctx.window)
        return (*grads, None, None, None, None)


def _fp8_forward(query, key, value, scaling_method, is_causal, scale, window=None):
    if scaling_method == "per-block":
        # Per-(batch, head, block) e4m3 scales computed by the quantizer
        # kernel (BASELINE config 2; JAX quantizes inside its kernel).
        return flash_attention(query, key, value, fused_block_quant=True, is_causal=is_causal,
                               sm_scale=scale, window=window)
    q8, scale_q = _quantize_for(query, scaling_method)
    k8, scale_k = _quantize_for(key, scaling_method)
    return flash_attention(
        q8, k8, value, scale_q=scale_q, scale_k=scale_k,
        is_causal=is_causal, sm_scale=scale, window=window,
    )


def fp8_attention(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    scale_q=None, scale_k=None, scaling_method: Optional[str] = None,
    window=None,
):
    """FP8 fused attention dispatch.

    Float Q/K are quantized here to e4m3 at ``scaling_method`` granularity
    (default head-wise; "token-wise"; "per-block", per block of rows on the
    card; "auto", the tuned fastest path), with straight-through gradients;
    pre-quantized inputs come with their scales and are forward-only.
    """
    if scaling_method is None:
        scaling_method = "head-wise"
    if scaling_method not in ("head-wise", "token-wise", "per-block", "auto"):
        raise ValueError(f"unknown scaling_method: {scaling_method!r}")
    if (scale_q is None) != (scale_k is None):
        raise ValueError("scale_q and scale_k must be provided together")

    if scaling_method == "auto":
        if scale_q is not None:
            raise ValueError(
                "scaling_method='auto' tunes the quantization path; "
                "do not pass scale_q/scale_k"
            )
        if checks.is_8bit_dtype(query.dtype) or checks.is_8bit_dtype(key.dtype):
            raise ValueError("scaling_method='auto' expects float q/k")
        scaling_method = _tuned_path(query, key, value, is_causal, scale, window)
        if scaling_method == "none":
            return attention(
                query, key, value, attn_mask, dropout_p, is_causal, scale=scale, window=window
            )
        if scaling_method == "sdpa":
            return sdpa_fallback(
                query, key, value, attn_mask, dropout_p, is_causal, scale=scale, window=window
            )

    if scaling_method == "per-block" and scale_q is not None:
        raise ValueError("per-block scaling quantizes in-kernel; "
                         "do not pass scale_q/scale_k")

    if scale_q is None and not checks.is_8bit_dtype(query.dtype):
        supported, reason = can_use_attention(
            query, key, value, attn_mask, dropout_p, is_causal, scale=scale, window=window
        )
        if not supported:
            raise ValueError(
                f"fp8_attention is not supported for the input: {reason}"
            )
        if not needs_grad(query, key, value):
            return _fp8_forward(query, key, value, scaling_method, is_causal, scale, window)
        return _Fp8Attention.apply(query, key, value, scaling_method, is_causal, scale, window)

    supported, reason = can_use_attention(
        query, key, value, attn_mask, dropout_p, is_causal,
        scale=scale, scale_q=scale_q, scale_k=scale_k,
        scaling_method=scaling_method, window=window,
    )
    if not supported:
        raise ValueError(f"fp8_attention is not supported for the input: {reason}")
    return flash_attention(
        query, key, value, scale_q=scale_q, scale_k=scale_k,
        is_causal=is_causal, sm_scale=scale, window=window,
    )


#: The "auto" path's candidates, in JAX's order (dispatch.py:438).
AUTO_PATHS = ("none", "head-wise", "per-block", "sdpa")


def _tuned_path(query, key, value, is_causal, scale, window) -> str:
    """The "auto" path for this shape class (JAX dispatch.py:365-410): the
    cached winner, else a timed sweep where one is allowed
    (``autotune.sweep_allowed``), else ``"per-block"`` untimed."""
    batch, hq, q_len, head_dim = query.shape
    hkv, kv_len = key.shape[1], key.shape[2]
    pkey = autotune.shape_key("path", batch, hq, hkv, q_len, kv_len, head_dim, is_causal,
                              query.dtype, query.device)
    if window is not None:
        pkey += f"|w{window[0]}_{window[1]}"
    hit = autotune.lookup_value(pkey)
    if isinstance(hit, str):
        return hit
    default = "per-block"
    if not autotune.sweep_allowed(query.device):
        return default
    return _sweep_paths(query, key, value, is_causal, scale, window, pkey)


def sdpa_prune_reason(query, key) -> Optional[str]:
    """Why the "sdpa" candidate is left out of a sweep, or None: its fp32
    (B, Hq, Sq, Skv) logits above a quarter of the card's free memory (an
    out-of-memory error inside a sweep leaves the allocator fragmented)."""
    b, hq, sq, _ = query.shape
    logits = 4 * b * hq * sq * key.shape[2]
    free = torch.cuda.mem_get_info(query.device)[0]
    if logits > free / 4:
        return f"fp32 logits {logits} B > a quarter of the free {free} B"
    return None


def _sweep_paths(query, key, value, is_causal, scale, window, pkey) -> str:
    """Time each path on these inputs (forward only) and cache the fastest
    (JAX dispatch.py:413-454).  Each kernel path tunes its K1 tile
    configuration first (``autotune.tuning``).  Unlike JAX's sweep, a
    kernel path that raises fails the call and records nothing: skipping it
    could crown ``"sdpa"`` and cache plain PyTorch for the shape class.
    Only ``"sdpa"`` itself is skipped, and only when it runs out of memory."""

    def runner(name):
        if name == "none":
            return lambda: flash_attention(query, key, value, is_causal=is_causal,
                                           sm_scale=scale, window=window)
        if name == "sdpa":
            return lambda: sdpa_reference(query, key, value, is_causal=is_causal, scale=scale,
                                          window=window, out_dtype=value.dtype)
        return lambda: _fp8_forward(query, key, value, name, is_causal, scale, window)

    pruned = sdpa_prune_reason(query, key)
    paths = [p for p in AUTO_PATHS if not (p == "sdpa" and pruned)]
    with torch.no_grad(), autotune.tuning():
        best = autotune.tune(pkey, paths, runner, query.device, skippable=_sdpa_out_of_memory)
    if pruned:
        autotune.last_sweeps.setdefault(pkey, {})["sdpa"] = f"pruned: {pruned}"
    return best


def _sdpa_out_of_memory(path: str, error: Exception) -> bool:
    if path == "sdpa" and isinstance(error, torch.cuda.OutOfMemoryError):
        torch.cuda.empty_cache()
        return True
    return False


def sdpa_fallback(
    query, key, value, attn_mask=None, dropout_p: float = 0.0,
    is_causal: bool = False, *, scale: Optional[float] = None,
    scale_q=None, scale_k=None, window=None,
    generator: Optional[torch.Generator] = None,
):
    """The always-correct PyTorch path.  ``sdpa_fallback.calls`` counts
    its uses, so a run can show that its attention took the kernel."""
    sdpa_fallback.calls += 1
    out_dtype = value.dtype
    if checks.is_8bit_dtype(out_dtype):
        out_dtype = torch.bfloat16
    return sdpa_reference(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, scale=scale, scale_q=scale_q, scale_k=scale_k,
        window=window, generator=generator, out_dtype=out_dtype,
    )


sdpa_fallback.calls = 0
