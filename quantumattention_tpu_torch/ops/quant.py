"""Dynamic quantization for attention operands (counterpart of
quantumattention_tpu/ops/quant.py).

The math is identical to the JAX package (quant.py:45-55)::

    scale = max(amax(|t|, dims) / qmax, eps)
    t_q   = cast(clamp(t / scale, -qmax, qmax), qdtype)   # int8: round first

The clamp stays before the cast: PyTorch's e4m3 cast saturates where
ml_dtypes' does not, and the clamp makes both give the same values.  int8
rounds half-to-even (``torch.round``, like ``jnp.round``) before the cast.

Granularities:
  * head-wise:  reduce over [-2, -1]  -> scale shape (B, H)
  * token-wise: reduce over [-1]      -> scale shape (B, H, S)

int4 (quant.py:76-136): values in [-7, 7] (qmax 7) in an int8 container,
packed two a byte in the split-halves layout along an axis of even extent
n: element i is the LOW nibble and element i + n/2 the HIGH nibble of byte
i.  This is the one definition of that layout in the package: the KV
caches pack along the head dim (slots) or the page's token axis (pages),
and ``models/quantized`` packs weight rows in 256-row blocks with it.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

#: Max representable magnitude of float8_e4m3fn.
FP8_E4M3_MAX = 448.0
INT8_MAX = 127.0
INT4_MAX = 7.0

#: Scale clamp floor: fp32 machine epsilon, as in the JAX package.
SCALE_EPS = float(torch.finfo(torch.float32).eps)

_Dims = Union[int, Sequence[int]]


def _normalize_dims(reduction_dim: _Dims) -> Tuple[int, ...]:
    if isinstance(reduction_dim, int):
        return (reduction_dim,)
    return tuple(reduction_dim)


def _dynamic_quantize(
    t: torch.Tensor, reduction_dim: _Dims, qmax: float, qdtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    dims = _normalize_dims(reduction_dim)
    tf = t.float()
    amax = torch.amax(tf.abs(), dim=dims, keepdim=True)
    scale = torch.clamp(amax / qmax, min=SCALE_EPS)
    t_scaled = torch.clamp(tf / scale, -qmax, qmax)
    if not qdtype.is_floating_point:
        t_scaled = torch.round(t_scaled)
    t_q = t_scaled.to(qdtype)
    for d in sorted((d % t.ndim for d in dims), reverse=True):
        scale = scale.squeeze(d)
    return t_q, scale


def dynamically_quantize_fp8(
    t: torch.Tensor, *, reduction_dim: _Dims = -1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize to float8_e4m3fn with dynamic fp32 scales."""
    return _dynamic_quantize(t, reduction_dim, FP8_E4M3_MAX, torch.float8_e4m3fn)


def dynamically_quantize_int8(
    t: torch.Tensor, *, reduction_dim: _Dims = -1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize to int8 with dynamic fp32 scales (the KV-cache container)."""
    return _dynamic_quantize(t, reduction_dim, INT8_MAX, torch.int8)


def quantize_int4_values(
    t: torch.Tensor, *, reduction_dim: _Dims = -1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 quantization without packing: values in [-7, 7] in an int8
    container, and fp32 scales (amax / 7)."""
    return _dynamic_quantize(t, reduction_dim, INT4_MAX, torch.int8)


def pack_int4(values: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """int4-range values (int8 container) packed two a byte along ``axis``
    (even extent n) in the split-halves layout: element i -> low nibble,
    element i + n/2 -> high nibble of byte i.  Inverse: :func:`unpack_int4`."""
    axis = axis % values.ndim
    n = values.shape[axis]
    if n % 2 != 0:
        raise ValueError(f"axis {axis} must be even to pack int4, got {n}")
    lo, hi = values.to(torch.int32).split(n // 2, dim=axis)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, out_dtype=torch.int8, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` along ``axis``: (..., n/2, ...) int8 ->
    (..., n, ...) values in [-8, 7], the low nibbles first, then the high
    ones."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28  # sign-extends the low nibble
    hi = p >> 4           # the byte's sign is the high nibble's
    return torch.cat([lo, hi], dim=axis).to(out_dtype)


def dynamically_quantize_int4(
    t: torch.Tensor, *, reduction_dim: _Dims = -1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 with dynamic fp32 scales, packed along the reduced last axis
    (which must be even): (..., D) -> ((..., D/2) int8, (...) scales)."""
    dims = _normalize_dims(reduction_dim)
    if dims != (-1,) and dims != (t.ndim - 1,):
        raise ValueError("int4 packing requires reduction_dim == -1")
    q, scale = quantize_int4_values(t, reduction_dim=reduction_dim)
    return pack_int4(q), scale


def _qmax(qdtype) -> float:
    return FP8_E4M3_MAX if qdtype.is_floating_point else INT8_MAX


def quantize_head_wise(t: torch.Tensor, qdtype=torch.float8_e4m3fn):
    """(B, H, S, D) -> values + (B, H) scales."""
    return _dynamic_quantize(t, (-2, -1), _qmax(qdtype), qdtype)


def quantize_token_wise(t: torch.Tensor, qdtype=torch.float8_e4m3fn):
    """(B, H, S, D) -> values + (B, H, S) scales."""
    return _dynamic_quantize(t, (-1,), _qmax(qdtype), qdtype)


def dequantize(
    t_q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Inverse transform: the scale shape is a leading prefix of the
    tensor shape, and trailing axes are appended."""
    scale = scale.to(dtype)
    while scale.ndim < t_q.ndim:
        scale = scale[..., None]
    return t_q.to(dtype) * scale
