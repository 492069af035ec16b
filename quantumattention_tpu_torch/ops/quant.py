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
  * channel-wise: reduce over [-2]    -> scale shape (B, H, D) (V's, int8)
  * block-wise: blocks of ``block_rows`` rows from row 0 of (B, H, S, D)
    -> scale shape (B, H, ceil(S / block_rows)), by the formula of the JAX
    kernel's tile quantizer (flash.py:227-238), not the one above: no
    clamp, a floor of 1e-12, and ``x * (1 / s)`` (:func:`quantize_block_wise`).
    :func:`block_quant` is its kernel's wrapper (``csrc/block_quant.cu``).

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

from ..utils import checks, shapes
from . import _native

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


def quantize_channel_wise(t: torch.Tensor, qdtype=torch.int8):
    """(B, H, S, D) -> values + (B, H, D) scales, reduced over the
    sequence: V's scale for an 8-bit P.V (quant.py:150-160), which factors
    out of the sum over keys into one multiply of the output's columns."""
    return _dynamic_quantize(t, (-2,), _qmax(qdtype), qdtype)


def dequantize(
    t_q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32, axis: int = None
) -> torch.Tensor:
    """Inverse transform: the scale shape is a leading prefix of the
    tensor shape, and trailing axes are appended.  Scales whose reduced
    axis is interior (channel-wise (B, H, D)) name it in ``axis`` (-2
    there), where the scale is expanded."""
    scale = scale.to(dtype)
    if axis is not None:
        scale = scale.unsqueeze(axis)
    while scale.ndim < t_q.ndim:
        scale = scale[..., None]
    return t_q.to(dtype) * scale


#: The block scale's floor (flash.py:233): 1e-12, not SCALE_EPS.
BLOCK_SCALE_FLOOR = 1e-12


def quantize_block_wise(x: torch.Tensor, block_rows: int):
    """(B, H, S, D) float -> (e4m3 codes (B, H, S, D), fp32 scales
    (B, H, ceil(S / block_rows))), one scale per block of ``block_rows``
    rows counted from row 0 (rows past S count as zeros).  The JAX kernel's
    ``_quantize_tile`` exactly: ``s = max(amax(|x|) / 448, 1e-12)`` in fp32,
    then ``e4m3(x * (1 / s))``, one reciprocal, one product, one
    round-to-nearest cast (a value just above 448 rounds to 448)."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    b, h, s, d = x.shape
    nb = shapes.cdiv(s, block_rows)
    xf = x.float()
    absx = torch.nn.functional.pad(xf.abs(), (0, 0, 0, nb * block_rows - s))
    amax = absx.reshape(b, h, nb, block_rows * d).amax(dim=-1)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient.
    scale = torch.clamp(amax / amax.new_full((), FP8_E4M3_MAX), min=BLOCK_SCALE_FLOOR)
    inv = expand_block_scales(torch.reciprocal(scale), block_rows, s)
    return (xf * inv[..., None]).to(torch.float8_e4m3fn), scale


def expand_block_scales(scales: torch.Tensor, block_rows: int, length: int) -> torch.Tensor:
    """(B, H, nb) block scales -> (B, H, length) row scales."""
    return scales.repeat_interleave(block_rows, dim=-1)[..., :length]


def block_quant(x: torch.Tensor, block_rows: int):
    """The per-block quantizer's wrapper (``csrc/block_quant.cu``): (B, H,
    S, D) bf16, fp16 or fp32 -> (e4m3 codes (B, H, S, W), block scales (B,
    H, ceil(S / block_rows)), row scales (B, H, S)), with W = D rounded up to
    16 (zero columns: K1's row width for 8-bit Q/K).  Equal to
    :func:`quantize_block_wise` bit for bit.  A CPU tensor runs that plain
    version; a CUDA tensor the kernel, or raises.  ``block_quant.launches``
    counts the kernel's launches (an amax pass and a cast pass each)."""
    if x.ndim != 4:
        raise ValueError(f"block_quant takes (B, H, S, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"block_quant takes bf16, fp16 or fp32, got {x.dtype}")
    block_rows = int(block_rows)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    b, h, s, d = x.shape
    width = shapes.round_up(d, 16)
    if x.device.type == "cpu":
        codes, scales = quantize_block_wise(x, block_rows)
        if width != d:
            codes = torch.nn.functional.pad(codes.view(torch.uint8), (0, width - d)).view(codes.dtype)
        return codes, scales, expand_block_scales(scales, block_rows, s)
    checks.require_hopper(x.device)
    if d % 8 or b * h > 65535:
        raise ValueError(f"block_quant takes D a multiple of 8 and B * H <= 65535, got {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    nb = shapes.cdiv(s, block_rows)
    codes = torch.empty((b, h, s, width), dtype=torch.float8_e4m3fn, device=x.device)
    scales = torch.empty((b, h, nb), dtype=torch.float32, device=x.device)
    rows = torch.empty((b, h, s), dtype=torch.float32, device=x.device)
    lib = _native.library()
    partial = torch.empty(max(1, lib.qa_block_quant_partials(b * h, s, block_rows)),
                          dtype=torch.float32, device=x.device)
    code = _native.F32_OUT_CODE if x.dtype == torch.float32 else _native.dtype_code(x.dtype)
    err = lib.qa_block_quant(
        x.data_ptr(), partial.data_ptr(), codes.data_ptr(), scales.data_ptr(), rows.data_ptr(),
        b * h, s, d, width, code, block_rows, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "qa_block_quant")
    block_quant.launches += 1
    return codes, scales, rows


block_quant.launches = 0
