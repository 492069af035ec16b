"""Weight-only quantized matrix products (counterpart of
quantumattention_tpu/ops/qmm.py).

``quantized_matmul`` is the wrapper of kernel K5 (w8a16, ``csrc/qmm.cu``,
the port of the Pallas ``_qmm_kernel``, qmm.py:49) and of its split-K
schedule K6 (the port of ``_qmm_kernel_ms``, qmm.py:70);
``quantized_matmul4`` wraps K7 (w4a16, the port of ``_qmm4_kernel``,
qmm.py:118).  A CPU tensor runs the kernel's plain version
(:func:`quantized_matmul_plain`, :func:`quantized_matmul4_plain`); a CUDA
tensor runs the kernel or raises.  Launches are counted in
``quantized_matmul.launches`` (K5), ``quantized_matmul.splitk_launches``
(K6) and ``quantized_matmul4.launches`` (K7).

Layouts are the JAX package's (``models/quantized``): x (M, K) float; int8
w (K, N) with fp32 per-column scales (1, N) or (N,); packed int4 w4
(K/2, N) (split halves within 256-row blocks) with fp32 group scales
(K/128, N).  Numerics as in JAX: int8 converts to x.dtype exactly, the
fp32 sum is scaled per column, then cast once; an int4 nibble times its
fp32 group scale is rounded to x.dtype before the product (qmm.py:99-115),
with no epilogue scale.

The split-K rule is the card's own: split the K range over several CTAs
when the output tiles are fewer than the SMs (a decode-shaped product of
few column tiles would otherwise leave SMs idle).  The JAX auto rule
(qmm.py:231-253) balances TPU DMA streams against a VMEM budget and is not
carried over; an explicit ``n_streams`` is obeyed.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import checks
from . import _native


def supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Shape and dtype gate of the w8a16 kernel (qmm.py:178-188)."""
    if x.ndim != 2 or w.ndim != 2 or w.dtype != torch.int8:
        return False
    if x.dtype not in (torch.bfloat16, torch.float32):
        return False
    (_, k), (k2, n) = x.shape, w.shape
    return k == k2 and k % 128 == 0 and n % 128 == 0


def supported4(x: torch.Tensor, w4: torch.Tensor) -> bool:
    """Shape and dtype gate of the w4a16 kernel (qmm.py:311-320)."""
    if x.ndim != 2 or w4.ndim != 2 or w4.dtype != torch.int8:
        return False
    if x.dtype not in (torch.bfloat16, torch.float32):
        return False
    k = 2 * w4.shape[0]
    return x.shape[1] == k and k % 256 == 0 and w4.shape[1] % 128 == 0


def unpack_int4(w4: torch.Tensor) -> torch.Tensor:
    """(R/2, N) packed int4 -> (R, N) int32 nibble values, for any row
    extent that is a multiple of 128 packed rows: byte row r of each
    128-row tile holds tile row r (low nibble) and 128 + r (high)."""
    r2, n = w4.shape
    g = w4.to(torch.int32).reshape(r2 // 128, 128, n)
    lo = (g << 28) >> 28
    hi = g >> 4  # the byte's sign is the high nibble's
    return torch.cat([lo, hi], dim=1).reshape(2 * r2, n)


def dequantize_int4_tile(w4: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """(K/2, N) packed int4 + (K/128, N) fp32 group scales -> (K, N) in
    ``dtype``: each nibble times its group scale in fp32, rounded once
    (``dequant4_tile``, qmm.py:99-115)."""
    r2, n = w4.shape
    w = unpack_int4(w4).reshape(r2 // 64, 128, n).float()
    return (w * scale.float().reshape(r2 // 64, 1, n)).reshape(2 * r2, n).to(dtype)


def quantized_matmul_plain(x, w, scale, n_streams: int = 1) -> torch.Tensor:
    """K5's (and, with ``n_streams`` > 1, K6's) plain version in fp32:
    ``n_streams`` K-range partial products summed in order, times the
    per-column scale, cast once to x.dtype."""
    parts = zip(x.float().chunk(n_streams, dim=1), w.float().chunk(n_streams, dim=0))
    acc = sum(a @ b for a, b in parts)
    return (acc * scale.float().reshape(1, -1)).to(x.dtype)


def quantized_matmul4_plain(x, w4, scale) -> torch.Tensor:
    """K7's plain version: x @ (nibble * scale rounded to x.dtype), fp32
    accumulation, cast to x.dtype."""
    return (x.float() @ dequantize_int4_tile(w4, scale, x.dtype).float()).to(x.dtype)


def quantized_matmul(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
    n_streams: Optional[int] = None,
) -> torch.Tensor:
    """``(x @ w.to(x.dtype)) * scale``: x (M, K), int8 w (K, N), fp32 scale
    (1, N) or (N,) -> (M, N) in x.dtype.  ``n_streams``: the number of
    K ranges (split-K, K6); None lets the card's rule choose."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x (M,{k}) vs w ({k2},N)")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for N = {n}")
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, w, scale, n_streams or 1)
    return _qmm_cuda(x, w, scale.reshape(n), n_streams, int4=False)


quantized_matmul.launches = 0
quantized_matmul.splitk_launches = 0


def quantized_matmul4(
    x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor, *,
    n_streams: Optional[int] = None,
) -> torch.Tensor:
    """``x @ dequantize_int4({"q4": w4, "s": scale})``: x (M, K), packed
    w4 (K/2, N), fp32 group scales (K/128, N) -> (M, N) in x.dtype."""
    m, k = x.shape
    k2, n = w4.shape
    if k != 2 * k2:
        raise ValueError(f"contraction mismatch: x (M,{k}) vs packed w ({k2}*2,N)")
    if tuple(scale.shape) != (k // 128, n):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({k // 128}, {n})")
    if x.device.type == "cpu":
        return quantized_matmul4_plain(x, w4, scale)
    return _qmm_cuda(x, w4, scale, n_streams, int4=True)


quantized_matmul4.launches = 0


def check_weight(w: torch.Tensor, scale: torch.Tensor, device, name: str) -> None:
    """What the kernels take of a quantized matrix: int8 codes and fp32
    scales on ``device``, contiguous, the codes 16-byte aligned."""
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"{name}: int8 codes and float32 scales, got {w.dtype}/{scale.dtype}")
    for t in (w, scale):
        if t.device != device:
            raise ValueError(f"{name}: all operands must be on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: weights must be 16-byte aligned")


def check_activation(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"{name} takes bf16 activations on the card, got {x.dtype} "
            "(float32 runs only in the plain version, for the CPU tests)"
        )
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: activations must be contiguous and 16-byte aligned")


def _qmm_cuda(x, w, scale, n_streams, *, int4: bool):
    """Check what K5/K6/K7 take, launch on the current stream."""
    name = "K7" if int4 else "K5"
    checks.require_hopper(x.device)
    check_activation(x, name)
    check_weight(w, scale, x.device, name)
    ok = supported4(x, w) if int4 else supported(x, w)
    if not ok:
        raise ValueError(
            f"{name} needs K % {256 if int4 else 128} == 0 and N % 128 == 0, "
            f"got x {tuple(x.shape)}, w {tuple(w.shape)}"
        )
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    lib = _native.library()
    splits = lib.qa_qmm_splits(m, n, k, n_streams or 0)
    partial = (
        torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    err = lib.qa_qmm(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        m, n, k, int(int4), splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "qa_qmm")
    if int4:
        quantized_matmul4.launches += 1
    elif splits > 1:
        quantized_matmul.splitk_launches += 1
    else:
        quantized_matmul.launches += 1
    return out
