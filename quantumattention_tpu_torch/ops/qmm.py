"""Weight-only quantized matrix products (counterpart of
quantumattention_tpu/ops/qmm.py).

``quantized_matmul`` is the wrapper of kernel K5 (w8a16, the port of the
Pallas ``_qmm_kernel``, qmm.py:49) and of its split-K schedule K6 (the port
of ``_qmm_kernel_ms``, qmm.py:70); ``quantized_matmul4`` wraps K7 (w4a16,
the port of ``_qmm4_kernel``, qmm.py:118).  A CPU tensor runs the kernel's
plain version (:func:`quantized_matmul_plain`, :func:`quantized_matmul4_plain`);
a CUDA tensor runs a kernel or raises.  Launches are counted in
``quantized_matmul.launches`` (K5), ``quantized_matmul.splitk_launches``
(K6) and ``quantized_matmul4.launches`` (K7).

Routes on the card, fixed in code:

* bf16 rows, K5, K6 and K7 alike: the register-A, swap-AB wgmma kernel of
  ``csrc/qgemm.cu`` (:func:`qgemm_schedule` is its persistent schedule,
  :func:`qgemm_column` the permutation of the weight columns over its
  fragments);
* float32 rows (K5, K6 and K7 alike): fp32 FMAs on the CUDA cores
  (``csrc/qmm.cu``), float32 out, as JAX returns x's type.

Layouts are the JAX package's (``models/quantized``): x (M, K) float; int8
w (K, N) with fp32 per-column scales (1, N) or (N,); packed int4 w4
(K/2, N) (split halves within 256-row blocks) with fp32 group scales
(K/128, N).  Numerics as in JAX: int8 converts to x.dtype exactly, the
fp32 sum is scaled per column, then cast once; an int4 nibble times its
fp32 group scale is rounded to x.dtype before the product (qmm.py:99-115),
with no epilogue scale.

K6 is K5's product with the K range split and the parts summed in a fixed
order.  On the card the split is stream-K's: a product of up to 128 rows
shares its (column tile, k-block) units out over the CTAs, so a tile's
k-blocks may fall to several CTAs, whose fp32 parts the tail product's
reduction kernel adds in CTA order (:meth:`QgemmSchedule.segments`), as for
K5 and K7.  (Summing them inside the same launch was slower at every decode
shape measured: PERF.md §6.)  A bf16 call counts as
K6 (``splitk_launches``) where the card's rule splits it, that is where
its 128-column tiles are fewer than the SMs at up to 128 rows (a decode
product of few column tiles, which would otherwise leave SMs idle), or
where the caller asks for ``n_streams`` > 1; the card's schedule may split
finer than ``n_streams``, which JAX's signature keeps.  The JAX auto rule
(qmm.py:231-253) balances TPU DMA streams against a VMEM budget and is not
carried over.  Float32 rows split their K range into ``qa_qmm_splits``
parts (an explicit ``n_streams`` is obeyed there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..utils import checks
from . import _native, quant


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
    128-row tile holds tile row r (low nibble) and 128 + r (high), the
    split-halves layout of ``quant.pack_int4`` in 256-row blocks."""
    r2, n = w4.shape
    return quant.unpack_int4(w4.reshape(r2 // 128, 128, n), torch.int32, axis=1).reshape(2 * r2, n)


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


def quantized_matmul4(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
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
    return _qmm_cuda(x, w4, scale, None, int4=True)


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


def check_activation(x: torch.Tensor, name: str,
                     dtypes=(torch.bfloat16, torch.float32)) -> None:
    """What a kernel takes of its activations: ``dtypes`` (K5-K7: bf16 or
    float32; K8 and K9: bf16), contiguous, 16-byte aligned."""
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} takes {names} activations on the card, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: activations must be contiguous and 16-byte aligned")


#: Activation rows up to which the K5/K7 kernel runs stream-K, and the row
#: tile of its whole-tile mode above (csrc/common.cuh, kQgemmRows).
QGEMM_ROWS = 128
#: Weight columns and unpacked weight rows of a stream-K unit; whole tiles
#: are two such column tiles wide.
QGEMM_BN = 128
QGEMM_KB = 128
#: The SM count of the H100 SXM: the default of :func:`qgemm_schedule`.
H100_SMS = 132


class QgemmSchedule(NamedTuple):
    """The persistent schedule of the K5/K7 kernel (csrc/qgemm.cu).

    Stream-K (``whole`` False, up to 128 rows): units ``u = tile * kblocks
    + kblock`` over 128-column tiles; CTA c takes ``base`` units (one more
    when ``c < rem``) from ``c * base + min(c, rem)`` on, and sums each tile
    it touches into slot ``c + tile``.  Whole tiles (more rows): output
    tiles of 256 columns by 128 rows, tile ``i`` at row tile ``i %
    row_tiles`` and column tile ``i // row_tiles``; CTA c takes tiles c,
    c + ctas, ...  ``width`` is the wgmma N of the activation rows."""

    whole: bool
    width: int
    row_tiles: int
    col_tiles: int
    kblocks: int
    ctas: int
    base: int
    rem: int

    @property
    def units(self) -> int:
        return self.row_tiles * self.col_tiles * self.kblocks

    def cta_units(self, c: int) -> int:
        """The number of units CTA c runs."""
        if self.whole:
            return ((self.row_tiles * self.col_tiles - 1 - c) // self.ctas + 1) * self.kblocks
        return self._start(c + 1) - self._start(c)

    def _start(self, c: int) -> int:
        return c * self.base + min(c, self.rem)

    def unit(self, c: int, i: int):
        """(col0, row0, kb, seg) of CTA c's i-th unit, as the kernel's
        ``unit_of``: its weight columns from col0, activation rows from row0,
        k-block kb, and the output tile seg its sums go to."""
        if self.whole:
            tile = c + (i // self.kblocks) * self.ctas
            return ((tile // self.row_tiles) * 2 * QGEMM_BN, (tile % self.row_tiles) * QGEMM_ROWS,
                    i % self.kblocks, tile)
        u = self._start(c) + i
        t = u // self.kblocks
        return t * QGEMM_BN, 0, u - t * self.kblocks, t

    def segments(self):
        """Stream-K: (cta, tile, kb0, kb1, slot) of every (CTA, tile) pair,
        in CTA order: CTA c sums k-blocks [kb0, kb1) of the tile into slot
        c + tile."""
        out = []
        for c in range(self.ctas):
            for i in range(self.cta_units(c)):
                _, _, kb, t = self.unit(c, i)
                if out and out[-1][:2] == (c, t):
                    out[-1] = (c, t, out[-1][2], kb + 1, c + t)
                else:
                    out.append((c, t, kb, kb + 1, c + t))
        return out

    def partial_floats(self, m: int) -> int:
        """fp32 entries of the stream-K partial sums: (ctas + tiles) slots of
        (m, 128); none for whole tiles."""
        return 0 if self.whole else (self.ctas + self.col_tiles) * m * QGEMM_BN


def qgemm_ctas_per_sm(width: int, whole: bool) -> int:
    """CTAs an SM of the K5/K7 kernel: four at widths up to 32 (more
    warpgroups hide the conversion's latencies), two at 64 and 128, one
    with whole tiles (two consumer warpgroups)."""
    return 1 if whole else 4 if width <= 32 else 2


@functools.lru_cache(maxsize=None)
def qgemm_schedule(m: int, n: int, k: int, sms: int = H100_SMS) -> QgemmSchedule:
    """The K5/K7 kernel's schedule of an (m, k) @ (k, n) product on a card
    of ``sms`` SMs (int8 or int4 alike: a k-block is 128 rows of either)."""
    if m < 1 or n % QGEMM_BN or k % QGEMM_KB:
        raise ValueError(f"the K5/K7 kernel needs M >= 1 and N, K % 128 == 0, got {m}, {n}, {k}")
    kblocks = k // QGEMM_KB
    width = min(QGEMM_ROWS, max(8, 1 << (m - 1).bit_length()))
    if m > QGEMM_ROWS:
        rows, cols = -(-m // QGEMM_ROWS), -(-n // (2 * QGEMM_BN))
        return QgemmSchedule(True, width, rows, cols, kblocks, max(1, min(sms, rows * cols)), 0, 0)
    tiles = n // QGEMM_BN
    units = tiles * kblocks
    ctas = max(1, min(qgemm_ctas_per_sm(width, False) * sms, units))
    return QgemmSchedule(False, width, 1, tiles, kblocks, ctas, units // ctas, units % ctas)


def qgemm_column(mt: int, r: int) -> int:
    """The weight column (of a consumer warpgroup's 128) that row r of m64
    tile mt of the K5/K7 product holds (``qa::qgemm_column``): thread (warp
    w, lane 4g + t) holds rows 16w + g and 16w + g + 8 of both tiles, the
    four neighbouring columns 4(8w + g) .. + 3, so one 32-bit shared load
    feeds all four of its fragments."""
    return 4 * (8 * (r >> 4) + (r & 7)) + 2 * mt + ((r >> 3) & 1)


def card_qgemm_schedule(m: int, n: int, k: int) -> QgemmSchedule:
    """The schedule the K5/K7 kernel computes on the current card
    (``qa_qgemm_schedule``), for holding against :func:`qgemm_schedule`."""
    out = (ctypes.c_int * 7)()
    width = _native.library().qa_qgemm_schedule(m, n, k, out)
    whole, rows, cols, kblocks, ctas, base, rem = list(out)
    return QgemmSchedule(bool(whole), width, rows, cols, kblocks, ctas, base, rem)


def card_qgemm_columns():
    """The column permutation of the kernel (``qa_qgemm_columns``): entry
    64 mt + r is :func:`qgemm_column` (mt, r) as the card computes it."""
    out = (ctypes.c_int * 128)()
    _native.library().qa_qgemm_columns(out)
    return list(out)


def is_split_k(m: int, n: int, n_streams: Optional[int], sms: int = H100_SMS) -> bool:
    """Whether a bf16 call is K6 (see the module docstring): an explicit
    ``n_streams`` > 1, or the card's rule (up to 128 rows, fewer 128-column
    tiles than SMs)."""
    if n_streams is not None:
        return n_streams > 1
    return m <= QGEMM_ROWS and n // QGEMM_BN < sms


#: Launches by route, beside the per-kernel counts: "wgmma" (csrc/qgemm.cu)
#: and "f32" (float32 rows, csrc/qmm.cu), so that a run can show which
#: kernel served K5, K6 and K7.
route_launches = {"wgmma": 0, "f32": 0}


def _count(int4: bool, k6: bool, route: str) -> None:
    route_launches[route] += 1
    if int4:
        quantized_matmul4.launches += 1
    elif k6:
        quantized_matmul.splitk_launches += 1
    else:
        quantized_matmul.launches += 1


def _qmm_cuda(x, w, scale, n_streams, *, int4: bool):
    """Check what K5/K6/K7 take, launch on the current stream (see the
    module docstring for the routes)."""
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
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = _native.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if x.dtype == torch.float32:
        splits = 1 if int4 else lib.qa_qmm_splits(m, n, k, n_streams or 0)
        partial = torch.empty((splits * m * n,), dtype=torch.float32, device=x.device) if splits > 1 else None
        err = lib.qa_qmm_f32(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                             ptr(partial), m, n, k, int(int4), splits, stream)
        _native.check(err, "qa_qmm_f32")
        _count(int4, splits > 1, "f32")
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    k6 = not int4 and is_split_k(m, n, n_streams, sms)
    floats = lib.qa_qgemm_workspace(m, n, k)
    partial = torch.empty((floats,), dtype=torch.float32, device=x.device) if floats else None
    err = lib.qa_qgemm(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), ptr(partial),
                       m, n, k, int(int4), stream)
    _native.check(err, "qa_qgemm")
    _count(int4, k6, "wgmma")
    return out
