"""Fused quantized decoder-layer tail (counterpart of
quantumattention_tpu/ops/qmlp.py).

``fused_layer_tail`` is the wrapper of kernel K8 (``csrc/qmlp.cu`` over
``csrc/tail.cu``, the port of the Pallas ``_tail_kernel``, qmlp.py:93): one
C call that runs wo + residual + RMSNorm + SwiGLU MLP + residual and,
optionally, the next layer's RMSNorm + QKV projection as a fixed sequence of
hand-written kernels with no PyTorch op between them.  A CPU tensor runs the
plain version, :func:`fused_layer_tail_plain`; a CUDA tensor runs the kernel
or raises.  ``fused_layer_tail.launches`` counts calls, and
``fused_layer_tail.last_kernels`` holds the number of kernels the last call
launched on the card.

Every product of the tail (and of K9's) runs on the tail product: a
persistent grid with one CTA per SM over (128-column tile, 128-row k-block)
units, each CTA taking an equal share in a fixed order (stream-K), weights
and activations by TMA, wgmma with the weight columns as M and the
activation rows as N (:func:`tail_width`).  :func:`tail_schedule` is that
schedule, a pure function of the shape and the SM count, which the kernels
compute alike; the reductions add each tile's partial sums in CTA order, so
results are bitwise repeatable.  :func:`tail_matmul` runs one product alone.

Layout (models/quantized.fuse_projections): x (M, E); attn_out (M, Q)
with wo (Q, E); w_gate_up (E, 2I) = [gate | up]; w_down (I, E); next
w_qkv (E, F).  Each matrix is int8 ({"q", "s"}) or int4 ({"q4", "s"}),
independently.  Rounding points as in JAX (qmlp.py:123-153): the
projection cast to x.dtype before the residual add; x1 and h in x.dtype;
gate and up cast; act = silu(fp32(gate)) cast, times up in x.dtype; the
down product summed in fp32, cast, then added to x1; the next QKV cast.

The gates keep the JAX structure checks (qmlp.py:218-291).  The Mosaic
VMEM budget arithmetic (``_resident_bytes``, ``_pick_block_i``,
``_WO_BUDGET``) is not carried over: the H100 kernels stream every
matrix through shared-memory tiles and keep nothing resident.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import config
from ..utils import checks
from . import _native
from .qmm import check_activation, check_weight, dequantize_int4_tile, quantized_matmul_plain

#: Row cap of the fused tail (qmlp.py:64): decode batches and short
#: prefill groups.
_MAX_ROWS = 256


#: Weight columns and unpacked weight rows of one tail-product unit
#: (csrc/common.cuh, kTailBN / kTailKB).
TAIL_BN = 128
TAIL_KB = 128
#: The SM count of the H100 SXM: the default of :func:`tail_schedule`.
H100_SMS = 132


class TailSchedule(NamedTuple):
    """The tail product's persistent schedule (csrc/tail.cu).  Units
    ``u = tile * kblocks + kblock``; CTA c takes ``base`` units (one more
    when ``c < rem``) from ``c * base + min(c, rem)`` on.  ``width`` is the
    wgmma N the activation rows round up to."""

    width: int
    tiles: int
    kblocks: int
    ctas: int
    base: int
    rem: int

    @property
    def units(self) -> int:
        return self.tiles * self.kblocks

    def cta_units(self, c: int):
        """[start, stop) of CTA c's units."""
        start = c * self.base + min(c, self.rem)
        return start, start + self.base + (1 if c < self.rem else 0)

    def segments(self):
        """(cta, tile, kb0, kb1, slot) of every (CTA, tile) pair, in CTA
        order: CTA c sums k-blocks [kb0, kb1) of the tile into slot c + t."""
        out = []
        for c in range(self.ctas):
            u0, u1 = self.cta_units(c)
            u = u0
            while u < u1:
                t = u // self.kblocks
                stop = min(u1, (t + 1) * self.kblocks)
                out.append((c, t, u - t * self.kblocks, stop - t * self.kblocks, c + t))
                u = stop
        return out

    def tile_slots(self, t: int):
        """The slots of tile t in the order the reductions add them."""
        return [slot for _, tile, _, _, slot in self.segments() if tile == t]

    def partial_floats(self, m: int) -> int:
        """fp32 entries of the product's partial sums: (ctas + tiles) slots
        of (m, 128)."""
        return (self.ctas + self.tiles) * m * TAIL_BN


def tail_unit_rows(kb: int, int4: bool):
    """The rows k-block ``kb`` of a tail product stages (csrc/tail.cu's TMA
    coordinates): (its weight rows -- packed rows for int4 --, the two
    64-row ranges of the activation columns its wgmma depth covers).  An
    int4 unit is 64 packed rows of one 256-row packing block: low nibbles
    rows [256g + 64j, +64), high nibbles [256g + 128 + 64j, +64)."""
    if int4:
        k0 = (kb // 2) * 256 + (kb % 2) * 64
        return range(64 * kb, 64 * kb + 64), (range(k0, k0 + 64), range(k0 + 128, k0 + 192))
    k0 = TAIL_KB * kb
    return range(k0, k0 + TAIL_KB), (range(k0, k0 + 64), range(k0 + 64, k0 + 128))


def tail_ctas_per_sm(width: int) -> int:
    """CTAs an SM of the tail product at an activation width: two up to 64
    (more warps hide the conversion's latencies), else one."""
    return 2 if width <= 64 else 1


def tail_width(m: int) -> int:
    """wgmma's N for m activation rows: 8, 16, 32, 64, 128 or 256."""
    if not 0 < m <= _MAX_ROWS:
        raise ValueError(f"the tail product takes 1..{_MAX_ROWS} rows, got {m}")
    return max(8, 1 << (m - 1).bit_length())


@functools.lru_cache(maxsize=None)
def tail_schedule(m: int, n: int, k: int, sms: int = H100_SMS) -> TailSchedule:
    """The persistent schedule of an (m, k) @ (k, n) tail product on a card
    of ``sms`` SMs (int8 or int4 alike: a unit is 128 rows of either): one
    or two CTAs an SM by the width, each with an equal share of units."""
    if n % TAIL_BN or k % TAIL_KB:
        raise ValueError(f"the tail product needs N and K % 128 == 0, got N={n} K={k}")
    tiles, kblocks = n // TAIL_BN, k // TAIL_KB
    units, width = tiles * kblocks, tail_width(m)
    ctas = max(1, min(tail_ctas_per_sm(width) * sms, units))
    return TailSchedule(width, tiles, kblocks, ctas, units // ctas, units % ctas)


def _is_q(w: Any) -> bool:
    return isinstance(w, dict) and "s" in w and ("q" in w or "q4" in w)


def _minfo(w: dict):
    """(int4, in_dim, out_dim) of an int8/int4 quantized matrix."""
    if "q4" in w:
        return True, 2 * w["q4"].shape[0], w["q4"].shape[1]
    return False, w["q"].shape[0], w["q"].shape[1]


def tail_supported(cfg, layer, x: torch.Tensor) -> bool:
    """Routing gate of the fused tail (models/llama._layer_tail).

    True on a fuse_projections'd quantized tree with kernel-legal shapes
    at <= 256 rows, when ``config.kernel.qmlp`` routes ``x``'s device
    (True: CUDA; "force": also the CPU, through the plain version)."""
    if not checks.kernel_route(config.kernel.qmlp, x.device):
        return False
    if getattr(cfg, "num_experts", 0) > 0:
        return False
    if not all(k in layer and _is_q(layer[k]) for k in ("w_gate_up", "w_down", "wo")):
        return False
    kernel_dtypes = (torch.bfloat16,) if x.device.type == "cuda" else (torch.bfloat16, torch.float32)
    if x.dtype not in kernel_dtypes or math.prod(x.shape[:-1]) > _MAX_ROWS:
        return False
    e_dim = x.shape[-1]
    wo4, q_dim, e2 = _minfo(layer["wo"])
    gu4, e3, i2 = _minfo(layer["w_gate_up"])
    d4, inter, e4 = _minfo(layer["w_down"])
    if not (e_dim == e2 == e3 == e4 and i2 == 2 * inter):
        return False
    if e_dim % 128 or inter % 128 or q_dim % 128:
        return False
    # int4 matrices pack 256-row blocks along their input axis.
    return not ((gu4 and e_dim % 256) or (d4 and inter % 256) or (wo4 and q_dim % 256))


def qkv_fold_supported(cfg, layer, next_layer, x: torch.Tensor) -> bool:
    """May this layer's fused tail also emit the next layer's QKV?  Needs
    a fused quantized ``w_qkv`` and ``attn_norm`` on the next layer, with
    kernel-legal shapes."""
    if next_layer is None or "w_qkv" not in next_layer:
        return False
    if not _is_q(next_layer["w_qkv"]) or "attn_norm" not in next_layer:
        return False
    qkv4, e_in, f_out = _minfo(next_layer["w_qkv"])
    e_dim = x.shape[-1]
    return e_in == e_dim and f_out % 128 == 0 and not (qkv4 and e_dim % 256)


def _proj(a: torch.Tensor, w: dict) -> torch.Tensor:
    """a @ w in fp32, before the cast (int8: the scaled sum; int4: the sum
    over weights rounded to a.dtype)."""
    if "q4" in w:
        return a.float() @ dequantize_int4_tile(w["q4"], w["s"], a.dtype).float()
    return quantized_matmul_plain(a.float(), w["q"], w["s"])


def _rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def fused_layer_tail_plain(
    x, norm_w, w_gate_up, w_down, *, eps, attn_out=None, wo=None,
    next_attn_norm=None, next_w_qkv=None,
):
    """K8's plain version: fp32 products with the kernel's rounding points."""
    dt = x.dtype
    x1 = x if wo is None else (x.float() + _proj(attn_out, wo).to(dt).float()).to(dt)
    h = _rmsnorm(x1, norm_w, eps)
    gu = _proj(h, w_gate_up)
    inter = gu.shape[-1] // 2
    gate, up = gu[:, :inter].to(dt), gu[:, inter:].to(dt)
    act = (F.silu(gate.float()).to(dt).float() * up.float()).to(dt)
    out = (x1.float() + _proj(act, w_down).to(dt).float()).to(dt)
    if next_w_qkv is None:
        return out
    return out, _proj(_rmsnorm(out, next_attn_norm, eps), next_w_qkv).to(dt)


def fused_layer_tail(
    x: torch.Tensor,
    norm_w: torch.Tensor,
    w_gate_up: dict,
    w_down: dict,
    *,
    eps: float,
    attn_out: Optional[torch.Tensor] = None,
    wo: Optional[dict] = None,
    next_attn_norm: Optional[torch.Tensor] = None,
    next_w_qkv: Optional[dict] = None,
):
    """One decoder-layer tail (see the module docstring for the math).
    With ``next_attn_norm``/``next_w_qkv`` (gate with
    :func:`qkv_fold_supported`) also the next layer's bias-free QKV
    projection: returns ``(out, qkv)`` instead of ``out``."""
    if (attn_out is None) != (wo is None):
        raise ValueError("attn_out and wo must be given together")
    if (next_attn_norm is None) != (next_w_qkv is None):
        raise ValueError("next_attn_norm and next_w_qkv must be given together")
    m, e_dim = x.shape
    _, e3, i2 = _minfo(w_gate_up)
    _, inter, e4 = _minfo(w_down)
    if e4 != e_dim or e3 != e_dim or i2 != 2 * inter:
        raise ValueError(
            f"shape mismatch: x (M,{e_dim}), w_gate_up in={e3} out={i2}, "
            f"w_down in={inter} out={e4}"
        )
    if wo is not None and (attn_out.shape[0] != m or _minfo(wo)[1:] != (attn_out.shape[1], e_dim)):
        raise ValueError(f"attn_out {tuple(attn_out.shape)} does not match wo and x")
    if next_w_qkv is not None and _minfo(next_w_qkv)[1] != e_dim:
        raise ValueError(f"next_w_qkv takes {_minfo(next_w_qkv)[1]} inputs, x has {e_dim}")
    kw = dict(eps=eps, attn_out=attn_out, wo=wo, next_attn_norm=next_attn_norm,
              next_w_qkv=next_w_qkv)
    if x.device.type == "cpu":
        return fused_layer_tail_plain(x, norm_w, w_gate_up, w_down, **kw)
    return _tail_cuda(x, norm_w, w_gate_up, w_down, **kw)


fused_layer_tail.launches = 0
fused_layer_tail.last_kernels = 0


def _mat(w: Optional[dict], device, name: str):
    """(codes, scale, int4) pointers of a quantized matrix, checked."""
    if w is None:
        return None, None, 0
    int4 = "q4" in w
    q = w["q4" if int4 else "q"]
    check_weight(q, w["s"], device, name)
    return q.data_ptr(), w["s"].data_ptr(), int(int4)


def _tail_cuda(x, norm_w, w_gate_up, w_down, *, eps, attn_out, wo, next_attn_norm, next_w_qkv):
    """Check what K8 takes, allocate its workspace, launch."""
    checks.require_hopper(x.device)
    check_activation(x, "K8", (torch.bfloat16,))
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"K8 takes at most {_MAX_ROWS} rows, got {x.shape[0]}")
    if attn_out is not None:
        check_activation(attn_out, "K8", (torch.bfloat16,))
    for v in (norm_w, next_attn_norm):
        if v is not None and (v.dtype != torch.float32 or not v.is_contiguous()
                              or v.device != x.device):
            raise ValueError("K8's norm weights must be contiguous float32 on the card")
    m, e_dim = x.shape
    q_dim = 0 if wo is None else _minfo(wo)[1]
    inter = _minfo(w_down)[1]
    f_out = 0 if next_w_qkv is None else _minfo(next_w_qkv)[2]
    gu4, d4 = "q4" in w_gate_up, "q4" in w_down
    wo4 = wo is not None and "q4" in wo
    qkv4 = next_w_qkv is not None and "q4" in next_w_qkv
    if (e_dim % 128 or inter % 128 or q_dim % 128 or f_out % 128
            or (gu4 or qkv4) and e_dim % 256 or d4 and inter % 256 or wo4 and q_dim % 256):
        raise ValueError(
            f"K8 needs E, I, Q, F % 128 == 0 (256 for int4 inputs): "
            f"E={e_dim} I={inter} Q={q_dim} F={f_out}"
        )
    dev = x.device
    out = torch.empty_like(x)
    qkv = torch.empty((m, f_out), dtype=x.dtype, device=dev) if f_out else None
    if m == 0:
        return out if qkv is None else (out, qkv)
    lib = _native.library()
    x1 = torch.empty_like(x) if wo is not None else None
    h = torch.empty_like(x)
    act = torch.empty((m, inter), dtype=x.dtype, device=dev)
    partial = torch.empty(
        (lib.qa_layer_tail_workspace(m, e_dim, q_dim, inter, f_out),),
        dtype=torch.float32, device=dev,
    )
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels = ctypes.c_int(0)
    err = lib.qa_layer_tail(
        x.data_ptr(), ptr(attn_out), *_mat(wo, dev, "K8 wo"), norm_w.data_ptr(),
        *_mat(w_gate_up, dev, "K8 w_gate_up"), *_mat(w_down, dev, "K8 w_down"),
        ptr(next_attn_norm), *_mat(next_w_qkv, dev, "K8 w_qkv"),
        out.data_ptr(), ptr(qkv), ptr(x1), h.data_ptr(), act.data_ptr(),
        partial.data_ptr(), m, e_dim, q_dim, inter, f_out, float(eps),
        ctypes.byref(kernels), torch.cuda.current_stream(dev).cuda_stream,
    )
    _native.check(err, "qa_layer_tail")
    fused_layer_tail.launches += 1
    fused_layer_tail.last_kernels = kernels.value
    return out if qkv is None else (out, qkv)


def tail_matmul_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The tail product's plain version: ``x @ w`` in fp32, cast once
    (int8: times the column scales; int4: over weights rounded to x.dtype)."""
    return _proj(x, w).to(x.dtype)


def tail_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """One tail product (csrc/tail.cu) and its reduction: x (M, K) bf16
    times a quantized (K, N) matrix, M <= 256.  The product K8 and K9 run
    for each of their matrices, alone; a CPU tensor runs the plain version.
    ``tail_matmul.launches`` counts calls on the card."""
    int4, k, n = _minfo(w)
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match a ({k}, {n}) matrix")
    if x.device.type == "cpu":
        return tail_matmul_plain(x, w)
    checks.require_hopper(x.device)
    check_activation(x, "tail product", (torch.bfloat16,))
    m = x.shape[0]
    if m > _MAX_ROWS or n % TAIL_BN or k % (256 if int4 else TAIL_KB):
        raise ValueError(f"the tail product takes M <= {_MAX_ROWS}, N % 128 == 0 and K % "
                         f"{256 if int4 else 128} == 0: M={m} N={n} K={k}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = _native.library()
    partial = torch.empty((lib.qa_tail_workspace(m, n, k),), dtype=torch.float32, device=x.device)
    q, s, flag = _mat(w, x.device, "tail product")
    err = lib.qa_tail_matmul(x.data_ptr(), q, s, flag, out.data_ptr(), partial.data_ptr(), m, n, k,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _native.check(err, "qa_tail_matmul")
    tail_matmul.launches += 1
    return out


tail_matmul.launches = 0


def card_tail_schedule(m: int, n: int, k: int) -> TailSchedule:
    """The schedule the kernels compute on the current card (csrc/tail.cu,
    ``qa_tail_schedule``), for holding against :func:`tail_schedule`."""
    out = (ctypes.c_int * 5)()
    width = _native.library().qa_tail_schedule(m, n, k, out)
    ctas, base, rem, tiles, kblocks = list(out)
    return TailSchedule(width, tiles, kblocks, ctas, base, rem)
