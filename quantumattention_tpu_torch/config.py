"""Config/flag system (counterpart of quantumattention_tpu/config.py).

A tree of plain namespaces whose defaults come from ``QUANTUM_ATTN_*``
environment variables, plus dotted ``get``/``set`` and a ``patch()``
context manager with the JAX package's semantics (config.py:185-223).

Only the flags this package reads are here.  The TPU-only knobs
(``vmem_limit_mb``, ``softmax_bf16``, ``interpret``, ``fp8_dot`` and the
``enable_int8_*`` MXU gates) have no meaning on the GPU, nor has
``kernel.autotune_in_jit`` (a JAX tracing knob: ``autotune.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val not in ("0", "", "false", "False", "OFF", "off")


class _Namespace:
    """A mutable attribute namespace (one level of the config tree)."""

    def __init__(self, **kwargs: Any) -> None:
        for key, value in kwargs.items():
            setattr(self, key, value)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_Namespace({vars(self)})"


#: Kernel tuning knobs.
kernel = _Namespace(
    # Per-block quantization blocks (``scaling_method="per-block"``): rows
    # of Q and of K that share one scale.  None: JAX's heuristic (1024 /
    # 2048 rows below D = 256, 512 / 1024 from 256, capped at the length
    # rounded up to 128).  They set the quantization granularity only, not
    # K1's tiles (ops/flash.py).
    block_q=None,
    block_kv=None,
    # The timed autotuner (autotune.py): the "auto" path sweep and K1's
    # tile configuration.  On by default, as in JAX; a sweep runs once per
    # shape class, its winner cached on disk.
    autotune=_env_bool("QUANTUM_ATTN_AUTOTUNE", True),
    # Use the blockwise backward kernels K2/K3 (ops/flash_bwd.py); False
    # falls back to the O(S^2) oracle-recompute VJP (JAX kernel.pallas_bwd).
    cuda_bwd=_env_bool("QUANTUM_ATTN_CUDA_BWD", True),
    # Route quantized weight products (models/quantized.matmul) through the
    # w8a16/w4a16 kernels K5/K6/K7 (ops/qmm.py).  True: CUDA tensors take
    # the kernels, CPU tensors the plain composition; "force": CPU tensors
    # also go through the kernel wrappers (their plain versions), the JAX
    # package's interpret-mode test seam; False: the plain composition
    # everywhere (an explicit choice, never a fallback).
    qmm=_env_bool("QUANTUM_ATTN_QMM", True),
    # Run each decoder-layer tail (wo + residual + RMSNorm + SwiGLU MLP +
    # residual, optionally the next layer's QKV) as kernel K8
    # (ops/qmlp.py) on fused quantized trees at <= 256 rows; the same
    # True / "force" / False semantics as ``qmm``.
    qmlp=_env_bool("QUANTUM_ATTN_QMLP", True),
    # Run each decode layer of a fused int8 tree over an int8 slot cache as
    # kernel K9 (ops/megastep.py: attention with wo folded in, the MLP and
    # the next layer's QKV in one call) when ``megastep_supported`` holds;
    # the same True / "force" / False semantics as ``qmm`` (False: the
    # unfused step, lean decode + K8).
    megastep=_env_bool("QUANTUM_ATTN_MEGASTEP", True),
)

attention = _Namespace(
    # Skip the capability check in the dispatcher.
    skip_supported_check=_env_bool("QUANTUM_ATTN_SKIP_SUPPORTED_CHECK", False),
    # Route everything through the PyTorch SDPA reference path.
    force_fallback=_env_bool("QUANTUM_ATTN_FORCE_FALLBACK", False),
    # Enable the fused flash-forward kernel (ops/flash.py).
    enable_cuda_kernel=_env_bool("QUANTUM_ATTN_ENABLE_CUDA_KERNEL", True),
)


_MODULE = __import__(__name__, fromlist=["_"])


def _resolve(dotted: str):
    """Resolve "a.b" to (namespace_object, leaf_name)."""
    parts = dotted.split(".")
    obj: Any = _MODULE
    for part in parts[:-1]:
        obj = getattr(obj, part)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"unknown config key: {dotted!r}")
    return obj, leaf


def get(dotted: str) -> Any:
    obj, leaf = _resolve(dotted)
    return getattr(obj, leaf)


def set(dotted: str, value: Any) -> None:  # noqa: A001 - mirrors config API
    obj, leaf = _resolve(dotted)
    setattr(obj, leaf, value)


def snapshot() -> tuple:
    """Every flag's current value, as a hashable key: work that froze the
    flags it read (a captured CUDA graph) is keyed by it."""
    return tuple((name, tuple(sorted(vars(ns).items())))
                 for name, ns in (("kernel", kernel), ("attention", attention)))


@contextlib.contextmanager
def patch(changes: Dict[str, Any] | None = None, **kw: Any) -> Iterator[None]:
    """Temporarily override config values by dotted key."""
    merged: Dict[str, Any] = dict(changes or {})
    merged.update(kw)
    saved = {key: get(key) for key in merged}
    try:
        for key, value in merged.items():
            set(key, value)
        yield
    finally:
        for key, value in saved.items():
            set(key, value)
