"""Shared shape/alignment helpers (counterpart of quantumattention_tpu/utils/shapes.py)."""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    """Round x up to the next multiple of m."""
    return (x + m - 1) // m * m


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


#: The head dims the JAX package names (quantumattention_tpu/dispatch.py:98-102);
#: it also takes any other multiple of 8 up to MAX_HEAD_DIM, and so does the port
#: (its attention kernels run a head dim at the next of their instantiated
#: widths 64, 128, 256 and 512, with zero columns: csrc/common.cuh).
SUPPORTED_HEAD_DIMS = (64, 128, 256)
MAX_HEAD_DIM = 512


def head_dim_supported(d: int) -> bool:
    """The JAX package's rule: one of SUPPORTED_HEAD_DIMS or a multiple of 8
    up to 512 (the first are among the second)."""
    return d % 8 == 0 and d <= MAX_HEAD_DIM


def head_dim_reason(d: int) -> str:
    """The JAX package's refusal, word for word."""
    return (
        f"head_dim {d} unsupported (want one of {SUPPORTED_HEAD_DIMS} "
        f"or a multiple of 8 <= {MAX_HEAD_DIM})"
    )


def kernel_width(d: int) -> int:
    """The instantiated width a head dim runs at (``qa::kernel_width``)."""
    return 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512


def check_kernel_head_dim(name: str, d: int) -> None:
    """Raise where kernel ``name`` does not take head dim ``d`` (a positive
    multiple of 8 up to 512)."""
    if not (d > 0 and head_dim_supported(d)):
        raise ValueError(
            f"{name} takes a head_dim that is a multiple of 8 up to {MAX_HEAD_DIM}, got {d}"
        )

