"""Shared shape/alignment helpers (counterpart of quantumattention_tpu/utils/shapes.py)."""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    """Round x up to the next multiple of m."""
    return (x + m - 1) // m * m


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)
