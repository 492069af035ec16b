"""Weight products of the decoder (counterpart of
quantumattention_tpu/models/quantized.py).

Only the unquantized branches are ported: with bf16 weights every
projection is a plain product, which the JAX package left to XLA and this
package leaves to ``torch.matmul``.  Quantized weight dicts (``{"q", "s"}``
w8a16, ``{"q4", "s"}`` w4a16) raise until their kernels land (ROADMAP
queue 1, item 13).
"""

from __future__ import annotations

from typing import Any

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict)


def _refuse(w: Any) -> None:
    if is_quantized(w):
        raise NotImplementedError(
            "quantized weights (w8a16/w4a16) are not ported yet "
            "(ROADMAP queue 1, item 13)"
        )


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x (..., in) @ w (in, out) -> (..., out): weights are stored
    transposed-for-einsum, as in the JAX package."""
    _refuse(w)
    return torch.matmul(x, w)


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding lookup over a full table."""
    _refuse(embed)
    return embed[tokens].to(dtype)


def tied_head_matmul(x: torch.Tensor, embed: Any) -> torch.Tensor:
    """logits = x @ embed.T for a full embedding table."""
    _refuse(embed)
    return torch.matmul(x, embed.t())
