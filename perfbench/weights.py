"""Weights drawn from the seed, on the device, in the form they are served:
the leaves every family's tree is made of (``perfbench/families/``).

Every leaf has a generator of its own, seeded from the run's seed and the
leaf's name, so the reference can draw any one leaf again, alone and in the
same bytes, after the program's state is freed.  Nothing here imports the
program.  An int8 matrix is ``{"q": int8 codes, "s": fp32 scales (..., 1,
out)}``, stored (in, out); an embedding table's scales are per row.

int8 leaves are drawn as codes and scales directly (a bf16 tree of a
47B-parameter MoE model does not fit the card): codes uniform in [-127,
127], each output column's scale 1 / (73.6 * sqrt(fan_in)) times a factor
uniform in [0.5, 1.5], so the weights have about the variance of a
1 / sqrt(fan_in) init and every column its own scale.  Norm weights are 1 + U(-0.1, 0.1).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import torch

#: Standard deviation of codes uniform on the 255 integers [-127, 127].
CODE_STD = math.sqrt((255 ** 2 - 1) / 12.0)


def leaf_generator(seed: int, name: str, device) -> torch.Generator:
    mixed = (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _int8(shape, name: str, seed: int, device) -> Dict[str, torch.Tensor]:
    g = leaf_generator(seed, name, device)
    q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
    scale_shape = (*shape[:-2], 1, shape[-1])
    s = torch.rand(scale_shape, generator=g, device=device).add_(0.5)
    s.mul_(1.0 / (CODE_STD * math.sqrt(shape[-2])))
    return {"q": q, "s": s}


def _int8_rows(shape, name: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """An embedding table quantized per row: (V, H) codes, (V, 1) scales."""
    g = leaf_generator(seed, name, device)
    q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
    s = torch.rand((shape[0], 1), generator=g, device=device).add_(0.5)
    s.mul_(1.0 / (CODE_STD * math.sqrt(shape[0])))
    return {"q": q, "s": s}


def _norm(n: int, name: str, seed: int, device) -> torch.Tensor:
    g = leaf_generator(seed, name, device)
    return torch.rand((n,), generator=g, device=device).mul_(0.2).add_(0.9)
