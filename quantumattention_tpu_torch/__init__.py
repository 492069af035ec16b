"""quantumattention_tpu_torch — the PyTorch + CUDA port of quantumattention_tpu.

The same public surface as the JAX package root, on torch tensors: the six
attention entry points, ``can_use_attention``, the dynamic quantizers and
the config tree.  Tensors on the CPU run each kernel's plain PyTorch
version; tensors on an NVIDIA Hopper card run the hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use.
"""

from . import config  # noqa: F401
from .dispatch import can_use_attention  # noqa: F401
from .interface import (  # noqa: F401
    attn_func,
    attn_func_with_fallback,
    fp8_attn_func,
    fp8_attn_func_with_fallback,
    fp8_token_wise_attn_func,
    fp8_token_wise_attn_func_with_fallback,
)
from .ops.quant import (  # noqa: F401
    dynamically_quantize_fp8,
    dynamically_quantize_int8,
)

__version__ = "0.1.0"

__all__ = [
    "attn_func",
    "attn_func_with_fallback",
    "fp8_attn_func",
    "fp8_attn_func_with_fallback",
    "fp8_token_wise_attn_func",
    "fp8_token_wise_attn_func_with_fallback",
    "dynamically_quantize_fp8",
    "dynamically_quantize_int8",
    "can_use_attention",
    "config",
]
