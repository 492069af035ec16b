"""Capability / dtype gates (counterpart of quantumattention_tpu/utils/checks.py).

The JAX package gates on the TPU generation and resolves an interpret mode
from the default backend.  Here the tensor's device decides: a CPU tensor
runs a kernel's plain PyTorch version, a CUDA tensor runs the kernel.  What
remains to check is whether a CUDA card is present and whether it is a
Hopper (compute capability >= 9.0, the ``sm_90a`` build target).
"""

from __future__ import annotations

import functools

import torch

_FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def cuda_available() -> bool:
    return torch.cuda.is_available()


def default_device(device=None) -> torch.device:
    """``device``, or the CUDA card when none is given.  Entry points that
    allocate (caches, page pools, converted parameters) call this, so a
    caller who does not ask for the CPU gets the card, and a machine
    without one raises rather than quietly using the CPU."""
    if device is not None:
        return torch.device(device)
    if not cuda_available():
        raise RuntimeError(
            "no device given and no CUDA card present: pass device='cpu' to "
            "run the kernels' plain versions on the CPU"
        )
    return torch.device("cuda")


def compute_capability(device=None) -> tuple:
    """(major, minor) of the CUDA device, or (0, 0) without CUDA."""
    if not cuda_available():
        return (0, 0)
    return _capability(torch.cuda._get_device_index(device, optional=True))


@functools.cache
def _capability(index: int) -> tuple:
    # Asked on every kernel launch; a device's capability never changes.
    return tuple(torch.cuda.get_device_capability(index))


def is_hopper(device=None) -> bool:
    """Whether the kernels' ``sm_90a`` build runs on this device."""
    return compute_capability(device) >= (9, 0)


def require_hopper(device) -> None:
    """Raise unless ``device`` is a CUDA device the kernels run on."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels run on CUDA tensors, got {device}")
    if not is_hopper(device):
        raise ValueError(
            f"the CUDA kernels are built for sm_90a; {device} has compute "
            f"capability {compute_capability(device)}"
        )


def kernel_route(flag, device) -> bool:
    """Whether a ``config.kernel`` routing flag (True / "force" / False)
    sends a product on ``device`` to its kernel wrapper: True routes CUDA
    tensors, "force" also CPU tensors (where the wrapper runs the kernel's
    plain version), False none."""
    return bool(flag) and (flag == "force" or torch.device(device).type == "cuda")


def is_fp8_dtype(dtype) -> bool:
    """Predicate over FP8 dtypes (checks.py:100-102)."""
    return dtype in _FP8_DTYPES


def is_8bit_dtype(dtype) -> bool:
    """Predicate over any 8-bit dtype (checks.py:105-107)."""
    return dtype.itemsize == 1 and dtype != torch.bool
