"""Parameter checkpoints: save and load (counterpart of
quantumattention_tpu/models/io.py).

One ``.npz`` holds every leaf of a parameter tree under its path, the keys
built as the JAX package builds them (dict keys and list indices joined by
"/": ``layers/0/wq/q``), so a file either package writes loads in the
other.  Arrays numpy cannot store (bfloat16, fp8) are saved as float32, a
lossless upcast, and cast back to the template's dtype on load.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator, Tuple, Union

import numpy as np
import torch

#: numpy dtypes an .npz stores as they are (JAX io.py:50-53); any other
#: leaf is saved as float32.
_NPZ_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int8, np.uint8, np.bool_, np.float16)


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of nested dicts and lists; None
    leaves hold nothing, as in a JAX pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        if tree is not None:
            yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))


def _normalize(path: Union[str, Path]) -> Path:
    """np.savez appends '.npz' to a path without it; load mirrors that, so
    one path string round-trips."""
    path = Path(path)
    if path.suffix != ".npz":
        path = Path(str(path) + ".npz")
    return path


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.is_floating_point() and t.dtype not in (torch.float16, torch.float32, torch.float64):
        return t.float().numpy()  # bfloat16 and fp8: numpy has no such dtype
    arr = t.numpy()
    return arr if arr.dtype in _NPZ_DTYPES else arr.astype(np.float32)


def save_params(params: Any, path: Union[str, Path]) -> None:
    """Write a parameter tree to ``path`` (.npz)."""
    path = _normalize(path)
    leaves = {key: _numpy(leaf) for key, leaf in _leaves(params)}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **leaves)


def load_params(template: Any, path: Union[str, Path]) -> Any:
    """Load a checkpoint into the structure, dtypes and devices of
    ``template`` (typically ``llama.init_params`` output; its values are
    discarded)."""
    with np.load(_normalize(path)) as data:

        def load(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: load(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [load(v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
            if tree is None:
                return None
            if prefix not in data:
                raise KeyError(f"checkpoint missing parameter {prefix!r}")
            arr = data[prefix]
            if arr.shape != tuple(tree.shape):
                raise ValueError(
                    f"shape mismatch for {prefix!r}: checkpoint {arr.shape} "
                    f"vs template {tuple(tree.shape)}"
                )
            return torch.from_numpy(arr).to(device=tree.device, dtype=tree.dtype)

        return load(template)
