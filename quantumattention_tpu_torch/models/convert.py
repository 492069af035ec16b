"""JAX parameter trees <-> this package's parameters.

``params_from_numpy`` takes the tree that ``quantumattention_tpu.models.
llama.init_params`` (or ``models/quantized.init_quantized_params``,
``quantize_params``, ``quantize_params_int4``, ``fuse_projections``, or
``models/hf.load_hf_checkpoint``) builds, with every leaf turned into a
numpy array (``jax.tree_util.tree_map(np.asarray, ...)``), and returns the
same tree of torch tensors on ``device``.

Layout assumed: the Llama tree of the JAX package — ``embed`` (V, E),
``final_norm`` (E,) fp32, optional ``lm_head`` (E, V), and a ``layers``
list whose dicts hold ``attn_norm``/``mlp_norm`` (E,) fp32, the
projections ``wq``/``wk``/``wv``/``wo``/``w_gate``/``w_up``/``w_down`` or
their fused ``w_qkv``/``w_gate_up``, and optional ``bq``/``bk``/``bv``;
an MoE layer holds a ``moe`` subtree in place of the MLP projections
(``w_router`` (E, experts) fp32 and the 3-D expert stacks
``w_gate``/``w_up``/``w_down``).  Any projection (and the embedding, and
each expert stack) may be a quantized dict, int8 ``{"q", "s"}`` or int4
``{"q4", "s"}``.  Both packages store weights (in, out), so no transposes
happen; bfloat16 arrays (ml_dtypes) are reinterpreted bit for bit.
``params_to_numpy`` is the inverse, so a test can hold this package's
gradients and updated parameters against the JAX tree.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..utils import checks
from .llama import LlamaConfig, Params


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy that the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree: Any, fn: Callable) -> Any:
    """``fn`` over every leaf of nested dicts and lists; None stays None."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def params_from_numpy(tree: Any, cfg: LlamaConfig, device=None) -> Params:
    """Numpy leaves of a JAX Llama tree -> torch tensors on ``device`` (the
    CUDA card unless it says otherwise)."""
    device = checks.default_device(device)
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(
            f"tree has {len(tree['layers'])} layers, config {cfg.num_layers}"
        )
    return _map(tree, lambda a: _tensor(a, device))


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as JAX uses it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Params) -> Any:
    """This package's tree (parameters, quantized or not, or gradients) ->
    numpy leaves of the same structure, bfloat16 bit for bit; None leaves
    stay None."""
    return _map(params, _array)
