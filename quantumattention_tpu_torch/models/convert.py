"""JAX parameter trees <-> this package's parameters.

``params_from_numpy`` takes the tree that ``quantumattention_tpu.models.
llama.init_params`` (or ``models/hf.load_hf_checkpoint``) builds, with every
leaf turned into a numpy array (``jax.tree_util.tree_map(np.asarray, ...)``),
and returns the same tree of torch tensors on ``device``.

Layout assumed: the unquantized Llama tree of the JAX package —
``embed`` (V, E), ``final_norm`` (E,) fp32, optional ``lm_head`` (E, V),
and a ``layers`` list whose dicts hold ``attn_norm``/``mlp_norm`` (E,) fp32
and the projections ``wq`` (E, Hq*D), ``wk``/``wv`` (E, Hkv*D),
``wo`` (Hq*D, E), ``w_gate``/``w_up`` (E, F), ``w_down`` (F, E), optional
``bq``/``bk``/``bv``.  Both packages store weights (in, out), so no
transposes happen; bfloat16 arrays (ml_dtypes) are reinterpreted bit for
bit.  Quantized or fused trees are refused.  ``params_to_numpy`` is the
inverse, so a test can hold this package's gradients and updated
parameters against the JAX tree.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .llama import LlamaConfig, Params, tree_like, leaves


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy that the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, cfg: LlamaConfig, device="cpu") -> Params:
    """Numpy leaves of a JAX Llama tree -> torch tensors on ``device``."""
    if any(isinstance(w, dict) for layer in tree["layers"] for w in layer.values()):
        raise NotImplementedError(
            "quantized weight trees are not ported yet (ROADMAP queue 1, item 13)"
        )
    if any("w_qkv" in layer or "moe" in layer for layer in tree["layers"]):
        raise NotImplementedError("fused-projection and MoE trees are not ported yet")
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(
            f"tree has {len(tree['layers'])} layers, config {cfg.num_layers}"
        )
    out: Params = {
        k: _tensor(v, device) for k, v in tree.items() if k != "layers"
    }
    out["layers"] = [
        {k: _tensor(v, device) for k, v in layer.items()} for layer in tree["layers"]
    ]
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as JAX uses it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Params) -> Any:
    """This package's tree (parameters or gradients) -> numpy leaves of the
    same structure, bfloat16 bit for bit; None leaves stay None."""
    return tree_like(params, [None if t is None else _array(t) for t in leaves(params)])
