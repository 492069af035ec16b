"""Weight-only quantization (w8a16, w4a16) of the decoder parameter tree
(counterpart of quantumattention_tpu/models/quantized.py).

A quantized matrix is ``{"q": int8 (..., in, out), "s": fp32 (..., 1,
out)}`` (symmetric per output channel) or ``{"q4": int8 (in/2, out),
"s": fp32 (in/128, out)}`` (group-wise int4, two nibbles a byte, split
halves within 256-row blocks).  :func:`matmul` takes either, or a plain
tensor, so every projection of ``models/llama.py`` works with mixed trees.

Routing (``config.kernel.qmm``): on a CUDA tensor every 2-D quantized
product goes to kernel K5/K6 (int8) or K7 (int4) (ops/qmm.py), and a shape
the kernels do not take raises.  The JAX package's size gate
(quantized.py:178-191: the kernel only for weights of >= 32 MiB, or
>= 8 MiB at >= 512 rows) prices the TPU's fixed cost per ``pallas_call``
and is not carried over.  The embedding lookup and the tied head over a
quantized table stay plain PyTorch, as the JAX package leaves them to XLA.

MoE expert stacks ((E, in, out), ``models/moe``) quantize to int8 with
per-expert, per-column scales (E, 1, out), under int4 too, and the router
stays fp32, as in JAX.  On the card a quantized stack's product runs K5/K6
once per expert over its 2-D slice (JAX keeps stacks on its einsum path
only because its TPU kernel takes 2-D weights); bf16 stacks stay one
batched ``torch.matmul``, as JAX computes them outside any Pallas kernel.

Inference only: int8/int4 leaves are not differentiable, so
``llama.loss_and_grads`` refuses a quantized tree.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .. import config
from ..ops import qmm, quant
from ..utils import checks

Params = Dict[str, Any]

#: Keys holding (in, out) projection matrices, quantized per output
#: channel.  Norms and biases stay full precision.
_MATRIX_KEYS = frozenset(["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"])
#: w4a16 scale-group size along the input axis.
INT4_GROUP = 128
#: Packing block: byte row r of block g holds original row 256g + r (low
#: nibble) and 256g + 128 + r (high nibble), so a tile of 128 packed rows
#: covers a contiguous range of original rows.
_PACK_BLOCK = 2 * INT4_GROUP


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_quantized4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w and "s" in w


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """(R, C) int4-range int8 -> (R/2, C) packed (see _PACK_BLOCK)."""
    r, c = q.shape
    if r % _PACK_BLOCK:
        raise ValueError(f"rows ({r}) must be a multiple of {_PACK_BLOCK}")
    return quant.pack_int4(q.reshape(r // _PACK_BLOCK, _PACK_BLOCK, c), axis=1).reshape(r // 2, c)


def unpack_int4_rows(packed: torch.Tensor, out_dtype=torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows` for any row extent that is a
    multiple of 128 packed rows (tiles included)."""
    return qmm.unpack_int4(packed).to(out_dtype)


def quantize_matrix_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) float -> {"q4": (in/2, out) packed int8, "s": (in/128,
    out) fp32}: symmetric group-wise int4."""
    wf = w.float()
    r, c = wf.shape
    if r % _PACK_BLOCK:
        raise ValueError(f"int4 quantization needs in-dim % {_PACK_BLOCK} == 0 (got {r})")
    g = wf.reshape(r // INT4_GROUP, INT4_GROUP, c)
    amax = torch.clamp_min(g.abs().amax(dim=1, keepdim=True), 1e-12)
    s = amax / 7.0
    q = torch.clamp(torch.round(g / s), -8, 7).reshape(r, c).to(torch.int8)
    return {"q4": pack_int4_rows(q), "s": s[:, 0, :]}


def dequantize_int4(w: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """{"q4", "s"} -> the (in, out) dequantized matrix."""
    return qmm.dequantize_int4_tile(w["q4"], w["s"], dtype)


def quantize_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) float -> {"q": int8, "s": (..., 1, out) fp32}."""
    wf = w.float()
    amax = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True), 1e-12)
    s = amax / 127.0
    return {"q": torch.round(wf / s).to(torch.int8), "s": s}


def quantize_embed(embed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(V, H) float -> {"q": int8, "s": (V, 1) fp32}, per-row scales (the
    row is the output channel of a tied head)."""
    ef = embed.float()
    amax = torch.clamp_min(ef.abs().amax(dim=-1, keepdim=True), 1e-12)
    s = amax / 127.0
    return {"q": torch.round(ef / s).to(torch.int8), "s": s}


def matmul(x: torch.Tensor, w: Any, *, use_kernel: bool | None = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) -> (..., out), for a plain or quantized w
    (weights are stored transposed-for-einsum, as in the JAX package).

    ``use_kernel``: None follows ``config.kernel.qmm`` (see the module
    docstring); True sends 2-D quantized products through the kernel
    wrappers (on the CPU their plain versions); False keeps the plain
    composition."""
    if not (is_quantized(w) or is_quantized4(w)):
        return _promoted_matmul(x, w)
    key = "q4" if is_quantized4(w) else "q"
    q, s = w[key], w["s"]
    if use_kernel is None:
        use_kernel = checks.kernel_route(config.kernel.qmm, x.device)
    if use_kernel and q.ndim == 3 and key == "q":
        y = _expert_matmul(x, q, s)
        if y is not None:
            return y
    if use_kernel and q.ndim == 2:
        x2 = x.reshape(-1, x.shape[-1])
        gate = qmm.supported4 if key == "q4" else qmm.supported
        # On the card a shape the kernel does not take raises in the
        # wrapper; on the CPU it keeps the plain composition, as in JAX.
        if x.is_cuda or gate(x2, q):
            kernel = qmm.quantized_matmul4 if key == "q4" else qmm.quantized_matmul
            return kernel(x2, q, s).reshape(*x.shape[:-1], q.shape[-1])
    if key == "q4":
        return torch.matmul(x, dequantize_int4(w, x.dtype))
    y = torch.matmul(x, q.to(x.dtype))
    return (y.float() * s).to(x.dtype)


def _promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the operands' promoted dtype, as JAX's products promote
    (bf16 activations against an fp32 tree loaded by ``models/hf``)."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return torch.matmul(a, b)


def _expert_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor):
    """x (E, C, in) times an int8 expert stack q (E, in, out), s (E, 1, out):
    one K5/K6 product per expert over its 2-D slice.  On the card a shape
    the kernel does not take raises in the wrapper; on the CPU (kernel
    route "force") it returns None, and the plain composition runs."""
    if x.ndim != 3 or x.shape[0] != q.shape[0]:
        raise ValueError(f"expert stack {tuple(q.shape)} needs x (E, C, in), got {tuple(x.shape)}")
    x = x.contiguous()
    if not x.is_cuda and not all(qmm.supported(x[e], q[e]) for e in range(q.shape[0])):
        return None
    return torch.stack([qmm.quantized_matmul(x[e], q[e], s[e]) for e in range(q.shape[0])])


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding lookup over a full or row-quantized table."""
    if not is_quantized(embed):
        return embed[tokens].to(dtype)
    return (embed["q"][tokens].float() * embed["s"][tokens]).to(dtype)


def tied_head_matmul(x: torch.Tensor, embed: Any) -> torch.Tensor:
    """logits = x @ embed.T for a full or row-quantized embedding table
    (fp32 for a quantized one, as in JAX)."""
    if not is_quantized(embed):
        return _promoted_matmul(x, embed.t())
    y = torch.matmul(x, embed["q"].to(x.dtype).t())
    return y.float() * embed["s"][:, 0]


def init_quantized_params(
    generator: torch.Generator, cfg, int4: bool = False, device=None
) -> Params:
    """``quantize_params(llama.init_params(generator, cfg))`` (or
    ``quantize_params_int4`` with ``int4``) without the full-precision
    tree: the same draws in the same order, each matrix quantized as soon
    as it is drawn, so one fp32 matrix is live at a time."""
    from . import llama

    dense = _quantize_matrix4 if int4 else quantize_matrix
    # The LM head and the MoE expert stacks stay int8 under int4, as in JAX.
    quantizers = {"embed": quantize_embed, "lm_head": quantize_matrix, "moe": quantize_matrix}
    return llama.init_params(
        generator, cfg, device,
        transform=lambda name, w: quantizers.get(name.split(".")[0], dense)(w),
    )


def _concat_quantized(parts) -> Dict[str, torch.Tensor]:
    """Concatenate quantized matrices along the output (last) axis: per
    channel and per group scales concatenate along with them."""
    key = "q4" if is_quantized4(parts[0]) else "q"
    if any(("q4" in p) != (key == "q4") for p in parts):
        raise ValueError("cannot fuse mixed int8/int4 projections")
    return {
        key: torch.cat([p[key] for p in parts], dim=-1),
        "s": torch.cat([p["s"] for p in parts], dim=-1),
    }


def fuse_projections(params: Params) -> Params:
    """Fuse each layer's quantized [wq|wk|wv] -> ``w_qkv`` and
    [w_gate|w_up] -> ``w_gate_up`` (quantized.py:347-383): one product
    and one weight stream instead of three and two, with the same
    numerics (each output channel's contraction is unchanged).  Biases
    and MoE subtrees stay as they are (a layer whose FFN is ``"moe"`` has
    no ``w_gate``/``w_up`` to fuse)."""

    def _q(w: Any) -> bool:
        return is_quantized(w) or is_quantized4(w)

    def one_layer(layer: Params) -> Params:
        out = dict(layer)
        if all(k in out and _q(out[k]) for k in ("wq", "wk", "wv")):
            out["w_qkv"] = _concat_quantized([out.pop("wq"), out.pop("wk"), out.pop("wv")])
        if all(k in out and _q(out[k]) for k in ("w_gate", "w_up")):
            out["w_gate_up"] = _concat_quantized([out.pop("w_gate"), out.pop("w_up")])
        return out

    out = dict(params)
    out["layers"] = [one_layer(layer) for layer in params["layers"]]
    return out


def _quantize_matrix4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Group-wise int4 where the input dim packs into 256-row blocks,
    int8 otherwise (quantized.py:393-396)."""
    if w.ndim == 2 and w.shape[0] % _PACK_BLOCK == 0:
        return quantize_matrix_int4(w)
    return quantize_matrix(w)


def _quantize_tree(params: Params, dense) -> Params:
    def one_layer(layer: Params) -> Params:
        out = dict(layer)
        for k in _MATRIX_KEYS:
            if k in out and not (is_quantized(out[k]) or is_quantized4(out[k])):
                out[k] = dense(out[k])
        if "moe" in out:
            # Expert stacks int8 whatever ``dense`` is; the router stays fp32.
            moe = dict(out["moe"])
            for k in ("w_gate", "w_up", "w_down"):
                if not is_quantized(moe[k]):
                    moe[k] = quantize_matrix(moe[k])
            out["moe"] = moe
        return out

    out: Params = {
        "embed": quantize_embed(params["embed"]),
        "final_norm": params["final_norm"],
        "layers": [one_layer(layer) for layer in params["layers"]],
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_matrix(params["lm_head"])
    return out


def quantize_params(params: Params) -> Params:
    """Quantize every projection of a full-precision tree to int8 (embed
    per row; norms, biases and MoE routers untouched)."""
    return _quantize_tree(params, quantize_matrix)


def quantize_params_int4(params: Params) -> Params:
    """Quantize the decoder projections to group-wise int4 (int8 where the
    input dim is not a multiple of 256); the embedding stays per-row int8,
    the LM head and MoE expert stacks int8, as in JAX (quantized.py:386-417)."""
    return _quantize_tree(params, _quantize_matrix4)
