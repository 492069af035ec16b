"""Device meshes, Megatron parameter layouts and the collectives of the
parallel layer (counterpart of quantumattention_tpu/parallel/mesh.py).

The JAX package names a ``jax.sharding.Mesh``, gives every parameter a
PartitionSpec, and lets GSPMD insert the collectives.  Here a mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of one process group,
every rank holds only its own slice of each sharded tensor
(:func:`shard_params`), and the collectives are written out: the helpers
below sum, gather, swap, shift and broadcast over one named axis.

Axes, as in JAX:
  * ``dp``: data parallel, the batch of activations;
  * ``tp``: tensor parallel, attention heads and the MLP's intermediate
    columns (Megatron column/row split; a rank keeps whole GQA groups);
  * ``sp``: sequence parallel, consumed by ring or Ulysses attention;
  * ``pp`` and ``ep``: pipeline stages and experts (``parallel/pp.py``,
    ``parallel/ep.py``).

A spec is :class:`P`, a tuple naming the mesh axis that splits each
dimension (None: replicated), as JAX's ``PartitionSpec``.

Collectives over a gloo group (CPU ranks, or several ranks sharing one
card) run on host memory: a CUDA tensor is copied to the host and back,
and :data:`staged_bytes` counts those copies.  Over NCCL the collective
runs on the device.  Sums run in fp32 whatever the tensor's dtype; every
other collective moves raw bytes, so any dtype (fp8 included) travels.

The model's collectives go through :class:`Axis`, whose methods are
autograd Functions, Megatron's pairs (GSPMD inserts them in JAX): the sum
("g") passes its gradient through, the gather hands each rank its slice of
the gradient, and :meth:`Axis.copy` ("f") is the identity whose gradient
is summed.  Their forwards are the plain collectives above, so serving
under ``torch.no_grad`` computes the same bytes.  :func:`all_reduce_`
sums a training step's gradients over dp in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.llama import LlamaConfig
from ..utils import checks

#: Bytes copied between a card and host memory by collectives over gloo.
staged_bytes = 0


class P(tuple):
    """A partition spec: the mesh axis that splits each dimension, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    device_type: Optional[str] = None,
):
    """A named ``DeviceMesh`` over every rank of the default process group
    (``parallel/multihost.initialize_distributed`` brings it up).

    With no ``shape`` all ranks go to the last axis (pure TP).  The device
    type is the card unless the caller asks for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "parallel.multihost.initialize_distributed first"
        )
    world = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (world,)
    shape = tuple(int(s) for s in shape)
    need = 1
    for s in shape:
        need *= s
    if need > world:
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {world}")
    if need < world:
        raise ValueError(
            f"mesh shape {shape} covers {need} of the {world} ranks; every rank "
            "must be in the mesh"
        )
    device_type = checks.default_device(device_type).type
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(_dim(mesh, axis))


def _group(mesh, axis: str):
    return mesh.get_group(_dim(mesh, axis))


def _global_rank(mesh, axis: str, index: int) -> int:
    """The process-group rank of coordinate ``index`` along ``axis`` (the
    other coordinates this rank's own)."""
    return dist.get_process_group_ranks(_group(mesh, axis))[index]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named axis of a mesh seen from this rank: its size, this rank's
    coordinate, and the collectives over it.  The model's tensor-parallel
    forward takes one (``models/llama``'s ``tp`` arguments)."""

    mesh: Any
    name: str

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.name)

    @property
    def rank(self) -> int:
        return axis_rank(self.mesh, self.name)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "g": the sum over the axis; the gradient passes
        through unchanged."""
        return _AllReduce.apply(x, self.mesh, self.name)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``; the gradient is
        this rank's slice of the incoming one."""
        return _AllGather.apply(x, self.mesh, self.name, dim)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "f": ``x`` itself (a view); the gradient is summed
        over the axis.  It goes at the input of a column-parallel product,
        whose rank computes only a partial gradient of that input."""
        return _Copy.apply(x, self.mesh, self.name)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        return broadcast(x, self.mesh, self.name, src)


def axis(mesh, name: str) -> Axis:
    _dim(mesh, name)
    return Axis(mesh, name)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global staged_bytes
    staged_bytes += t.numel() * t.element_size()
    return t.cpu()


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    global staged_bytes
    staged_bytes += t.numel() * t.element_size()
    return t.to(device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's contents as a flat uint8 tensor (a copy where needed)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like_dtype, shape) -> torch.Tensor:
    return b.view(like_dtype).reshape(shape)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (a new tensor of x's dtype; the sum runs
    in fp32 for 8- and 16-bit floats)."""
    group = _group(mesh, axis)
    wide = x.is_floating_point() and x.element_size() < 4
    work = x.to(torch.float32 if wide else x.dtype, copy=True).contiguous()
    staged = _staged(work, group)
    buf = _to_host(work) if staged else work
    dist.all_reduce(buf, group=group)
    out = _to_device(buf, x.device) if staged else buf
    return out.to(x.dtype)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
    coordinate order."""
    group = _group(mesh, axis)
    n = axis_size(mesh, axis)
    flat = _bytes(x)
    staged = _staged(x, group)
    if staged:
        flat = _to_host(flat)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    out = torch.cat([_from_bytes(p, x.dtype, x.shape) for p in parts], dim=dim)
    return _to_device(out, x.device) if staged else out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.start = axis_rank(mesh, axis) * ctx.width
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.width), None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axis), None, None


#: The most elements one collective of :func:`all_reduce_` moves (256 MB
#: of fp32): a large tensor is summed piece by piece, so neither the card
#: nor host memory ever holds a second fp32 copy of all of it.
BUCKET_ELEMENTS = 64 * 2**20


def all_reduce_(tensors: Sequence[Optional[torch.Tensor]], mesh, axis: str) -> None:
    """Sum each tensor over ``axis`` in place (None entries skipped), one
    tensor at a time and each in pieces of at most :data:`BUCKET_ELEMENTS`,
    in fp32 as :func:`all_reduce`."""
    for t in tensors:
        if t is None:
            continue
        flat = t.view(-1)
        for start in range(0, flat.numel(), BUCKET_ELEMENTS):
            piece = flat[start : start + BUCKET_ELEMENTS]
            piece.copy_(all_reduce(piece, mesh, axis))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` is cut into n chunks
    along ``split_dim``, chunk j goes to coordinate j, and the chunks that
    arrive are concatenated along ``concat_dim`` in coordinate order.  The
    chunks are stacked on a leading dimension for ``all_to_all_single``."""
    group = _group(mesh, axis)
    n = axis_size(mesh, axis)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"dim {split_dim} of size {x.shape[split_dim]} does not split over the "
            f"'{axis}' axis size ({n})"
        )
    chunks = torch.stack(x.chunk(n, dim=split_dim))
    send = _bytes(chunks)
    staged = _staged(x, group)
    if staged:
        send = _to_host(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    parts = _from_bytes(recv, x.dtype, chunks.shape).unbind(0)
    out = torch.cat(parts, dim=concat_dim)
    return _to_device(out, x.device) if staged else out


def shift(tensors: Sequence[torch.Tensor], mesh, axis: str, wrap: bool = True) -> List[torch.Tensor]:
    """Send ``tensors`` to coordinate rank + 1 and return what rank - 1
    sent (``jax.lax.ppermute`` with ``i -> i + 1``), in one batched
    send/receive of their bytes.  ``wrap``: the last coordinate sends to 0;
    without it the last sends nothing and coordinate 0 gets zeros."""
    group = _group(mesh, axis)
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    flats = [_bytes(t) for t in tensors]
    send = torch.cat(flats) if len(flats) > 1 else flats[0]
    staged = _staged(send, group)
    if staged:
        send = _to_host(send)
    recv = torch.zeros_like(send)
    ops = []
    if wrap or r + 1 < n:
        ops.append(dist.P2POp(dist.isend, send, _global_rank(mesh, axis, (r + 1) % n), group))
    if wrap or r > 0:
        ops.append(dist.P2POp(dist.irecv, recv, _global_rank(mesh, axis, (r - 1) % n), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        recv = _to_device(recv, tensors[0].device)
    out, at = [], 0
    for t, f in zip(tensors, flats):
        seg = recv[at : at + f.numel()]
        if at % t.element_size():
            seg = seg.clone()  # a dtype view needs an aligned offset
        out.append(_from_bytes(seg, t.dtype, t.shape))
        at += f.numel()
    return out


def broadcast(x: torch.Tensor, mesh, axis: str, src: int = 0) -> torch.Tensor:
    """Coordinate ``src``'s ``x`` on every rank of ``axis``."""
    group = _group(mesh, axis)
    flat = _bytes(x).clone()
    staged = _staged(x, group)
    if staged:
        flat = _to_host(flat)
    dist.broadcast(flat, src=_global_rank(mesh, axis, src), group=group)
    out = _from_bytes(flat, x.dtype, x.shape)
    return _to_device(out, x.device) if staged else out


# ---------------------------------------------------------------------------
# Parameter layouts
# ---------------------------------------------------------------------------


def llama_param_specs(cfg: LlamaConfig, axis: str = "tp") -> Any:
    """Spec tree matching ``models.llama.init_params`` (mesh.py:48-89).

    Megatron layout on the ``tp`` axis: the Q/K/V projections, the MLP's
    gate and up and the LM head split by column (heads and intermediate
    columns across ranks), the output projection and the MLP's down
    projection by row (partial sums, summed after the product), the
    embedding by vocabulary; norms and the MoE router replicated."""
    layer = {
        "attn_norm": P(),
        "wq": P(None, axis),
        "wk": P(None, axis),
        "wv": P(None, axis),
        "wo": P(axis, None),
        "mlp_norm": P(),
    }
    if cfg.num_experts > 0:
        # Every expert's SwiGLU takes the same column/row split on its
        # trailing dims; the expert axis belongs to ``parallel/ep``.
        layer["moe"] = {
            "w_router": P(),
            "w_gate": P(None, None, axis),
            "w_up": P(None, None, axis),
            "w_down": P(None, axis, None),
        }
    else:
        layer.update(w_gate=P(None, axis), w_up=P(None, axis), w_down=P(axis, None))
    if cfg.qkv_bias:
        layer.update(bq=P(axis), bk=P(axis), bv=P(axis))
    specs = {
        "embed": P(axis, None),
        "final_norm": P(),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, axis)
    return specs


def quantized_specs(params: Any, specs: Any) -> Any:
    """``specs`` expanded over a tree that may hold quantized leaves
    (mesh.py:92-122): int8 codes take the matrix's spec and the scale the
    same with every size-1 dimension unsharded (per-output-channel
    keepdims: wq's s (1, out) splits with the columns, wo's s (1, in) is
    replicated, the embedding's (V, 1) splits with the vocabulary); int4
    codes and group scales take the matrix's spec alike.  Fused
    ``w_qkv``/``w_gate_up`` trees are refused."""
    from ..models import quantized as qz

    def walk(p: Any, s: Any) -> Any:
        if qz.is_quantized(p):
            scale = p["s"]
            axes = list(s) + [None] * (scale.ndim - len(s))
            return {"q": s, "s": P(*[a if scale.shape[i] != 1 else None
                                     for i, a in enumerate(axes[: scale.ndim])])}
        if qz.is_quantized4(p):
            return {"q4": s, "s": s}
        if isinstance(p, dict):
            if "w_qkv" in p or "w_gate_up" in p:
                raise ValueError(
                    "fused projection trees (quantized.fuse_projections) "
                    "cannot be tensor-parallel sharded: the tp column "
                    "shard of a concatenated [gate|up] puts all-gate "
                    "halves on chip 0 — fuse only for single-chip serving"
                )
            return {k: walk(v, s[k]) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(a, b) for a, b in zip(p, s)]
        return s

    return walk(params, specs)


def param_specs_for(params: Any, cfg: LlamaConfig, axis: str = "tp") -> Any:
    """:func:`llama_param_specs` adapted to a tree that may hold w8a16 or
    w4a16 leaves (:func:`quantized_specs`)."""
    return quantized_specs(params, llama_param_specs(cfg, axis))


def shard(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` (a copy, so the
    whole tensor can be freed)."""
    n = axis_size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of size {t.shape[dim]} must be divisible by the "
            f"'{axis}' axis size ({n})"
        )
    part = t.shape[dim] // n
    return t.narrow(dim, axis_rank(mesh, axis) * part, part).clone()


def shard_tensor(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = shard(t, mesh, ax, dim)
    return t


def shard_params(params: Any, mesh, specs: Any) -> Any:
    """This rank's local slices of a parameter tree under ``specs``
    (replicated leaves stay as they are).  An int4 matrix split by rows
    must keep whole 256-row packing blocks a rank."""
    from ..models import quantized as qz

    def walk(p: Any, s: Any) -> Any:
        if qz.is_quantized4(p) and s["q4"] and s["q4"][0] is not None:
            n = axis_size(mesh, s["q4"][0])
            if p["q4"].shape[0] % (n * qz._PACK_BLOCK // 2):
                raise ValueError(
                    f"an int4 matrix of {2 * p['q4'].shape[0]} rows cannot split by rows over "
                    f"the '{s['q4'][0]}' axis size ({n}): each rank needs whole "
                    f"{qz._PACK_BLOCK}-row packing blocks"
                )
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(a, b) for a, b in zip(p, s)]
        return shard_tensor(p, mesh, s) if any(a is not None for a in s) else p

    return walk(params, specs)


def batch_spec() -> P:
    """Activations and tokens: batch over dp, everything else replicated."""
    return P("dp", None)
