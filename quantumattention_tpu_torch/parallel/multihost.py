"""Process-group bootstrap and pod meshes (counterpart of
quantumattention_tpu/parallel/multihost.py).

``initialize_distributed`` is ``jax.distributed.initialize``'s place: it
brings up the default ``torch.distributed`` process group, reading
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` the
way the JAX package reads its ``JAX_*`` variables, and does nothing in a
single process.  The backend is NCCL when every rank has a card of its
own, else gloo (CPU ranks, or several ranks sharing a card, each on
``cuda:(rank % count)``); the choice is printed.

``pod_mesh`` lays the axes out slowest first: dp outermost, then sp, then
tp innermost, so the per-layer collectives ride the closest ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import axis_size, make_mesh

#: Seconds a collective may wait before it fails (init_process_group's).
TIMEOUT_S = 60


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[str]:
    """Bring up the default process group; returns its backend, or None
    when there is nothing to bring up (a single process, or no
    configuration at all).

    ``coordinator_address``: ``host:port`` (a TCP store) or an init-method
    URL (``tcp://...``, ``file://...``); else ``MASTER_ADDR:MASTER_PORT``.
    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` / ``RANK``.
    A collective that waits longer than ``TIMEOUT_S`` fails."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is not None and num_processes <= 1 and coordinator_address is None:
        return None  # explicit single process: nothing to bring up
    if num_processes is None and coordinator_address is None:
        return None  # no distributed configuration at all
    if dist.is_initialized():
        return dist.get_backend()
    if num_processes is None or process_id is None or coordinator_address is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the number "
            "of processes and this process's id (arguments or MASTER_ADDR, "
            "WORLD_SIZE, RANK)"
        )
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if count >= num_processes else "gloo"
    where = "cpu"
    if count:
        torch.cuda.set_device(process_id % count)
        where = f"cuda:{process_id % count}"
    print(f"initialize_distributed: rank {process_id} of {num_processes}, backend {backend}, "
          f"device {where}", flush=True)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return backend


def pod_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "sp", "tp"),
    device_type: Optional[str] = None,
):
    """Mesh over every rank of the job, slowest axis first: dp outermost,
    then sp, then tp innermost.  ``tp=None`` absorbs the remaining ranks."""
    n = dist.get_world_size()
    if tp is None:
        if n % (dp * sp) != 0:
            raise ValueError(f"device count {n} not divisible by dp*sp = {dp * sp}")
        tp = n // (dp * sp)
    if dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp = {dp * sp * tp} != device count {n}")
    return make_mesh((dp, sp, tp), axis_names, device_type)


def local_batch_size(global_batch: int, mesh, axis: str = "dp") -> int:
    n = axis_size(mesh, axis)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {axis}={n}")
    return global_batch // n
