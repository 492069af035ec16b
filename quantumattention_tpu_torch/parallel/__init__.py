"""Mesh parallelism on torch.distributed: TP, ring/Ulysses sequence
parallelism, PP, EP, multi-process bootstrap."""

from .ep import expert_parallel_ffn, moe_param_specs  # noqa: F401
from .mesh import batch_spec, llama_param_specs, make_mesh, shard_params  # noqa: F401
from .multihost import initialize_distributed, local_batch_size, pod_mesh  # noqa: F401
from .pp import pipeline_apply  # noqa: F401
from .ring import ring_attention  # noqa: F401
from .tp import head_parallel_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
