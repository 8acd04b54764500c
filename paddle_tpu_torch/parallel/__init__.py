"""Multi-device parallelism (``paddle_tpu/parallel``): meshes, the spec
rules that say what each rank holds, the canned communication contracts
of a training step, and sequence, pipeline and expert parallelism.

The port runs one process per rank (``distributed.launch``); the
Executor's mesh path (``spmd.py``) gives each rank its blocks of the
annotated variables and issues the collectives itself
(``collectives.py``), each recorded in the step's collective log.
``ring_attention``, ``pipeline`` / ``pipeline_lm`` and ``moe_ffn`` take
this rank's blocks where the reference's ``shard_map`` takes global
arrays (``spmd.local_block``, ``pipeline.stage_block`` /
``local_batch`` and ``moe.moe_params_from_numpy`` cut them), and issue
their ring shifts and all-to-alls through the same collectives.
``comm_overlap_flags`` / ``enable_comm_overlap`` name the mesh path's
overlap of the boundary reductions with the backward
(``PADDLE_TPU_COMM_OVERLAP``).  The reference's ``_compat.py`` (its
``shard_map`` import shim) has no counterpart.

Mesh axis conventions: dp (data) · fsdp (parameter sharding) · tp
(tensor) · sp (sequence) · pp (pipeline) · ep (expert).
"""

from .mesh import make_mesh, single_host_mesh, axis_size
from .api import (
    compile_shardings,
    data_parallel,
    shard_parameter,
    shard_parameters_by_rule,
    shard_activation,
    replicate,
    P,
    zero_spec_for,
    fsdp_spec_for,
    grad_rs_spec_for,
    shard_fsdp,
    optimizer_state_report,
    sharding_report,
    comm_overlap_flags,
    enable_comm_overlap,
)
from .ring_attention import ring_attention, blockwise_attention
from .pipeline import pipeline, pipeline_lm, stack_stage_params
from .moe import init_moe_params, moe_ffn
from . import contracts, sparse

__all__ = [
    "make_mesh", "single_host_mesh", "axis_size", "compile_shardings",
    "data_parallel", "shard_parameter", "shard_parameters_by_rule",
    "shard_activation", "replicate", "P", "zero_spec_for", "fsdp_spec_for",
    "grad_rs_spec_for", "shard_fsdp", "optimizer_state_report",
    "sharding_report", "comm_overlap_flags", "enable_comm_overlap",
    "ring_attention", "blockwise_attention", "pipeline", "pipeline_lm",
    "stack_stage_params", "init_moe_params", "moe_ffn", "sparse",
    "contracts", "local_shard",
]


def local_shard(tensor):
    """Mark ``tensor`` as this rank's rows of a feed already, so the
    Executor's mesh path takes it as it is (``reader.prefetch_to_device``
    lands cut batches so)."""
    tensor._pt_local_shard = True
    return tensor
