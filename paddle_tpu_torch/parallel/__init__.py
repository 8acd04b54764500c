"""Multi-device parallelism (``paddle_tpu/parallel``): meshes, the spec
rules that say what each rank holds, and the canned communication
contracts of a training step.

The port runs one process per rank (``distributed.launch``); the
Executor's mesh path (``spmd.py``) gives each rank its blocks of the
annotated variables and issues the collectives itself
(``collectives.py``), each recorded in the step's collective log.

Mesh axis conventions: dp (data) · fsdp (parameter sharding) · tp
(tensor) · sp (sequence) · pp (pipeline) · ep (expert).  Sequence,
pipeline and expert parallelism (the reference's ``ring_attention``,
``pipeline`` and ``moe``) and ``comm_overlap_flags`` /
``enable_comm_overlap`` are not ported yet.
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
)
from . import contracts, sparse

__all__ = [
    "make_mesh", "single_host_mesh", "axis_size", "compile_shardings",
    "data_parallel", "shard_parameter", "shard_parameters_by_rule",
    "shard_activation", "replicate", "P", "zero_spec_for", "fsdp_spec_for",
    "grad_rs_spec_for", "shard_fsdp", "optimizer_state_report",
    "sharding_report", "sparse", "contracts", "local_shard",
]


def local_shard(tensor):
    """Mark ``tensor`` as this rank's rows of a feed already, so the
    Executor's mesh path takes it as it is (``reader.prefetch_to_device``
    lands cut batches so)."""
    tensor._pt_local_shard = True
    return tensor
