"""paddle_tpu_torch.analysis.comm — the sharding & communication
contract analyzer (``paddle_tpu/analysis/comm``).

Every collective a mesh step runs lands in the step's collective log
(``parallel/collectives.py``); :func:`plan_from_log` turns the log into
a :class:`CommPlan` — each collective's kind, mesh axes, bytes, loop
membership, phase and the variable it moved — and :class:`CommContract`
checks a plan against declarative ``expect`` / ``forbid`` /
``forbid_reshard`` rules.  ``Executor.last_comm_plan`` is the last mesh
step's plan; ``comm_diff`` explains which collective moved between two.
"""

from .plan import CommOp, CommPlan, comm_diff, plan_from_log
from .contract import CommContract, attach_comm_contract, comm_contracts

# importing the check module registers the comm checks with the
# analysis framework's registry
from . import checks  # noqa: F401

__all__ = [
    "CommOp", "CommPlan", "plan_from_log", "comm_diff",
    "CommContract", "attach_comm_contract", "comm_contracts",
]
