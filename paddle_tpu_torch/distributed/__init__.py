"""Distributed layer — the Go master / pserver generation and the fluid
send/recv transpiler (the port's counterpart of
``paddle_tpu/distributed``; SURVEY §L8, §2.6).

* ``master``: elastic *data* dispatch — a task queue over recordio chunks
  with timeout requeue, failure drop, snapshot/recover (go/master).
* ``pserver``: sharded parameters with sync/async updates, server-side
  optimizers, sparse row updates and checkpoints (go/pserver +
  paddle/pserver/ParameterServer2).
* ``store``: discovery and coordination (the etcd replacement).
* ``transpiler``: one program split into trainer/pserver halves like
  fluid's distribute_transpiler.py:81, and the trainer's send/recv loop.

Transport is a small length-prefixed-pickle TCP RPC (``rpc``), the JAX
package's wire format byte for byte.  The servers and the master are host
code (numpy) in both packages; only the trainer's Executor runs on the
card.  ``launch`` joins the processes of a mesh job into one
``torch.distributed`` process group (``init_multihost``, ``global_mesh``).
"""

from . import launch, rpc
from . import store
from .master import MasterClient, MasterService
from .pserver import ParameterServer, PServerClient
from .transpiler import DistributedTrainer, DistributeTranspiler

__all__ = [
    "launch", "rpc", "store", "MasterService", "MasterClient", "ParameterServer",
    "PServerClient", "DistributeTranspiler", "DistributedTrainer",
]
