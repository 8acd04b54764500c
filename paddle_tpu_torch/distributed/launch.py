"""Multi-process launch (``paddle_tpu/distributed/launch.py``; reference
analogs: the MPI/fabric cluster launchers and the trainer flags
``--trainer_id --num_gradient_servers``).

Every process joins one ``torch.distributed`` process group, then the SAME
program runs on each over the global mesh:

    # on every process (one per rank, e.g. under torchrun)
    from paddle_tpu_torch.distributed import launch
    launch.init_multihost(coordinator="host0:1234",
                          num_processes=N, process_id=i)
    mesh = launch.global_mesh({"dp": 4, "tp": N // 4})
    exe = pt.Executor(pt.CUDAPlace(), mesh=mesh)

The backend is NCCL on the card and gloo on the CPU (``backend=`` to
choose: gloo with CUDA tensors lets several ranks share one card).
``coordinator`` is ``host:port`` (a TCP store on rank 0) or
``file:///path`` (a file store every process can reach).

Environment fallback: with torchrun's variables set (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), ``init_multihost()`` with no
arguments reads them.  A single process (no variables, or
``num_processes=1``) is a no-op success, so the same script runs
unmodified on one device.
"""

import os

__all__ = ["init_multihost", "global_mesh", "is_initialized"]

_initialized = False
_init_args = (None, None, None)


def is_initialized():
    return _initialized


def _default_backend():
    import torch

    return "nccl" if torch.cuda.is_available() else "gloo"


def init_multihost(coordinator=None, num_processes=None, process_id=None,
                   backend=None, timeout=None):
    """Join (or start, on process 0) the process group.  Idempotent for
    the same arguments; a conflicting second call raises."""
    global _initialized, _init_args
    import datetime

    import torch.distributed as dist

    explicit = coordinator is not None or num_processes is not None
    if _initialized:
        args = (coordinator, num_processes, process_id)
        if explicit and args != _init_args and _init_args == (None,) * 3:
            raise RuntimeError(
                "init_multihost() already ran without coordinator args; "
                "call it with explicit arguments first")
        if explicit and _init_args != (None,) * 3 and args != _init_args:
            raise RuntimeError(
                f"init_multihost() already initialized with {_init_args}; "
                f"conflicting re-init with {args}")
        return
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if (process_id not in (None, 0) and coordinator is None
            and num_processes in (None, 1)):
        raise ValueError(
            "process_id/RANK > 0 but no coordinator address and world "
            "size — a partial multi-process configuration; set "
            "MASTER_ADDR and WORLD_SIZE too")
    if coordinator is None and num_processes in (None, 1):
        _initialized = True           # one process: nothing to join
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            f"init_multihost needs coordinator, num_processes and "
            f"process_id (got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r})")
    if coordinator.startswith("file://"):
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend or _default_backend(), init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)
    _init_args = (coordinator, num_processes, process_id)
    _initialized = True


def global_mesh(axes, devices=None):
    """Mesh over every rank of the process group.  ``axes`` maps axis
    name -> size; one size may be -1 to absorb the remaining ranks."""
    from ..parallel.mesh import make_mesh

    return make_mesh(axes, devices=devices)
