"""paddle_tpu_torch — the PyTorch / CUDA port of ``paddle_tpu`` for an
NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package does what
it does in PyTorch, and every kernel the JAX package wrote in Pallas
for the TPU is a kernel written by hand for Hopper (``csrc/``, built by
``nvcc`` for ``sm_90a`` at first use into ``_build/``).  It imports
torch, numpy and the standard library, never jax and nothing of
``paddle_tpu``.  Entry points run on the card unless the caller passes
``device="cpu"`` / ``CPUPlace()``; with no card and no such request they
raise.

Ported so far: the serving path (``serving``, ``models.transformer``,
``kernels.paged_attention``) and the training path — ``Program`` /
``program_guard`` -> ``layers`` -> ``models.transformer.build`` ->
``Executor(place).run`` with autograd and Adam, attention through
``kernels.flash_attention`` — so a training script reads the same with
``import paddle_tpu_torch as pt``; the memory engine
(``memory_optimize``, ``gradient_accumulation``, ``release_memory``) and
``Program.prune`` (``core/ir.py``) as in the JAX package; the v2
training loop (``Trainer`` / ``SGD`` and its events, step checkpoints
with a bit-exact resume, ``Executor.run_steps``), the checkpoint format
(``io``, byte for byte the JAX package's files), the input pipeline
(``reader``, ``DataFeeder``), ``profiler`` and the step telemetry
(``observability.MetricsReporter``); the training recipes: every
optimizer of the JAX package and ``ModelAverage`` (``optimizer``),
gradient and error clipping (``clip``), weight decay (``regularizer``)
and learning-rate schedules (``learning_rate_decay``), and the memory
engine's ``offload`` policy; the recurrent path: ``StaticRNN`` /
``DynamicRNN`` over the ``scan_block`` op, the LSTM, GRU and sequence
ops and layers, ``nets``, and the training programs of
``models.text_classification`` and ``models.seq2seq``; CTC, the CRF and
the image zoo; ``While`` and the tensor arrays with the beam ops, which
drive ``models.seq2seq.build_decode``; the book's small models and the
``dataset`` readers they use; the parameter-server generation:
``distributed`` (RPC, discovery store, sharded pserver, elastic master,
the send/recv transpiler and its trainer), the recordio format with its
native loader (``native``, built with g++ at first use),
``reader.creator.recordio`` / ``cloud_reader``, ``flags``,
``check_gradients`` and the command line (``python -m paddle_tpu_torch
train | pserver | master | version``).
"""

from . import ops as _ops  # noqa: F401  (registers the op lowerings)
from . import (clip, data_feeder, dataset, distributed, flags, initializer,
               io, layers, learning_rate_decay, models, native, nets,
               observability, optimizer, profiler, reader, regularizer,
               resilience, trainer)
from .backward import append_backward
from .checkgrad import check_gradients
from .core.executor import Executor
from .core.place import CPUPlace, CUDAPlace, resolve_device
from .core.program import (Block, OpDesc, Parameter, Program, Variable,
                           default_main_program, default_startup_program,
                           name_scope, program_guard)
from .core.scope import Scope, global_scope, load_numpy_state, scope_guard
from .data_feeder import DataFeeder
from .memory_optimization_transpiler import (gradient_accumulation,
                                             memory_optimize, release_memory)
from .observability.reporter import MetricsReporter
from .param_attr import ParamAttr
from .trainer import (SGD, BeginIteration, BeginPass, EndIteration, EndPass,
                      Trainer)

__all__ = [
    "resolve_device", "Program", "Block", "Variable", "Parameter",
    "OpDesc", "program_guard", "name_scope", "default_main_program",
    "default_startup_program", "Executor", "CPUPlace", "CUDAPlace", "Scope",
    "global_scope", "scope_guard", "load_numpy_state", "append_backward",
    "ParamAttr", "initializer", "layers", "models", "optimizer",
    "memory_optimize", "gradient_accumulation", "release_memory",
    "Trainer", "SGD", "BeginPass", "EndPass", "BeginIteration",
    "EndIteration", "DataFeeder", "MetricsReporter", "io", "reader",
    "profiler", "data_feeder", "observability", "resilience", "trainer",
    "clip", "regularizer", "learning_rate_decay", "nets", "dataset",
    "distributed", "native", "flags", "check_gradients",
]
