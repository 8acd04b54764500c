"""Control-flow layers (``paddle_tpu/layers/control_flow.py``).

``StaticRNN`` records a sub-block in the program and a ``scan_block``
op that runs it once a time step (``ops/control_flow_ops.py``);
``DynamicRNN`` is the same construct, as in the reference, with the
padded steps of each sample frozen by ``set_sequence_length``.
``While``, ``ParallelDo``, the tensor arrays and ``max_sequence_len``
come with the seq2seq beam decode (``ROADMAP.md`` A9) and raise,
naming it.
"""

import contextlib

from ..core import unique_name
from .layer_helper import LayerHelper
from .ops import less_than  # noqa: F401  (re-exported, as the reference)

__all__ = [
    "While",
    "StaticRNN",
    "DynamicRNN",
    "array_write",
    "array_read",
    "array_length",
    "create_array",
    "less_than",
    "max_sequence_len",
    "ParallelDo",
]

_LATER = ("{} comes with the seq2seq beam decode (while, conditional_block, "
          "the tensor arrays, beam_search; ROADMAP.md A9), not ported yet")


def _not_ported(what):
    def f(*_args, **_kwargs):
        raise NotImplementedError(_LATER.format(what))

    f.__name__ = what
    return f


create_array = _not_ported("create_array")
array_write = _not_ported("array_write")
array_read = _not_ported("array_read")
array_length = _not_ported("array_length")
max_sequence_len = _not_ported("max_sequence_len")


class While:
    """The reference's ``while`` loop construct; not ported yet."""

    def __init__(self, cond, name=None):
        raise NotImplementedError(_LATER.format("While"))


class ParallelDo:
    """The reference's ``parallel_do`` construct; not ported yet."""

    def __init__(self, places=None, name=None):
        raise NotImplementedError(_LATER.format("ParallelDo"))


class StaticRNN:
    """Scan-based RNN construct: step inputs are time slices of sequence
    tensors; memories are carried from step to step.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # [b, t, d] -> [b, d]
            h = rnn.memory(init=h0)          # carried [b, h]
            h_new = layers.fc([x_t, h], ...)
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        out = rnn()                          # [b, t, h]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._x_outer = []
        self._x_inner = []
        self._init_outer = []
        self._state_names = []
        self._out_names = []
        self._outputs = []
        self._sub = None
        self._parent = None
        self._length_name = None

    def set_sequence_length(self, length_var):
        """Freeze carried states past each sample's length (the LoD
        semantics: padded steps do not advance memories)."""
        self._length_name = length_var.name

    @contextlib.contextmanager
    def step(self):
        prog = self.helper.main_program
        self._parent = prog.current_block()
        self._sub = prog.create_block()
        yield
        prog.rollback()
        attrs = {
            "sub_block": self._sub.idx,
            "x_names": self._x_inner,
            "state_names": self._state_names,
            "out_names": self._out_names,
            "reverse": False,
        }
        if self._length_name is not None:
            attrs["length_name"] = self._length_name
        self._parent.append_op(
            type="scan_block",
            inputs={"X": self._x_outer, "Init": self._init_outer},
            outputs={"Out": [o.name for o in self._outputs]},
            attrs=attrs,
        )

    def step_input(self, x):
        """``x [b, t, ...]``; returns the per-step slice ``[b, ...]``."""
        inner = self._sub.create_var(
            name=unique_name.generate(f"{self.helper.name}.step_in"),
            dtype=x.dtype,
            shape=[x.shape[0]] + list(x.shape[2:]),
        )
        self._x_outer.append(x.name)
        self._x_inner.append(inner.name)
        return inner

    def memory(self, init):
        """A carried state, first ``init`` ``[b, d]``."""
        mem = self._sub.create_var(
            name=unique_name.generate(f"{self.helper.name}.mem"),
            dtype=init.dtype,
            shape=list(init.shape),
        )
        self._init_outer.append(init.name)
        self._state_names.append(mem.name)
        return mem

    def update_memory(self, mem, new_val):
        self._sub.append_op(
            type="assign", inputs={"X": [new_val.name]},
            outputs={"Out": [mem.name]}
        )

    def step_output(self, o):
        self._out_names.append(o.name)
        outer = self._parent.create_var(
            name=unique_name.generate(f"{self.helper.name}.out"),
            dtype=o.dtype,
            shape=[o.shape[0], -1] + list(o.shape[1:]),
        )
        self._outputs.append(outer)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


# The reference's DynamicRNN sorts by length into a rank table and shrinks
# the batch each step; over a padded batch the masked StaticRNN computes
# the same, so DynamicRNN is StaticRNN, as in the JAX package.
DynamicRNN = StaticRNN
