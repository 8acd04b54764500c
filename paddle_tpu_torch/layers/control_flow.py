"""Control-flow layers (``paddle_tpu/layers/control_flow.py``).

``StaticRNN`` records a sub-block in the program and a ``scan_block``
op that runs it once a time step (``ops/control_flow_ops.py``);
``DynamicRNN`` is the same construct, as in the reference, with the
padded steps of each sample frozen by ``set_sequence_length``.
``While`` records a sub-block and a ``while`` op that runs it while its
condition holds; the tensor arrays are preallocated ``[max_len, ...]``
tensors that ``array_write`` writes a row of.  ``ParallelDo`` records
its block and a ``parallel_do`` op that runs it inline: on a mesh the
batch's sharding (``parallel.data_parallel``) does the parallel part, as
in the reference.
"""

import contextlib

from ..core import unique_name
from . import tensor as tensor_layers
from .layer_helper import LayerHelper, seq_length
from .ops import less_than  # noqa: F401  (re-exported, as the reference)
from .tensor import increment  # noqa: F401  (re-exported, as the reference)

__all__ = [
    "While",
    "StaticRNN",
    "DynamicRNN",
    "array_write",
    "array_read",
    "array_length",
    "create_array",
    "increment",
    "less_than",
    "max_sequence_len",
    "ParallelDo",
]


def create_array(dtype, max_len, shape):
    """A tensor array: a ``[max_len] + shape`` tensor of zeros (the
    reference's LoDTensorArray with a static capacity)."""
    return tensor_layers.fill_constant([max_len] + list(shape), dtype, 0.0)


def array_write(x, i, array):
    """Row ``i`` (a one-element int variable) of ``array`` set to ``x``;
    returns ``array``."""
    helper = LayerHelper("array_write")
    helper.append_op(
        type="array_write",
        inputs={"X": [x.name], "I": [i.name], "Array": [array.name]},
        outputs={"Out": [array.name]},
    )
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype, list(array.shape[1:]))
    helper.append_op(
        type="array_read",
        inputs={"Array": [array.name], "I": [i.name]},
        outputs={"Out": [out.name]},
    )
    return out


def array_length(array):
    """The array's capacity ``[1]``."""
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable("int64", [1], stop_gradient=True)
    helper.append_op(
        type="array_length", inputs={"Array": [array.name]},
        outputs={"Out": [out.name]},
    )
    return out


def max_sequence_len(x):
    """The longest sequence of a padded batch ``[1]`` (its ``@LENGTH``'s
    max)."""
    helper = LayerHelper("max_sequence_len")
    ln = seq_length(x)
    out = helper.create_tmp_variable("int32", [1], stop_gradient=True)
    helper.append_op(
        type="reduce_max", inputs={"X": [ln.name]},
        outputs={"Out": [out.name]},
        attrs={"reduce_all": True, "keep_dim": True},
    )
    return out


class While:
    """The while loop (the reference's ``control_flow.py:583``):

        cond = layers.fill_constant([1], "bool", 1.0)
        w = While(cond)
        with w.block():
            ...                              # ops of one trip
            layers.assign(new_cond, cond)    # update the condition

    The carried state is the condition and every variable the block
    writes that existed before it; a trip must keep their shapes."""

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    @contextlib.contextmanager
    def block(self):
        prog = self.helper.main_program
        parent = prog.current_block()
        sub = prog.create_block()
        yield
        prog.rollback()
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var.name]},
            outputs={},
            attrs={"sub_block": sub.idx},
        )


class ParallelDo:
    """The reference's ``parallel_do`` (scatter over places, run the block
    per place, gather).  The same program runs on every rank of a mesh,
    so this records its block and a ``parallel_do`` op that runs it
    inline; pair it with ``parallel.data_parallel`` for the ranks to
    take their rows of the batch."""

    def __init__(self, places=None, name=None):
        self.helper = LayerHelper("parallel_do", name=name)
        self.places = places
        self._inputs = []

    @contextlib.contextmanager
    def do(self):
        prog = self.helper.main_program
        parent = prog.current_block()
        sub = prog.create_block()
        yield
        prog.rollback()
        parent.append_op(
            type="parallel_do",
            inputs={"X": self._inputs},
            outputs={},
            attrs={"sub_block": sub.idx},
        )

    def read_input(self, x):
        self._inputs.append(x.name)
        return x

    def write_output(self, o):
        return o


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
