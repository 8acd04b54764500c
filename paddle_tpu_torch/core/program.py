"""Program / Block / Variable / OpDesc — program-as-data (the port's copy
of ``paddle_tpu/core/program.py``; pure Python, same names and fields, so
both packages build identical programs).

A Program is a recipe: the Executor walks a block, calls each op's
torch implementation eagerly, differentiates the forward prefix with
autograd at the backward marker and runs the optimizer ops in place.

Variable-length sequences: a Variable may carry ``lod_level > 0``; the
convention is a shadow int32 variable ``<name>@LENGTH`` of shape [batch]
(padded dense data + explicit lengths).  ``Block.length_var``
creates/finds it.
"""

import collections
import itertools
import contextlib
import copy

import numpy as np

from . import unique_name
from .dtypes import convert_dtype

LENGTH_SUFFIX = "@LENGTH"
SUBLENGTH_SUFFIX = "@SUBLENGTH"
GRAD_SUFFIX = "@GRAD"
# sparse input slots feed as two shadow arrays (ids + weights) — the
# no-densify path for reference sparse_binary/float_vector inputs
IDS_SUFFIX = "@IDS"
VALS_SUFFIX = "@VALS"


class Variable:
    """A named, statically-shaped tensor slot in a Block."""

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        lod_level=0,
        persistable=False,
        stop_gradient=False,
        is_data=False,
        initializer=None,
    ):
        self.block = block
        self.name = name or unique_name.generate("tmp")
        self.shape = tuple(int(s) if s is not None and s >= 0 else -1 for s in (shape or ()))
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        # Optional sharding annotation, set by the parallel layer.
        self.partition_spec = None

    @property
    def program(self):
        return self.block.program

    def grad_name(self):
        return self.name + GRAD_SUFFIX

    def length_var(self):
        """The shadow sequence-length variable (lod replacement)."""
        return self.block.length_var(self)

    def sub_length_var(self):
        """The shadow inner-level length variable (2-level lod)."""
        return self.block.sub_length_var(self)

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, "
            f"dtype={self.dtype.name}, lod_level={self.lod_level}, "
            f"persistable={self.persistable})"
        )

    # Arithmetic sugar (fluid gained this later; users expect it).
    def _binary(self, other, op):
        from .. import layers

        if not isinstance(other, Variable):
            other = layers.fill_constant(
                shape=[1], dtype=self.dtype, value=float(other)
            )
        return getattr(layers, op)(self, other)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    __radd__ = __add__
    __rmul__ = __mul__

    def __rtruediv__(self, other):
        from .. import layers

        const = layers.fill_constant(
            shape=[1], dtype=self.dtype, value=float(other)
        )
        return layers.elementwise_div(const, self)

    def __rsub__(self, other):
        from .. import layers

        return layers.scale(self, scale=-1.0, bias=float(other))

    def __neg__(self):
        from .. import layers

        return layers.scale(self, scale=-1.0)


class Parameter(Variable):
    """A trainable persistable variable (fluid/framework.py:931)."""

    def __init__(self, block, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        kwargs.setdefault("persistable", True)
        super().__init__(block, **kwargs)


class OpDesc:
    """One operator invocation: type + named input/output var lists + attrs.

    ``inputs`` / ``outputs`` map slot name -> list of variable names
    (duplicable slots, e.g. ``sum``'s X, hold several; reference
    OpProto.Var.duplicable, framework.proto:70).
    """

    def __init__(self, op_type, inputs=None, outputs=None, attrs=None):
        self.type = op_type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # "forward" | "optimize": optimize-role ops (param/state updates
        # appended by minimize, ModelAverage, ...) are stripped by
        # clone(for_test=True); position alone can't distinguish them
        # from eval-only ops appended after minimize.
        self.role = "forward"

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"Op({self.type}, in={ins}, out={outs}, attrs={list(self.attrs)})"


def _as_name_list(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []
        # Index into ``ops`` where the backward pass conceptually sits: ops
        # before it are the forward program, ops at/after it run with
        # ``<param>@GRAD`` variables available (optimizer/regularizer/clip
        # ops).  None until append_backward marks it.
        self.backward_index = None

    @property
    def parent(self):
        return self.program.blocks[self.parent_idx] if self.parent_idx >= 0 else None

    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        if var.name in self.vars:
            raise ValueError(f"variable {var.name!r} already exists in block {self.idx}")
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        # Parameters always live in the top-level (global) block, like the
        # reference where sub-block programs reference outer-scope params.
        gb = self.program.global_block()
        param = Parameter(gb, **kwargs)
        if param.name in gb.vars:
            raise ValueError(f"parameter {param.name!r} already exists")
        gb.vars[param.name] = param
        return param

    def var(self, name):
        v = self._find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def _find_var(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent
        return None

    def has_var(self, name):
        return self._find_var(name) is not None

    def length_var(self, var):
        """Create/find the shadow ``<name>@LENGTH`` int32 [batch] variable."""
        name = var.name + LENGTH_SUFFIX
        existing = self._find_var(name)
        if existing is not None:
            return existing
        batch = var.shape[0] if var.shape else -1
        owner = var.block
        lv = Variable(
            owner, name=name, shape=(batch,), dtype="int32", is_data=var.is_data,
            stop_gradient=True,
        )
        owner.vars[name] = lv
        return lv

    def sub_length_var(self, var):
        """Create/find the shadow ``<name>@SUBLENGTH`` int32 [batch, s]
        variable — the INNER level's per-sub-sequence lengths of a
        2-level (nested) sequence batch [b, s, t, ...] (reference
        ``Argument.subSequenceStartPositions``, Argument.h:84-86;
        ``lod_tensor.h:58``'s second LoD level)."""
        name = var.name + SUBLENGTH_SUFFIX
        existing = self._find_var(name)
        if existing is not None:
            return existing
        batch = var.shape[0] if var.shape else -1
        s = var.shape[1] if len(var.shape) > 1 else -1
        owner = var.block
        lv = Variable(
            owner, name=name, shape=(batch, s), dtype="int32",
            is_data=var.is_data, stop_gradient=True,
        )
        owner.vars[name] = lv
        return lv

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items() if v is not None}
        outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items() if v is not None}
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items() if v is not None}
        outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items() if v is not None}
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        if self.backward_index is not None:
            self.backward_index += 1
        self.program._bump_version()
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={len(self.ops)}, vars={len(self.vars)})"


_program_serial = itertools.count()


class Program:
    """A list of blocks; block 0 is the global block (framework.py:789)."""

    def __init__(self):
        # unique across the process lifetime — id() can be reused after GC,
        # which would poison the Executor's compile cache
        self._serial = next(_program_serial)
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._seed_counter = 0
        # Filled by append_backward: {block_idx: {"loss": name,
        #   "params": [names], "grad_map": {pname: gname}}}
        self._backward_info = {}

    # -- structure ---------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def next_seed(self):
        """Deterministic per-op seed stream for random ops."""
        self._seed_counter += 1
        return (self.random_seed, self._seed_counter)

    # -- queries -----------------------------------------------------------
    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def persistable_vars(self):
        return [v for v in self.global_block().vars.values() if v.persistable]

    # -- transformations ---------------------------------------------------
    def clone(self, for_test=False):
        """Deep copy; ``for_test=True`` flips ``is_test`` attrs AND strips
        everything from the backward marker on (grad, optimizer, and any
        later state-update ops) so evaluating the clone cannot mutate
        parameters (the analog of the reference's inference_optimize,
        pybind.cc:299)."""
        p = copy.deepcopy(self)  # fresh _serial via __setstate__
        if for_test:
            for blk in p.blocks:
                blk.ops = [op for op in blk.ops
                           if getattr(op, "role", "forward") != "optimize"]
                blk.backward_index = None
                for op in blk.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
            p._backward_info = {}
        return p

    def __setstate__(self, state):
        # fresh identity on deepcopy/unpickle: the Executor caches compiled
        # steps keyed on (_serial, _version); a copy must never collide.
        self.__dict__.update(state)
        self._serial = next(_program_serial)

    def prune(self, targets):
        """Backward-slice the global block to ops needed for ``targets``
        (reference framework/prune.cc, pybind.cc:289)."""
        from .ir import prune_program

        return prune_program(self, targets)

    def to_string(self, throw_on_error=False):
        lines = []
        for blk in self.blocks:
            lines.append(f"// block {blk.idx} (parent {blk.parent_idx})")
            for v in blk.vars.values():
                kind = "param" if isinstance(v, Parameter) else (
                    "data" if v.is_data else "var")
                lines.append(
                    f"  {kind} {v.name}: {v.dtype.name}{list(v.shape)}"
                    + (f" lod={v.lod_level}" if v.lod_level else "")
                    + (" persistable" if v.persistable else "")
                )
            for i, op in enumerate(blk.ops):
                marker = " // <-- backward" if blk.backward_index == i else ""
                lines.append(f"  {i}: {op}{marker}")
        return "\n".join(lines)

    __str__ = to_string


# ---------------------------------------------------------------------------
# Default program registry (fluid/framework.py default_main_program pattern)
# ---------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


@contextlib.contextmanager
def name_scope(prefix):
    with unique_name.guard(prefix):
        yield
