"""Op registry (the port's copy of ``paddle_tpu/core/registry.py``).

There is exactly one implementation per op: a plain function on torch
tensors.  Its parameters are the op's input slot names (capitalized,
fluid convention: X, Y, Input, ...) plus attrs as keyword arguments; it
returns ``{slot: tensor-or-list}``:

    @register_op("elementwise_add")
    def elementwise_add(X, Y, axis=-1, **_):
        return {"Out": X + Y}

``stateful_rng=True`` ops receive the step's ``torch.Generator`` as
``_gen``; an op that names ``_ctx`` receives the run's context (device,
generator), one that names ``_live`` the output slots somebody reads.
``flops(op, shape, grad, train)`` counts the products of one step of
the op for ``core.executor.step_flops``: ``shape(name)`` is a var's
static shape with the batch filled in, ``grad(name)`` whether it takes a
gradient, ``train`` whether the step runs the backward.

Block-structured control flow registers with ``raw=True``, as in the
reference: such an op is called as ``fn(ctx, block, op, env)``, runs
its sub-block itself (``ctx.program.block(op.attrs["sub_block"])``) and
writes its outputs into ``env``.  Its ``trips(op, shape)`` is how many
times one step runs the sub-block; ``step_flops`` counts the
sub-block's products that many times.
"""

import inspect

_REGISTRY = {}


class OpImpl:
    def __init__(self, op_type, fn, raw=False, stateful_rng=False,
                 nondiff=False, flops=None, trips=None):
        self.type = op_type
        self.fn = fn
        self.raw = raw
        self.stateful_rng = stateful_rng
        self.flops = flops
        self.trips = trips
        # nondiff: op has no linearization rule (integer outputs, argsort-
        # style selection, DP recursions over ints).  The executor
        # detaches its inputs inside the grad prefix.
        self.nondiff = nondiff
        sig = inspect.signature(fn)
        self.params = set(sig.parameters)
        self.has_var_kw = any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        )
        self.wants_ctx = "_ctx" in self.params
        self.wants_live = "_live" in self.params

    def call(self, ins, attrs, ctx, live=None):
        """``live``: the output slots some later op, fetch or state entry
        reads (None = all) — an op that takes ``_live`` may skip the rest."""
        kwargs = dict(ins)
        for k, v in attrs.items():
            if self.has_var_kw or k in self.params:
                kwargs[k] = v
        if self.wants_ctx:
            kwargs["_ctx"] = ctx
        if self.wants_live:
            kwargs["_live"] = live
        return self.fn(**kwargs)


def register_op(op_type, raw=False, stateful_rng=False, nondiff=False,
                flops=None, trips=None):
    def deco(fn):
        if op_type in _REGISTRY:
            raise ValueError(f"op {op_type!r} registered twice")
        _REGISTRY[op_type] = OpImpl(
            op_type, fn, raw=raw, stateful_rng=stateful_rng,
            nondiff=nondiff, flops=flops, trips=trips
        )
        return fn

    return deco


def get_op_impl(op_type):
    impl = _REGISTRY.get(op_type)
    if impl is None:
        raise KeyError(f"no implementation registered for op {op_type!r}")
    return impl


def registered_ops():
    return sorted(_REGISTRY)
