"""Optimizers (``paddle_tpu/optimizer.py``): the ``Optimizer`` base and
``Adam``.

``minimize(loss)`` appends: the backward marker (the autograd boundary)
-> one optimizer op per parameter + accumulators.  Gradient clipping and
regularization are not ported yet: a parameter or optimizer that asks
for either raises."""

from .backward import append_backward
from .core.program import default_startup_program, Variable
from .core import unique_name
from . import initializer as init_mod

__all__ = ["Optimizer", "Adam", "AdamOptimizer"]


def _tag_optimize_ops(block):
    """Mark every op from the backward marker on as optimize-role so
    clone(for_test=True) strips exactly the training suffix."""
    if block.backward_index is None:
        return
    for op in block.ops[block.backward_index:]:
        op.role = "optimize"


class Optimizer:
    def __init__(self, learning_rate, regularization=None, global_clip=None):
        if regularization is not None or global_clip is not None:
            raise NotImplementedError(
                "regularization and gradient clipping are not ported yet")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self.global_clip = global_clip
        self._accumulators = {}
        self._lr_var = None

    # -- plumbing ----------------------------------------------------------
    def _create_persistable(self, block, name, shape, dtype, init_value,
                            startup_program=None, zero_param=None):
        sp = startup_program or default_startup_program()
        var = block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True,
        )
        # optimizer-owned state, tagged on the MAIN var and the startup
        # twin (per-parameter accumulators also name their parameter)
        var.optimizer_state = True
        if zero_param is not None:
            var.zero_param = zero_param
        sb = sp.global_block()
        if name not in sb.vars:
            svar = sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
            svar.optimizer_state = True
            if zero_param is not None:
                svar.zero_param = zero_param
            init_mod.Constant(init_value)(svar, sb)
        return var

    def _create_lr_var(self, block, startup_program):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
        elif self._lr_var is None:
            name = unique_name.generate("learning_rate")
            self._lr_var = self._create_persistable(
                block, name, [1], "float32", float(self._learning_rate),
                startup_program,
            )
        return self._lr_var

    def _param_lr(self, block, param):
        scale = param.optimize_attr.get("learning_rate", 1.0)
        if scale == 1.0:
            return self._lr_var
        out = Variable(
            block, name=unique_name.generate(f"{param.name}.lr"),
            shape=(1,), dtype="float32", stop_gradient=True,
        )
        block.vars[out.name] = out
        block.append_op(
            type="scale", inputs={"X": [self._lr_var.name]},
            outputs={"Out": [out.name]}, attrs={"scale": float(scale)},
        )
        return out

    def _add_accumulator(self, block, name, param, init_value=0.0, shape=None,
                         startup_program=None):
        """Per-parameter optimizer accumulator (Adam moments), float32,
        named ``<param>_<name>``."""
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        var = self._create_persistable(
            block, f"{param.name}_{name}", shape or list(param.shape),
            "float32", init_value, startup_program,
            zero_param=param.name,
        )
        self._accumulators[key] = var
        return var

    def _create_accumulators(self, block, parameters, startup_program):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- API ---------------------------------------------------------------
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        block = loss.block.program.global_block()
        self._startup = startup_program
        for p, _ in params_grads:
            if (getattr(p, "regularizer", None) is not None
                    or getattr(p, "gradient_clip_attr", None) is not None):
                raise NotImplementedError(
                    f"parameter {p.name!r} asks for a regularizer or a "
                    f"gradient clip; neither is ported yet")
        self._create_lr_var(block, startup_program)
        self._create_accumulators(
            block, [p for p, _ in params_grads], startup_program
        )
        ops = [self._append_optimize_op(block, pg) for pg in params_grads]
        _tag_optimize_ops(block)
        return ops, params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "moment1", p, startup_program=sp)
            self._add_accumulator(block, "moment2", p, startup_program=sp)
        self._beta1_pow = self._create_persistable(
            block, unique_name.generate("beta1_pow_acc"), [1], "float32", 1.0, sp
        )
        self._beta2_pow = self._create_persistable(
            block, unique_name.generate("beta2_pow_acc"), [1], "float32", 1.0, sp
        )

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        m1 = self._accumulators[("moment1", param.name)]
        m2 = self._accumulators[("moment2", param.name)]
        return block.append_op(
            type="adam",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "Moment1": [m1.name],
                "Moment2": [m2.name],
                "LearningRate": [self._param_lr(block, param).name],
                "Beta1Pow": [self._beta1_pow.name],
                "Beta2Pow": [self._beta2_pow.name],
            },
            outputs={
                "ParamOut": [param.name],
                "Moment1Out": [m1.name],
                "Moment2Out": [m2.name],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, pgs = super().minimize(loss, startup_program, parameter_list, no_grad_set)
        # advance beta powers once per step (after all param updates)
        block = loss.block.program.global_block()
        block.append_op(
            type="scale", inputs={"X": [self._beta1_pow.name]},
            outputs={"Out": [self._beta1_pow.name]}, attrs={"scale": self._beta1},
        )
        block.append_op(
            type="scale", inputs={"X": [self._beta2_pow.name]},
            outputs={"Out": [self._beta2_pow.name]}, attrs={"scale": self._beta2},
        )
        _tag_optimize_ops(block)
        return ops, pgs


Adam = AdamOptimizer
