"""Optimizers (``paddle_tpu/optimizer.py``): the ``Optimizer`` base,
SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp
and Ftrl with their short aliases, and ``ModelAverage``.

``minimize(loss)`` appends: the backward marker (the autograd boundary)
-> clip ops (``clip.py``) -> regularization ops (``regularizer.py``) ->
one optimizer op per parameter + accumulators.  Accumulators are f32 and
named ``<param>_<name>`` as in the reference, so a checkpoint of either
package resumes in the other."""

import contextlib

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core.program import (Variable, default_main_program,
                           default_startup_program)
from .core import unique_name
from .core.scope import global_scope
from .regularizer import append_regularization_ops
from . import initializer as init_mod

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "Adamax",
    "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "SGDOptimizer",
    "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "DecayedAdagradOptimizer", "AdadeltaOptimizer",
    "RMSPropOptimizer", "FtrlOptimizer", "ModelAverage",
]


def _tag_optimize_ops(block):
    """Mark every op from the backward marker on as optimize-role so
    clone(for_test=True) strips exactly the training suffix."""
    if block.backward_index is None:
        return
    for op in block.ops[block.backward_index:]:
        op.role = "optimize"


class Optimizer:
    def __init__(self, learning_rate, regularization=None, global_clip=None):
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
        params_grads = append_gradient_clip_ops(params_grads, self.global_clip)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_lr_var(block, startup_program)
        self._create_accumulators(
            block, [p for p, _ in params_grads], startup_program
        )
        ops = [self._append_optimize_op(block, pg) for pg in params_grads]
        _tag_optimize_ops(block)
        return ops, params_grads


class SGDOptimizer(Optimizer):
    """Plain gradient descent: ``p -= lr * g``; no accumulator."""

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "LearningRate": [self._param_lr(block, param).name],
            },
            outputs={"ParamOut": [param.name]},
        )


class MomentumOptimizer(Optimizer):
    """SGD with momentum (and Nesterov's form), one f32 velocity
    ``<param>_velocity`` per parameter."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "velocity", p, startup_program=sp)

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        velocity = self._accumulators[("velocity", param.name)]
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "Velocity": [velocity.name],
                "LearningRate": [self._param_lr(block, param).name],
            },
            outputs={"ParamOut": [param.name],
                     "VelocityOut": [velocity.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdagradOptimizer(Optimizer):
    """Adagrad: one f32 ``<param>_moment`` of summed squared gradients."""

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "moment", p, startup_program=sp)

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        moment = self._accumulators[("moment", param.name)]
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "Moment": [moment.name],
                "LearningRate": [self._param_lr(block, param).name],
            },
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name]},
            attrs={"epsilon": self._epsilon},
        )


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


class AdamaxOptimizer(Optimizer):
    """Adamax: f32 ``<param>_moment`` and ``<param>_inf_norm``, and one
    beta1 power advanced once a step after every update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "moment", p, startup_program=sp)
            self._add_accumulator(block, "inf_norm", p, startup_program=sp)
        self._beta1_pow = self._create_persistable(
            block, unique_name.generate("beta1_pow_acc"), [1], "float32", 1.0, sp
        )

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        moment = self._accumulators[("moment", param.name)]
        inf_norm = self._accumulators[("inf_norm", param.name)]
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "Moment": [moment.name],
                "InfNorm": [inf_norm.name],
                "LearningRate": [self._param_lr(block, param).name],
                "Beta1Pow": [self._beta1_pow.name],
            },
            outputs={
                "ParamOut": [param.name],
                "MomentOut": [moment.name],
                "InfNormOut": [inf_norm.name],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, pgs = super().minimize(loss, startup_program, parameter_list,
                                    no_grad_set)
        block = loss.block.program.global_block()
        block.append_op(
            type="scale", inputs={"X": [self._beta1_pow.name]},
            outputs={"Out": [self._beta1_pow.name]},
            attrs={"scale": self._beta1},
        )
        _tag_optimize_ops(block)
        return ops, pgs


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad with a decaying ``<param>_moment``."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "moment", p, startup_program=sp)

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        moment = self._accumulators[("moment", param.name)]
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "Moment": [moment.name],
                "LearningRate": [self._param_lr(block, param).name],
            },
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    """Adadelta: f32 ``<param>_avg_squared_grad`` and
    ``<param>_avg_squared_update``; its update reads no learning rate."""

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "avg_squared_grad", p,
                                  startup_program=sp)
            self._add_accumulator(block, "avg_squared_update", p,
                                  startup_program=sp)

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        asg = self._accumulators[("avg_squared_grad", param.name)]
        asu = self._accumulators[("avg_squared_update", param.name)]
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "AvgSquaredGrad": [asg.name],
                "AvgSquaredUpdate": [asu.name],
            },
            outputs={
                "ParamOut": [param.name],
                "AvgSquaredGradOut": [asg.name],
                "AvgSquaredUpdateOut": [asu.name],
            },
            attrs={"rho": self._rho, "epsilon": self._epsilon},
        )


class RMSPropOptimizer(Optimizer):
    """RMSProp with optional momentum: f32 ``<param>_mean_square`` and
    ``<param>_momentum``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "mean_square", p, startup_program=sp)
            self._add_accumulator(block, "momentum", p, startup_program=sp)

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        ms = self._accumulators[("mean_square", param.name)]
        mom = self._accumulators[("momentum", param.name)]
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "MeanSquare": [ms.name],
                "Moment": [mom.name],
                "LearningRate": [self._param_lr(block, param).name],
            },
            outputs={
                "ParamOut": [param.name],
                "MeanSquareOut": [ms.name],
                "MomentOut": [mom.name],
            },
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum},
        )


class FtrlOptimizer(Optimizer):
    """FTRL-proximal with l1 and l2: f32 ``<param>_squared`` and
    ``<param>_linear``."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters, sp):
        for p in parameters:
            self._add_accumulator(block, "squared", p, startup_program=sp)
            self._add_accumulator(block, "linear", p, startup_program=sp)

    def _append_optimize_op(self, block, pg):
        param, grad = pg
        sq = self._accumulators[("squared", param.name)]
        lin = self._accumulators[("linear", param.name)]
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [param.name],
                "Grad": [grad.name],
                "SquaredAccumulator": [sq.name],
                "LinearAccumulator": [lin.name],
                "LearningRate": [self._param_lr(block, param).name],
            },
            outputs={
                "ParamOut": [param.name],
                "SquaredAccumOut": [sq.name],
                "LinearAccumOut": [lin.name],
            },
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
        )


# v2-style short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage:
    """An exponential moving average of every parameter, updated inside
    each training step and swapped into the scope for evaluation:

        opt = optimizer.Adam(...); opt.minimize(cost)
        ma = optimizer.ModelAverage(0.999)       # after minimize
        ... train ...
        with ma.apply():                          # params <- averages
            evaluate()
        # params restored

    The average of ``p`` is the persistable ``p@EMA`` in ``p``'s dtype,
    started as a copy of ``p`` and updated after the optimizer ops as
    ``decay * ema + (1 - decay) * p`` (ops of role ``optimize``, so
    ``clone(for_test=True)`` drops them)."""

    def __init__(self, average_decay=0.999, main_program=None,
                 startup_program=None):
        from .layers.layer_helper import LayerHelper

        self.decay = float(average_decay)
        program = main_program or default_main_program()
        self.program = program
        startup = startup_program or default_startup_program()
        if program.global_block().backward_index is None:
            raise RuntimeError(
                "ModelAverage must be constructed AFTER optimizer."
                "minimize(cost): the averages track post-update parameters")
        scope = global_scope()
        self.pairs = []  # (param_name, ema_name)
        block = program.global_block()
        first_new = len(block.ops)
        for p in program.all_parameters():
            ema_name = p.name + "@EMA"
            block.create_var(name=ema_name, dtype=p.dtype,
                             shape=list(p.shape), persistable=True)
            sb = startup.global_block()
            sb.create_var(name=ema_name, dtype=p.dtype,
                          shape=list(p.shape), persistable=True)
            # startup: the average starts equal to the fresh parameter
            sb.append_op(type="assign", inputs={"X": [p.name]},
                         outputs={"Out": [ema_name]})
            if scope.find_var(p.name) is not None:
                # startup already ran: seed the average from the scope
                scope.set(ema_name, scope.get(p.name).clone())
            helper = LayerHelper("model_average", main_program=program,
                                 startup_program=startup)
            scaled_e = helper.create_tmp_variable(p.dtype, list(p.shape))
            helper.append_op(
                type="scale", inputs={"X": [ema_name]},
                outputs={"Out": [scaled_e.name]},
                attrs={"scale": self.decay, "bias": 0.0})
            scaled_p = helper.create_tmp_variable(p.dtype, list(p.shape))
            helper.append_op(
                type="scale", inputs={"X": [p.name]},
                outputs={"Out": [scaled_p.name]},
                attrs={"scale": 1.0 - self.decay, "bias": 0.0})
            helper.append_op(
                type="elementwise_add",
                inputs={"X": [scaled_e.name], "Y": [scaled_p.name]},
                outputs={"Out": [ema_name]})
            self.pairs.append((p.name, ema_name))
        for op in block.ops[first_new:]:
            op.role = "optimize"

    def apply(self, scope=None, need_restore=True):
        """Context manager: each parameter's scope entry becomes a copy of
        its average, and on exit the parameter tensor itself again.  The
        copy keeps the average apart from anything that writes the
        parameter in place inside the context (an optimizer op)."""
        scope = scope or global_scope()

        @contextlib.contextmanager
        def ctx():
            saved = {p: scope.get(p) for p, _ in self.pairs}
            for p, e in self.pairs:
                scope.set(p, scope.get(e).clone())
            try:
                yield
            finally:
                if need_restore:
                    scope.update(saved)

        return ctx()
