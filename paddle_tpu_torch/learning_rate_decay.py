"""Learning-rate schedules as program state (the port's copy of
``paddle_tpu/learning_rate_decay.py``).

Each schedule keeps a persistable f32 step counter ``<schedule>_<n>.step``
(the reference's name, so the counter crosses a checkpoint of either
package) that an ``increment`` op of role ``optimize`` advances once a
training step, and computes the decayed rate from it as an ordinary op
chain in the forward prefix.  Pass the returned ``[1]`` Variable as an
optimizer's ``learning_rate``.  ``clone(for_test=True)`` drops the
``increment``, so evaluation leaves the schedule where it is."""

from . import initializer as init_mod
from .layers.layer_helper import LayerHelper

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
]


def _global_step(helper):
    step = helper.create_global_variable(
        shape=[1], dtype="float32", name=f"{helper.name}.step",
        initializer=init_mod.Constant(0.0),
    )
    op = helper.append_op(
        type="increment", inputs={"X": [step.name]},
        outputs={"Out": [step.name]}, attrs={"step": 1.0},
    )
    op.role = "optimize"
    return step


def _tmp(helper):
    return helper.create_tmp_variable("float32", [1], stop_gradient=True)


def _divided(helper, step, scale, staircase):
    div = _tmp(helper)
    helper.append_op(
        type="scale", inputs={"X": [step.name]}, outputs={"Out": [div.name]},
        attrs={"scale": scale},
    )
    if staircase:
        helper.append_op(type="floor", inputs={"X": [div.name]},
                         outputs={"Out": [div.name]})
    return div


def _scaled(helper, x, scale, bias=None):
    out = _tmp(helper)
    attrs = {"scale": scale} if bias is None else {"scale": scale,
                                                    "bias": bias}
    helper.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """``lr * decay_rate ^ (step / decay_steps)``"""
    helper = LayerHelper("exponential_decay")
    step = _global_step(helper)
    div = _divided(helper, step, 1.0 / decay_steps, staircase)
    base = _tmp(helper)
    helper.append_op(
        type="fill_constant", outputs={"Out": [base.name]},
        attrs={"shape": [1], "dtype": "float32", "value": float(decay_rate)},
    )
    powed = _tmp(helper)
    helper.append_op(
        type="elementwise_pow", inputs={"X": [base.name], "Y": [div.name]},
        outputs={"Out": [powed.name]},
    )
    return _scaled(helper, powed, float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """``lr * exp(-decay_rate * step / decay_steps)``"""
    helper = LayerHelper("natural_exp_decay")
    step = _global_step(helper)
    div = _divided(helper, step, 1.0 / decay_steps, staircase)
    scaled = _scaled(helper, div, -float(decay_rate))
    e = _tmp(helper)
    helper.append_op(type="exp", inputs={"X": [scaled.name]},
                     outputs={"Out": [e.name]})
    return _scaled(helper, e, float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """``lr / (1 + decay_rate * step / decay_steps)``"""
    helper = LayerHelper("inverse_time_decay")
    step = _global_step(helper)
    div = _divided(helper, step, float(decay_rate) / decay_steps, staircase)
    denom = _scaled(helper, div, 1.0, 1.0)
    recip = _tmp(helper)
    helper.append_op(type="reciprocal", inputs={"X": [denom.name]},
                     outputs={"Out": [recip.name]})
    return _scaled(helper, recip, float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """``(lr - end_lr) * (1 - min(step, decay_steps) / decay_steps) ^ power
    + end_lr``; ``cycle`` is accepted and ignored, as in the reference."""
    helper = LayerHelper("polynomial_decay")
    step = _global_step(helper)
    capped = _tmp(helper)
    helper.append_op(
        type="clip", inputs={"X": [step.name]}, outputs={"Out": [capped.name]},
        attrs={"min": 0.0, "max": float(decay_steps)},
    )
    frac = _scaled(helper, capped, -1.0 / decay_steps, 1.0)
    powed = _tmp(helper)
    helper.append_op(
        type="pow", inputs={"X": [frac.name]}, outputs={"Out": [powed.name]},
        attrs={"factor": float(power)},
    )
    return _scaled(helper, powed, float(learning_rate - end_learning_rate),
                   float(end_learning_rate))
