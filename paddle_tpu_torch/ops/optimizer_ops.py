"""Optimizer update ops (``paddle_tpu/ops/optimizer_ops.py``): ``sgd``,
``momentum``, ``adagrad``, ``adam``, ``adamax``, ``adadelta``,
``decayed_adagrad``, ``rmsprop``, ``ftrl``, ``proximal_gd`` and
``proximal_adagrad``.

The update rules are the reference's, computed in f32 in its order.  Where the JAX
package returns new arrays and donates the old buffers, the port updates
the parameter and its accumulators **in place** and returns the same
tensors: the Executor runs these ops under ``torch.no_grad()``."""

import torch

from ..core.registry import register_op


def _scalar(x):
    return x.float().reshape(())


@register_op("adam")
def adam(Param, Grad, Moment1, Moment2, LearningRate, Beta1Pow, Beta2Pow,
         beta1=0.9, beta2=0.999, epsilon=1e-8, **_):
    g = Grad.float()
    m1 = Moment1.mul_(beta1).add_(g, alpha=1 - beta1)
    m2 = Moment2.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    b1p, b2p = _scalar(Beta1Pow), _scalar(Beta2Pow)
    lr_t = (_scalar(LearningRate) * torch.sqrt(1 - b2p * beta2)
            / (1 - b1p * beta1))
    step = lr_t * m1.float() / (torch.sqrt(m2.float()) + epsilon)
    if Param.dtype == torch.float32:
        Param.sub_(step)
    else:
        Param.copy_(Param.float() - step)
    return {"ParamOut": Param, "Moment1Out": m1, "Moment2Out": m2}


@register_op("momentum")
def momentum(Param, Grad, Velocity, LearningRate, mu=0.9,
             use_nesterov=False, **_):
    """``v = mu * v + g``; ``p -= lr * v``, or with Nesterov
    ``p -= (g + mu * v) * lr`` — f32 math in the reference's order, cast
    back to the parameter's and the velocity's dtypes in place."""
    lr = _scalar(LearningRate)
    g = Grad.float()
    v = mu * Velocity.float() + g
    if use_nesterov:
        p = Param.float() - (g + mu * v) * lr
    else:
        p = Param.float() - lr * v
    Velocity.copy_(v)
    Param.copy_(p)
    return {"ParamOut": Param, "VelocityOut": Velocity}


def _write(dst, value):
    """Write the f32 ``value`` into ``dst`` in place, cast to its dtype."""
    dst.copy_(value)
    return dst


@register_op("sgd")
def sgd(Param, Grad, LearningRate, **_):
    p = Param.float() - _scalar(LearningRate) * Grad.float()
    return {"ParamOut": _write(Param, p)}


@register_op("adagrad")
def adagrad(Param, Grad, Moment, LearningRate, epsilon=1e-6, **_):
    lr = _scalar(LearningRate)
    g = Grad.float()
    m = Moment.float() + g * g
    p = Param.float() - lr * g / (torch.sqrt(m) + epsilon)
    return {"ParamOut": _write(Param, p), "MomentOut": _write(Moment, m)}


@register_op("adamax")
def adamax(Param, Grad, Moment, InfNorm, LearningRate, Beta1Pow,
           beta1=0.9, beta2=0.999, epsilon=1e-8, **_):
    """The beta1 power is read, not written: ``AdamaxOptimizer.minimize``
    advances it with a ``scale`` op after every parameter's update."""
    lr = _scalar(LearningRate)
    g = Grad.float()
    m = beta1 * Moment.float() + (1 - beta1) * g
    u = torch.maximum(beta2 * InfNorm.float(), torch.abs(g))
    b1p = _scalar(Beta1Pow) * beta1
    p = Param.float() - (lr / (1 - b1p)) * m / (u + epsilon)
    return {"ParamOut": _write(Param, p), "MomentOut": _write(Moment, m),
            "InfNormOut": _write(InfNorm, u)}


@register_op("adadelta")
def adadelta(Param, Grad, AvgSquaredGrad, AvgSquaredUpdate, rho=0.95,
             epsilon=1e-6, **_):
    g = Grad.float()
    asg = rho * AvgSquaredGrad.float() + (1 - rho) * g * g
    asu0 = AvgSquaredUpdate.float()
    update = -torch.sqrt((asu0 + epsilon) / (asg + epsilon)) * g
    asu = rho * asu0 + (1 - rho) * update * update
    p = Param.float() + update
    return {"ParamOut": _write(Param, p),
            "AvgSquaredGradOut": _write(AvgSquaredGrad, asg),
            "AvgSquaredUpdateOut": _write(AvgSquaredUpdate, asu)}


@register_op("decayed_adagrad")
def decayed_adagrad(Param, Grad, Moment, LearningRate, decay=0.95,
                    epsilon=1e-6, **_):
    lr = _scalar(LearningRate)
    g = Grad.float()
    m = decay * Moment.float() + (1 - decay) * g * g
    p = Param.float() - lr * g / (torch.sqrt(m) + epsilon)
    return {"ParamOut": _write(Param, p), "MomentOut": _write(Moment, m)}


@register_op("rmsprop")
def rmsprop(Param, Grad, MeanSquare, Moment, LearningRate, epsilon=1e-10,
            decay=0.9, momentum=0.0, **_):
    lr = _scalar(LearningRate)
    g = Grad.float()
    ms = decay * MeanSquare.float() + (1 - decay) * g * g
    mom = momentum * Moment.float() + lr * g / torch.sqrt(ms + epsilon)
    p = Param.float() - mom
    return {"ParamOut": _write(Param, p), "MeanSquareOut": _write(MeanSquare, ms),
            "MomentOut": _write(Moment, mom)}


@register_op("ftrl")
def ftrl(Param, Grad, SquaredAccumulator, LinearAccumulator, LearningRate,
         l1=0.0, l2=0.0, lr_power=-0.5, **_):
    lr = _scalar(LearningRate)
    g = Grad.float()
    sq = SquaredAccumulator.float()
    lin = LinearAccumulator.float()
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * Param.float()
    if lr_power == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p = pre / denom
    return {"ParamOut": _write(Param, p),
            "SquaredAccumOut": _write(SquaredAccumulator, new_sq),
            "LinearAccumOut": _write(LinearAccumulator, new_lin)}


def _proximal(prox, lr, l1, l2):
    if l1 > 0:
        return (torch.sign(prox)
                * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
                / (1.0 + lr * l2))
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd")
def proximal_gd(Param, Grad, LearningRate, l1=0.0, l2=0.0, **_):
    lr = _scalar(LearningRate)
    prox = Param.float() - lr * Grad.float()
    return {"ParamOut": _write(Param, _proximal(prox, lr, l1, l2))}


@register_op("proximal_adagrad")
def proximal_adagrad(Param, Grad, Moment, LearningRate, l1=0.0, l2=0.0, **_):
    g = Grad.float()
    m = Moment.float() + g * g
    lr = _scalar(LearningRate) / torch.sqrt(m)
    prox = Param.float() - lr * g
    return {"ParamOut": _write(Param, _proximal(prox, lr, l1, l2)),
            "MomentOut": _write(Moment, m)}
