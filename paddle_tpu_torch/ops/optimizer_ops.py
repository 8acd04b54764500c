"""Optimizer update ops (``paddle_tpu/ops/optimizer_ops.py``): ``adam``.

The update rule is the reference's, computed in f32.  Where the JAX
package returns new arrays and donates the old buffers, the port updates
``Param``, ``Moment1`` and ``Moment2`` **in place** and returns the same
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
