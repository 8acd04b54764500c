"""append_backward — mark the gradient boundary of a program (the port's
copy of ``paddle_tpu/backward.py``).

No grad op is generated per forward op: the Executor runs the forward
prefix under autograd and calls ``torch.autograd.grad`` at the marker
(where the JAX package calls ``jax.grad``).  What this function keeps is
the *contract*:

* after calling it, ``<param>@GRAD`` variables exist in the block and
  optimizer ops appended later may read them;
* it returns ``[(param, grad_var), ...]``.
"""

from .core.program import Parameter, Variable, GRAD_SUFFIX, default_main_program


def append_backward(loss, parameter_list=None, no_grad_set=None):
    program = loss.block.program
    block = program.global_block()
    no_grad_set = {
        v.name if hasattr(v, "name") else str(v) for v in (no_grad_set or ())
    }

    if parameter_list is not None:
        params = []
        for p in parameter_list:
            name = p.name if hasattr(p, "name") else str(p)
            params.append(block.var(name))
    else:
        params = block.all_parameters()
    params = [
        p
        for p in params
        if getattr(p, "trainable", True) and p.name not in no_grad_set
    ]

    pairs = []
    for p in params:
        gname = p.name + GRAD_SUFFIX
        if gname in block.vars:
            gvar = block.vars[gname]
        else:
            gvar = Variable(
                block, name=gname, shape=p.shape, dtype=p.dtype,
                stop_gradient=True,
            )
            block.vars[gname] = gvar
        pairs.append((p, gvar))

    block.backward_index = len(block.ops)
    program._backward_info[block.idx] = {
        "loss": loss.name,
        "params": [p.name for p in params],
    }
    program._bump_version()
    return pairs
