"""Compare ops and block-structured control flow
(``paddle_tpu/ops/control_flow_ops.py``).

``scan_block`` is the recurrent op under ``StaticRNN`` / ``DynamicRNN``:
where the reference lowers its sub-block to ``lax.scan``, the port runs
it in a Python loop over the time axis on the step's tensors, and
autograd differentiates the loop (no grad op).  ``while``,
``conditional_block``, the tensor arrays and ``parallel_do`` come with
the seq2seq beam decode (``ROADMAP.md`` A9).
"""

import torch

from ..core.registry import register_op


def _register_cmp(name, fn):
    @register_op(name, nondiff=True)
    def _op(X, Y, **_):
        return {"Out": fn(X, Y)}

    _op.__name__ = name


_register_cmp("less_than", torch.lt)
_register_cmp("less_equal", torch.le)
_register_cmp("greater_than", torch.gt)
_register_cmp("greater_equal", torch.ge)
_register_cmp("equal", torch.eq)
_register_cmp("not_equal", torch.ne)


def _scan_trips(op, shape):
    """One run of the sub-block a time step of the scanned sequence."""
    return shape(op.inputs["X"][0])[1]


@register_op("scan_block", raw=True, trips=_scan_trips)
def scan_block(ctx, block, op, env):
    """Run the sub-block once a step over the time axis of the sequence
    inputs (the structured form of the reference's ``recurrent_op``).

    inputs:  ``X`` (sequences ``[b, t, ...]``, each step sees ``[b,
             ...]``), ``Init`` (the carried states' first values)
    outputs: ``Out`` (per-step outputs stacked ``[b, t, ...]``),
             ``FinalStates`` (the carried states after the last step)
    attrs:   ``sub_block``, ``x_names`` (the names the step slices take
             inside the sub-block), ``state_names`` (the carried names;
             the sub-block updates one by writing it), ``out_names``
             (the per-step outputs), ``reverse``, ``length_name`` (an
             outer ``[b]`` of lengths: a sample's carried states freeze
             on steps at and after its length, where the reference's
             LoD has no step).
    The sub-block reads outer names (activations, parameters) from
    ``env`` directly."""
    from ..core.executor import run_block_ops

    sub_blk = ctx.program.block(op.attrs["sub_block"])
    x_names = op.attrs.get("x_names", [])
    state_names = op.attrs.get("state_names", [])
    out_names = op.attrs.get("out_names", [])
    reverse = op.attrs.get("reverse", False)
    length_name = op.attrs.get("length_name")
    grad_prefix = ctx.grad_prefix

    xs = [env[n] for n in op.inputs.get("X", [])]
    carry = {n: env[o] for n, o in zip(state_names,
                                       op.inputs.get("Init", []))}
    t = xs[0].shape[1]
    lengths = env[length_name] if length_name is not None else None
    ys = [[] for _ in out_names]
    for idx in (range(t - 1, -1, -1) if reverse else range(t)):
        local = dict(env)
        local.update(carry)
        for inner, x in zip(x_names, xs):
            local[inner] = x[:, idx]
        run_block_ops(ctx, sub_blk, sub_blk.ops, local,
                      inside_grad_prefix=grad_prefix)
        if lengths is not None:
            valid = idx < lengths
            for n in state_names:
                new, old = local[n], carry[n]
                m = valid.reshape((-1,) + (1,) * (new.dim() - 1)).to(
                    new.dtype)
                local[n] = m * new + (1 - m) * old
        carry = {n: local[n] for n in state_names}
        for k, n in enumerate(out_names):
            ys[k].append(local[n])
    for name, seq in zip(op.outputs.get("Out", []), ys):
        env[name] = torch.stack(seq[::-1] if reverse else seq, dim=1)
    for name, sname in zip(op.outputs.get("FinalStates", []), state_names):
        env[name] = carry[sname]
