"""Compare and logical ops, the tensor arrays, and block-structured
control flow (``paddle_tpu/ops/control_flow_ops.py``).

``scan_block`` is the recurrent op under ``StaticRNN`` / ``DynamicRNN``:
where the reference lowers its sub-block to ``lax.scan``, the port runs
it in a Python loop over the time axis on the step's tensors, and
autograd differentiates the loop (no grad op).  ``while`` is the loop
of ``layers.While`` (the seq2seq beam decode): where the reference
lowers it to ``lax.while_loop``, the port runs its sub-block in a Python
loop while the condition holds, reading the condition on the host once
a trip.  A tensor array is, as in the reference, a preallocated
``[max_len, ...]`` tensor (``layers.create_array``) that ``array_write``
writes a row of.  ``parallel_do`` runs its sub-block inline, as the
reference does: on a mesh the batch's sharding does the parallel part.
``print`` writes a tensor to standard output as the step runs.
``conditional_block`` is not ported (``ROADMAP.md`` A9).
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


@register_op("logical_and", nondiff=True)
def logical_and(X, Y, **_):
    return {"Out": torch.logical_and(X, Y)}


@register_op("logical_or", nondiff=True)
def logical_or(X, Y, **_):
    return {"Out": torch.logical_or(X, Y)}


@register_op("logical_xor", nondiff=True)
def logical_xor(X, Y, **_):
    return {"Out": torch.logical_xor(X, Y)}


@register_op("logical_not", nondiff=True)
def logical_not(X, **_):
    return {"Out": torch.logical_not(X)}


# ---------------------------------------------------------------------------
# Tensor arrays: Array is a preallocated [max_len, ...] tensor, I a
# one-element int index on the device (the loop counter).  Neither op
# reads I on the host.
# ---------------------------------------------------------------------------
def _index(I, n):
    """``I`` as a ``[1]`` int64 index, a negative one counted from the
    end (as jnp indexing counts it)."""
    i = I.reshape(1).long()
    return torch.where(i < 0, i + n, i)


@register_op("array_write")
def array_write(X, I, Array, **_):
    """A new array with row ``I`` set to ``X`` (``Array.at[I].set(X)``):
    out of place, so a fetched array aliases nothing the loop writes
    later.  A row outside the array is not written, as the reference's
    scatter drops it (the row at the clamped index is written back as
    it was)."""
    n = Array.shape[0]
    i = _index(I, n)
    safe = i.clamp(0, n - 1)
    row = torch.where((i == safe).reshape((1,) * X.dim()),
                      X.to(Array.dtype), Array.index_select(0, safe)[0])
    return {"Out": Array.index_copy(0, safe, row.unsqueeze(0))}


@register_op("array_read")
def array_read(Array, I, **_):
    """Row ``I``, the index clamped into the array
    (``lax.dynamic_index_in_dim``)."""
    n = Array.shape[0]
    return {"Out": Array.index_select(0, _index(I, n).clamp(0, n - 1))[0]}


@register_op("array_length", nondiff=True)
def array_length(Array, **_):
    """The array's capacity ``[1]`` int32, as in the reference: the filled
    length is the loop counter's business."""
    return {"Out": torch.full((1,), Array.shape[0], dtype=torch.int32,
                              device=Array.device)}


def _sub_block_writes(program, block_idx):
    """Every name the ops of a sub-block (and of the blocks nested in it)
    write, in program order."""
    written = []
    for op in program.block(block_idx).ops:
        names = list(op.output_names())
        sub = op.attrs.get("sub_block")
        if sub is not None:
            names += _sub_block_writes(program, sub)
        for n in names:
            if n not in written:
                written.append(n)
    return written


@register_op("while", raw=True)
def while_op(ctx, block, op, env):
    """Run the sub-block while ``Condition`` holds (``layers.While``).

    The carried names are the reference's: the condition and every name
    the sub-block writes that already exists outside it.  After the loop
    only those update ``env``; a name that first appears inside the
    loop stays local to its trip, as under ``lax.while_loop``.  Each trip
    starts from the names outside and the carried values of the trip
    before.  On the card the loop stays on the device but for one host
    read a trip: the condition.

    The trips are known only once the loop has run, so the op has no
    static ``trips``: it adds the trips it ran to ``ctx.trips`` under
    ``id(op)``, with the shapes its sub-block's values took on the last
    trip, and ``last_step_cost`` counts the sub-block's products once
    per trip actually run (:func:`core.executor.step_flops`)."""
    from ..core.executor import run_block_ops

    sub_idx = op.attrs["sub_block"]
    sub_blk = ctx.program.block(sub_idx)
    cond_name = op.inputs["Condition"][0]
    carried = [n for n in _sub_block_writes(ctx.program, sub_idx)
               if n in env]
    if cond_name not in carried:
        carried.insert(0, cond_name)
    grad_prefix = ctx.grad_prefix
    carry = {n: env[n] for n in carried}
    trips, local = 0, {}
    while bool(carry[cond_name].reshape(-1)[0]):
        local = dict(env)
        local.update(carry)
        run_block_ops(ctx, sub_blk, sub_blk.ops, local,
                      inside_grad_prefix=grad_prefix)
        carry = {n: local[n] for n in carried}
        trips += 1
    env.update(carry)
    before, _ = ctx.trips.get(id(op), (0, None))
    ctx.trips[id(op)] = (before + trips, {
        n: tuple(v.shape) for n, v in local.items()
        if isinstance(v, torch.Tensor)})


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


@register_op("parallel_do", raw=True)
def parallel_do(ctx, block, op, env):
    """The reference's ``parallel_do`` scattered its inputs over places and
    summed the gradients; here, as in the JAX package, the sub-block runs
    inline on the step's tensors (in the environment, so its outputs are
    the program's), and a mesh's batch sharding
    (``parallel.data_parallel``) is what makes it parallel."""
    from ..core.executor import run_block_ops

    sub = ctx.program.block(op.attrs["sub_block"])
    run_block_ops(ctx, sub, sub.ops, env,
                  inside_grad_prefix=ctx.grad_prefix)


@register_op("print", raw=True)
def print_op(ctx, block, op, env):
    """``message name = value`` on standard output each time the step
    runs (``print_op.cc``; the reference's ``jax.debug.print``); ``Out``,
    when named, is the input itself.  Reading a CUDA tensor's values
    synchronises the host with the card, so a timed loop leaves it out."""
    name = op.inputs["In"][0]
    x = env[name]
    print(f"{op.attrs.get('message', '')} {name} = {x.detach().cpu()}",
          flush=True)
    if "Out" in op.outputs:
        env[op.outputs["Out"][0]] = x
