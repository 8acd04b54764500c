"""Pipeline parallelism (mesh axis ``pp``) — the port's
``paddle_tpu/parallel/pipeline.py``.

The repeated stage is expressed once, its parameters are stacked with a
leading stage axis cut over ``pp``, and a loop of "pipeline ticks" moves
microbatch activations to the next stage with a ring shift
(:func:`~.collectives.ppermute`).  The reference runs the ticks as a
``lax.scan`` inside ``shard_map``; the port runs one process a rank, so
every rank runs the same Python loop of ticks on its own stages, and
autograd's backward through the loop runs the reverse ticks.  Every rank
runs every tick and every shift, bubble ticks included (a stage on a
bubble tick computes on zeros, as in the reference); the accumulator
rides through each shift (its ``carry``), so the shifts' backwards run
on every rank in one order.

Two schedules, shared by every entry point via ``_pipeline_ticks``:

* GPipe (``virtual_stages=1``): ``pp`` stages, one per rank; ticks =
  ``m + pp - 1``; bubble ``pp - 1`` ticks.
* Interleaved / circular (``virtual_stages=v``): ``v*pp`` stages, stage
  ``s`` on rank ``s % pp`` (round-robin, the Megatron "virtual
  pipeline" placement); every microbatch makes ``v`` laps around the
  ring, re-entering through a rank-0 buffer.  Ticks = ``v*m + pp - 1``.

What a rank passes in is its block: the stacked parameters' leaves
``[v, ...]`` (its laps: stage ``r*pp + idx`` at lap ``r``;
:func:`stage_block` cuts the whole ``[v*pp, ...]`` stack to it,
:func:`stage_params_from_numpy` the reference's arrays), and its rows of
the batch as the reference's ``shard_map`` cuts them (each microbatch's
rows over ``batch_axis``, the wire dims over ``wire_spec``;
:func:`local_batch`).  The gradients come out as the reference's
transposes give them: a value replicated over an axis (the stage
parameters over ``batch_axis`` and the ``wire_spec`` axes, the
embedding and head over every axis, the input over ``pp``) has its
gradient summed over that axis in the backward
(:func:`~.collectives.grad_sum`).

``pipeline_lm`` runs unequal first/last layers (embedding and loss head)
inside the pipelined region: the embedding in the ingest hook (rank 0),
the head in the emit hook on the last stage's rank only.
"""

import torch
import torch.utils._pytree as pytree

from .collectives import bound, grad_sum, mesh_comm, ppermute, reduce_fwd

__all__ = ["pipeline", "pipeline_lm", "stack_stage_params", "stage_block",
           "stage_params_from_numpy", "local_batch"]


def stack_stage_params(params_list):
    """Stack per-stage parameter trees (all the same structure) into one
    tree whose leaves carry a leading stage axis; :func:`stage_block`
    cuts it to a rank's stages."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *params_list)


def stage_block(stacked_params, mesh, axis_name="pp", virtual_stages=1):
    """A rank's laps of the whole stack (leaves ``[v*pp, ...]`` ->
    ``[v, ...]``: stage ``r*pp + idx`` at lap ``r``, round-robin)."""
    comm = mesh_comm(mesh)
    pp, v = comm.size(axis_name), virtual_stages
    idx = comm.index(axis_name)
    return pytree.tree_map(
        lambda p: p.reshape(v, pp, *p.shape[1:])[:, idx].contiguous()
        .clone(), stacked_params)


def stage_params_from_numpy(stacked, mesh, axis_name="pp",
                            virtual_stages=1, device=None):
    """The reference's stacked stage parameters (a tree of numpy arrays,
    leaves ``[v*pp, ...]``) as this rank's laps on ``device`` (the card
    unless ``"cpu"`` is asked for)."""
    from ..core.place import resolve_device
    from ..core.scope import tensor_from_numpy

    dev = resolve_device(device)
    whole = pytree.tree_map(tensor_from_numpy, stacked)
    return pytree.tree_map(lambda t: t.to(dev),
                           stage_block(whole, mesh, axis_name,
                                       virtual_stages))


def local_batch(x, mesh, num_microbatches, batch_axis=None, wire_spec=None):
    """This rank's rows of a whole batch ``x`` as the reference's
    ``shard_map`` cuts them for :func:`pipeline`: each microbatch's rows
    over ``batch_axis``, dim ``1 + i`` over ``wire_spec[i]``."""
    comm = mesh_comm(mesh)
    m = num_microbatches
    xm = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    if batch_axis:
        xm = comm.block(xm, batch_axis, 1)
    for i, ax in enumerate(wire_spec or ()):
        if ax is not None:
            xm = comm.block(xm, ax, 2 + i)
    return xm.reshape(-1, *xm.shape[2:]).contiguous()


def _validate(stacked_params, pp, v, m, b, axis_name, what):
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    if v > 1 and m < pp:
        raise ValueError(
            f"interleaved schedule needs num_microbatches >= pp "
            f"({m} < {pp}): lap r of a microbatch re-enters device 0 at "
            f"tick r*m + j, which must not precede its lap-(r-1) arrival")
    dims = {p.shape[0] for p in pytree.tree_leaves(stacked_params)}
    if dims != {v}:
        raise ValueError(
            f"stacked stage params have leading dim(s) {sorted(dims)} on "
            f"this rank but {what} needs exactly {v} of the {v * pp} "
            f"stages on mesh axis {axis_name!r} (see stack_stage_params, "
            f"stage_block)"
        )


def _pipeline_ticks(stage_fn, params, ingest, emit, acc0, wire_proto,
                    comm, axis_name, pp, v, m):
    """The shared schedule, on this rank's values.

    params        tree, local leaves [v, ...] (this rank's laps)
    ingest(j)     wire value for a microbatch entering stage 0, lap 0
                  (called on rank 0 only)
    emit(acc, h, j, pred)  fold one final-stage output into ``acc``;
                  ``pred`` is this rank's emit predicate this tick
    Returns the final ``acc`` (still rank-local — mask/psum it).
    """
    idx = comm.index(axis_name)
    state = torch.zeros_like(wire_proto)
    buf = [None] * (m if v > 1 else 1)
    acc = acc0
    for t in range(v * m + pp - 1):
        k = t - idx                          # this rank's wave index
        active = 0 <= k < v * m
        r = min(max(k // m, 0), v - 1)       # lap
        j = min(max(k % m, 0), m - 1)        # microbatch
        if idx == 0:
            if v > 1:
                # bank the lap-(r-1) arrival that the shift delivered this
                # tick (wave t - pp); consumed at wave r*m + j >= bank tick
                # because m >= pp.  Final-lap outputs are never banked.
                if t >= pp and t - pp < (v - 1) * m:
                    buf[(t - pp) % m] = state
                h_in = ingest(j) if r == 0 else buf[j]
                if h_in is None:
                    h_in = torch.zeros_like(wire_proto)
            else:
                h_in = ingest(j)
        else:
            h_in = state
        p_r = pytree.tree_map(lambda p: p[r], params)
        h = stage_fn(p_r, h_in)
        pred = idx == pp - 1 and r == v - 1 and active
        acc = emit(acc, h, j, pred)
        (state,), (acc,) = ppermute([h], comm, axis_name, carry=[acc],
                                    var="pipeline_wire")
    return acc


def _replicated(comm, axes):
    return tuple(a for a in axes if a and comm.size(a) > 1)


def pipeline(stage_fn, stacked_params, x, mesh, axis_name="pp",
             num_microbatches=None, batch_axis=None, virtual_stages=1,
             wire_spec=None):
    """Run stacked copies of ``stage_fn`` as a pipeline.

    stage_fn(params, h) -> h        one stage, shape-preserving
    stacked_params                  tree, this rank's leaves ``[v, ...]``
                                    (:func:`stage_block`)
    x                               this rank's ``[batch, ...]`` rows
                                    (:func:`local_batch`)
    mesh                            a bound Mesh or a MeshComm
    num_microbatches                must divide batch; default = pp;
                                    must be >= pp when virtual_stages > 1
    batch_axis                      optional mesh axis name the
                                    microbatch dim is also cut over (dp×pp)
    virtual_stages                  v: stages per rank (interleaved
                                    round-robin placement when > 1)
    wire_spec                       optional tuple of mesh-axis names (or
                                    None) for x's dims AFTER batch — e.g.
                                    ``("sp", None)`` seq-shards a
                                    [batch, t, d] wire so stage_fn sees
                                    [mb, t/sp, d] and can run
                                    ``ring_attention_local`` over ``sp``
                                    (pp x sp composition)

    Returns this rank's ``[batch, ...]`` outputs (the same on every rank
    of ``pp``).
    """
    comm = mesh_comm(mesh)
    pp = comm.size(axis_name)
    v = virtual_stages
    m = num_microbatches or pp
    b = x.shape[0]
    _validate(stacked_params, pp, v, m, b, axis_name, f"pipeline(v={v})")
    leaves, spec = pytree.tree_flatten(stacked_params)
    rep = _replicated(comm, (batch_axis,) + tuple(wire_spec or ()))
    groups = [(leaves, rep)]
    if x.requires_grad:
        groups.append(([x], (axis_name,)))
    summed = grad_sum(groups, comm)
    params = pytree.tree_unflatten(summed[:len(leaves)], spec)
    if x.requires_grad:
        x = summed[len(leaves)]
    xm = x.reshape(m, b // m, *x.shape[1:])

    def emit(acc, h, j, pred):
        if not pred:
            return acc
        return acc.index_copy(0, torch.tensor([j], device=acc.device),
                              h[None].to(acc.dtype))

    with bound(comm):
        out_buf = _pipeline_ticks(
            stage_fn, params, ingest=lambda j: xm[j], emit=emit,
            acc0=torch.zeros_like(xm), wire_proto=xm[0], comm=comm,
            axis_name=axis_name, pp=pp, v=v, m=m)
    # only the last stage holds real outputs; replicate via masked psum
    if comm.index(axis_name) != pp - 1:
        out_buf = out_buf * 0
    out = reduce_fwd(out_buf, comm, axis_name, "pipeline_out")
    return out.reshape(b, *x.shape[1:])


def pipeline_lm(embed_fn, stage_fn, head_loss_fn, embed_params,
                stacked_params, head_params, tokens, targets, mesh,
                axis_name="pp", num_microbatches=None, batch_axis=None,
                virtual_stages=1):
    """Pipeline with the UNEQUAL first/last layers inside the pipelined
    region — the full LM training objective as one program.

    embed_fn(embed_params, tok [mb, t]) -> h [mb, t, d]
    stage_fn(params, h) -> h                 shape-preserving block
    head_loss_fn(head_params, h, tgt) -> ()  per-microbatch mean loss
    tokens, targets                          this rank's [batch, t] rows
                                             (:func:`local_batch`)

    The embedding runs in the ingest hook, on rank 0 of ``pp`` only (one
    call with no gradient on every rank gives the wire's shape).  The
    head — the expensive [d, vocab] product — runs only on the last
    stage's rank, on its emit ticks (head_loss_fn must therefore contain
    no collectives).  Returns the scalar mean loss over all microbatches
    (and over ``batch_axis`` shards if given), the same on every rank.
    """
    comm = mesh_comm(mesh)
    pp = comm.size(axis_name)
    v = virtual_stages
    m = num_microbatches or pp
    b = tokens.shape[0]
    _validate(stacked_params, pp, v, m, b, axis_name,
              f"pipeline_lm(v={v})")
    tok_m = tokens.reshape(m, b // m, *tokens.shape[1:])
    tgt_m = targets.reshape(m, b // m, *targets.shape[1:])

    e_leaves, e_spec = pytree.tree_flatten(embed_params)
    s_leaves, s_spec = pytree.tree_flatten(stacked_params)
    h_leaves, h_spec = pytree.tree_flatten(head_params)
    summed = grad_sum([(s_leaves, _replicated(comm, (batch_axis,))),
                       (e_leaves + h_leaves,
                        _replicated(comm, (axis_name, batch_axis)))], comm)
    params = pytree.tree_unflatten(summed[:len(s_leaves)], s_spec)
    rest = summed[len(s_leaves):]
    embed_params = pytree.tree_unflatten(rest[:len(e_leaves)], e_spec)
    head_params = pytree.tree_unflatten(rest[len(e_leaves):], h_spec)

    with torch.no_grad():
        proto = embed_fn(embed_params, tok_m[0])
    wire_proto = torch.zeros_like(proto)
    del proto

    def emit(losses, h, j, pred):
        if not pred:
            return losses
        loss_j = head_loss_fn(head_params, h, tgt_m[j]).float()
        return losses.index_copy(
            0, torch.tensor([j], device=losses.device), loss_j.reshape(1))

    with bound(comm):
        losses = _pipeline_ticks(
            stage_fn, params,
            ingest=lambda j: embed_fn(embed_params, tok_m[j]), emit=emit,
            acc0=torch.zeros(m, dtype=torch.float32,
                             device=wire_proto.device),
            wire_proto=wire_proto, comm=comm, axis_name=axis_name, pp=pp,
            v=v, m=m)
    if comm.index(axis_name) != pp - 1:
        losses = losses * 0
    losses = reduce_fwd(losses, comm, axis_name, "pipeline_losses")
    loss = torch.mean(losses)
    if batch_axis:
        loss = reduce_fwd(loss, comm, batch_axis, "pipeline_loss") / \
            comm.size(batch_axis)
    return loss
