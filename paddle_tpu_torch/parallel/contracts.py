"""Canned CommContracts for the training invariants the mesh path
establishes (``paddle_tpu/parallel/contracts.py``) — the machine-checked
form of the placement rules, checked on each rank's collective log of a
step (``Executor.last_comm_plan``).

One difference from the reference: on a mesh with a ``tp`` axis,
:func:`one_boundary_reduce_contract` and :func:`fsdp_scan_contract`
narrow their in-loop forbid to reduces over ``dp`` (and any
reduce-scatter), as the reference's own :func:`zero3_grad_contract`
does — tp's per-layer all-reduces are forward math (the row-parallel
products' partial sums), not gradient aggregation, and inside a layer
group they run once a layer by design.
"""

from ..analysis.comm import CommContract
from .mesh import axis_size

__all__ = ["one_boundary_reduce_contract", "fsdp_scan_contract",
           "zero3_grad_contract", "training_step_contract"]


def one_boundary_reduce_contract(mesh=None, axis="dp"):
    """The comm-aware accumulation invariant (docs/parallel.md "The
    communication audit"): ZERO reduce-class collectives inside loop
    bodies — a gradient must never be cross-chip-reduced once per
    microbatch — and at least one boundary-level reduce over ``axis``
    (the per-optimizer-step gradient aggregation).  ``mesh`` sharpens
    the expect to the named axis when it exists; without one the
    boundary reduce is expected axis-unattributed."""
    c = CommContract("one-boundary-reduce")
    if mesh is not None and axis_size(mesh, "tp") > 1:
        c.forbid(kind="reduce", axis=axis, in_loop=True)
        c.forbid(kind="reduce-scatter", in_loop=True)
    else:
        c.forbid(kind="reduce", in_loop=True)
    expect_axis = axis if (mesh is None or axis_size(mesh, axis) > 1) \
        else None
    c.expect(kind="reduce", axis=expect_axis, min_count=1,
             in_loop=False, phase="boundary")
    return c


def fsdp_scan_contract(mesh=None):
    """The FSDP placement invariant (docs/parallel.md "Where the
    collectives land"): per-layer weight all-gathers over ``fsdp``
    execute INSIDE the scan loop (that is the design — live gathered
    bytes stay O(one layer)), while reduce-class collectives stay out
    of every loop body.  Composes with
    :func:`one_boundary_reduce_contract` for the full training-step
    audit."""
    c = CommContract("fsdp-scan-gathers")
    c.expect(kind="all-gather", axis="fsdp", min_count=1, in_loop=True)
    if mesh is not None and axis_size(mesh, "tp") > 1:
        c.forbid(kind="reduce", axis="dp", in_loop=True)
        c.forbid(kind="reduce-scatter", in_loop=True)
    else:
        c.forbid(kind="reduce", in_loop=True)
    return c


def zero3_grad_contract(mesh=None, n_grads=None):
    """The true-ZeRO-3 gradient invariant (docs/parallel.md rule 4 —
    "reduce-scatter at the boundary, never in-loop"): every fsdp-tagged
    parameter's gradient aggregates as ONE boundary-level
    ``reduce-scatter@fsdp`` (the ``pt_pin[grad_rs_boundary]`` site —
    each chip receives only its gradient shard, at shard volume), and
    reduce-class collectives stay out of every loop body — the in-loop
    per-layer dW replication the replicated-grad spelling was shipped
    to avoid must not sneak back in with the scatter.

    ``n_grads`` pins the exact reduce-scatter count (one per fsdp-tagged
    parameter whose spec resolved — pass ``len(shard_fsdp(...))`` on a
    fully divisible model); without it the contract expects at least
    one.  Because 'reduce' is a kind CLASS covering reduce-scatter, the
    in-loop forbid also catches a mis-spelled in-loop scatter.

    On a mesh with a tp axis the in-loop forbid narrows: tp's per-layer
    all-reduces are forward MATH (row-parallel matmul partials — which
    under the ``(tp, fsdp)`` tuple composition of a row-sharded weight
    legitimately reduce over fsdp too), not gradient aggregation.  What
    stays forbidden in-loop there is any reduce over ``dp`` (gradient
    aggregation has exactly one home: the boundary) and any
    reduce-SCATTER at all (a scatter inside the loop is always the
    mis-spelled ZeRO-3 this contract exists to catch)."""
    c = CommContract("zero3-grad-reduce-scatter")
    if mesh is not None and axis_size(mesh, "tp") > 1:
        c.forbid(kind="reduce", axis="dp", in_loop=True)
        c.forbid(kind="reduce-scatter", in_loop=True)
    else:
        c.forbid(kind="reduce", in_loop=True)
    expect_axis = "fsdp" if (mesh is None
                             or axis_size(mesh, "fsdp") > 1) else None
    kw = {"count": n_grads} if n_grads else {"min_count": 1}
    c.expect(kind="reduce-scatter", axis=expect_axis, in_loop=False,
             phase="boundary", **kw)
    return c


def training_step_contract(mesh, accum=False, fsdp=False,
                           grad_rs=False):
    """The full audited comm shape of one training step on ``mesh``:
    one boundary gradient reduction over ``dp`` (when the mesh has a
    dp axis of size > 1), zero in-loop reduces, with ``fsdp`` the
    in-loop weight gathers FSDP exists to place there, and with
    ``grad_rs`` (the default PADDLE_TPU_ZERO3_RS spelling on an fsdp
    mesh) the boundary gradient reduce-scatters of
    :func:`zero3_grad_contract`.  Returns a list of contracts to
    attach."""
    out = []
    if axis_size(mesh, "dp") > 1:
        out.append(one_boundary_reduce_contract(mesh))
    elif accum or axis_size(mesh, "fsdp") > 1:
        # no dp axis to reduce over, but the in-loop discipline holds
        c = CommContract("no-inloop-reduce")
        c.forbid(kind="reduce", in_loop=True)
        out.append(c)
    if fsdp and axis_size(mesh, "fsdp") > 1:
        out.append(fsdp_scan_contract(mesh))
        if grad_rs and axis_size(mesh, "dp") > 1:
            # the RS spelling needs a boundary reduce to scatter
            # (grad_rs_spec_for resolves None on fsdp-only meshes)
            out.append(zero3_grad_contract(mesh))
    return out
