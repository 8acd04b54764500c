"""The mesh path's collectives and its collective log.

Each rank of a mesh step is one process.  Every collective the step
needs is a call here — never a collective that some library issues out
of sight — and every call appends one entry to the rank's log: kind,
bytes, mesh axes, phase (``forward``, ``backward``, their in-loop forms
``fwd-scan`` / ``bwd-scan``, or ``boundary``), whether it ran inside a
loop of the step, and the variable it moved.  ``analysis.comm``'s
:func:`plan_from_log` turns the log into the step's ``CommPlan``.

Backends: NCCL on CUDA tensors, gloo on CPU tensors, and gloo on CUDA
tensors where several ranks share one card (NCCL refuses two ranks on
one device).  Every collective is called directly on the tensors it
moves; a backend that refuses one raises.

An axis argument is one mesh axis or a tuple of them (the group of the
ranks that differ only along those axes).  The log records what ran:
the kind, the axes of its group, and the bytes of the tensor it moved.
An entry may add ``block``: the mesh axes over which the reduced tensor
is one block of a whole value (a FSDP block's boundary reduction), which
``analysis.comm.plan_from_log`` reads to name the reference's
equivalent.

A reduction runs in its tensor's dtype (bf16 partial products sum in
bf16, as NCCL and gloo both take it); the optimizer boundary reduces the
gradients in one f32 bucket.

The autograd pieces are the three of tensor parallelism:
:func:`reduce_grad` (identity forward, all-reduce backward: the input of
a column-parallel product), :func:`reduce_fwd` (all-reduce forward,
identity backward: the output of a row-parallel product) and
:func:`gather_fwd` (all-gather forward, this rank's block backward: a
sharded value read by replicated compute).
"""

import contextlib

import torch

__all__ = ["MeshComm", "reduce_grad", "reduce_fwd", "gather_fwd"]


class MeshComm:
    """One rank's collectives on a bound :class:`~.mesh.Mesh`, with the
    log of the current step."""

    def __init__(self, mesh, rank):
        self.mesh = mesh
        self.rank = int(rank)
        self.coords = mesh.coords(self.rank)
        self.log = []
        self.phase = "forward"
        self.in_loop = False

    def size(self, axis):
        """The number of ranks along ``axis`` (a name or a tuple)."""
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= int(self.mesh.shape.get(a, 1))
            return n
        return int(self.mesh.shape.get(axis, 1))

    def index(self, axis):
        return int(self.coords.get(axis, 0))

    @contextlib.contextmanager
    def where(self, phase=None, in_loop=None):
        """Log what runs inside under ``phase`` / ``in_loop``."""
        old = self.phase, self.in_loop
        if phase is not None:
            self.phase = phase
        if in_loop is not None:
            self.in_loop = in_loop
        try:
            yield
        finally:
            self.phase, self.in_loop = old

    def record(self, kind, nbytes, axes, var=None, block=None):
        phase = self.phase
        if self.in_loop and phase in ("forward", "backward"):
            phase = "fwd-scan" if phase == "forward" else "bwd-scan"
        entry = {"kind": kind, "bytes": int(nbytes), "axes": tuple(axes),
                 "in_loop": bool(self.in_loop), "phase": phase,
                 "var": var}
        if block:
            entry["block"] = tuple(block)
        self.log.append(entry)

    def take_log(self):
        log, self.log = self.log, []
        return log

    # -- the collectives ------------------------------------------------
    def all_reduce(self, t, axis, var=None, op="sum", block=None):
        """Sum ``t`` (``op="max"``: take the max) in place over ``axis``
        (a no-op where it spans one rank); returns ``t``.  ``block``: the
        log's note that ``t`` is one block, over those axes, of a whole
        value."""
        import torch.distributed as dist

        if self.size(axis) <= 1:
            return t
        buf = t if t.is_contiguous() else t.contiguous()
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(buf, op=rop, group=self.mesh.group(axis))
        if buf is not t:
            t.copy_(buf)
        axes = axis if isinstance(axis, tuple) else (axis,)
        self.record("all-reduce", buf.numel() * buf.element_size(),
                    tuple(a for a in axes if self.size(a) > 1), var, block)
        return t

    def all_gather(self, t, axis, dim, var=None):
        """The blocks of ``t`` along ``axis`` concatenated on ``dim`` (in
        the axis's order)."""
        import torch.distributed as dist

        n = self.size(axis)
        if n <= 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.mesh.group(axis))
        self.record("all-gather", t.numel() * t.element_size() * n,
                    (axis,), var)
        return torch.cat(parts, dim=dim)

    def gather_objects(self, t, axis):
        """Every rank's ``t`` along ``axis`` (same shapes), as a list in
        the axis's order — for fetches, outside autograd."""
        n = self.size(axis)
        if n <= 1:
            return [t]
        return list(self.all_gather(t.reshape(1, *t.shape), axis, 0)
                    .unbind(0))

    def block(self, t, axis, dim):
        """This rank's block of ``t`` along ``dim`` over ``axis``."""
        n = self.size(axis)
        if n <= 1:
            return t
        k = t.shape[dim] // n
        return t.narrow(dim, self.index(axis) * k, k)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, var, loop):
        ctx.comm, ctx.axis, ctx.var, ctx.loop = comm, axis, var, loop
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with ctx.comm.where("backward", ctx.loop):
            ctx.comm.all_reduce(g, ctx.axis, ctx.var)
        return g, None, None, None, None


class _ReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, var):
        y = x.clone(memory_format=torch.contiguous_format)
        comm.all_reduce(y, axis, var)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim, var, stash):
        ctx.comm, ctx.axis, ctx.dim, ctx.var, ctx.stash = (
            comm, axis, dim, var, stash)
        return comm.all_gather(x, axis, dim, var)

    @staticmethod
    def backward(ctx, g):
        if ctx.stash is not None:
            prev = ctx.stash.get(ctx.var)
            ctx.stash[ctx.var] = g if prev is None else prev + g
        return (ctx.comm.block(g, ctx.axis, ctx.dim).contiguous(),
                None, None, None, None, None)


def reduce_grad(x, comm, axis, var=None):
    """Identity forward; the backward sums the gradient over ``axis``."""
    if comm.size(axis) <= 1:
        return x
    return _ReduceGrad.apply(x, comm, axis, var, comm.in_loop)


def reduce_fwd(x, comm, axis, var=None):
    """All-reduce (sum) over ``axis`` forward; identity backward."""
    if comm.size(axis) <= 1:
        return x
    return _ReduceFwd.apply(x, comm, axis, var)


def gather_fwd(x, comm, axis, dim, var=None, stash=None):
    """All-gather on ``dim`` over ``axis`` forward; this rank's block of
    the gradient backward (the gathered value's consumers compute alike
    on every rank of ``axis``).  ``stash``: a dict that also keeps the
    whole gradient under ``var``."""
    if comm.size(axis) <= 1:
        return x
    return _GatherFwd.apply(x, comm, axis, dim, var, stash)
