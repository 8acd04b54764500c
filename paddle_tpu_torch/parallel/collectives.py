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
sharded value read by replicated compute); and those of sequence,
pipeline and expert parallelism: :func:`ppermute` (a ring shift,
reversed backward), :func:`all_to_all` (its own inverse backward) and
:func:`grad_sum` (identity forward; the gradients of replicated values
summed over their axes backward).  A value replicated over an axis is
one logical value that every rank of the axis computes alike, so its
gradient is too: what ``shard_map``'s transposes give the reference.

Every rank must issue the same collectives in the same order, the
backward's too.  Autograd runs a node's backward only when its output
reaches the loss, so :func:`ppermute` threads ``carry`` tensors (the
accumulator of a ring or a pipeline) through itself unchanged: each
shift then lies on the path to the result on every rank — also where
the shifted value itself goes unused (a skipped causal step, device 0's
arrival in a GPipe tick) — and the shifts' backwards run one after
another, in one order everywhere.

The ring shift and the all-to-all go through ``all_to_all_single`` on
gloo and through ``batch_isend_irecv`` (the shift) on NCCL.  Gloo's
send and receive read a CUDA tensor's device pointer as a host address
(``pair.cc: writev ... Bad address``, torch 2.11 with CUDA tensors),
while its ``all_to_all_single`` takes CPU and CUDA tensors alike; so a
gloo shift is an all-to-all whose one nonempty chunk goes to the next
rank.  Each call moves all its tensors as one byte buffer.
"""

import contextlib

import torch

__all__ = ["MeshComm", "reduce_grad", "reduce_fwd", "gather_fwd",
           "ppermute", "all_to_all", "grad_sum", "mesh_comm", "bound",
           "current_comm"]


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
        # boundary reductions the last step started during its backward
        self.overlapped = 0

    def size(self, axis):
        """The number of ranks along ``axis`` (a name or a tuple)."""
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= int(self.mesh.shape.get(a, 1))
            return n
        return int(self.mesh.shape.get(axis, 1))

    def index(self, axis):
        """This rank's index along ``axis`` (a name or a tuple of names,
        major first)."""
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * int(self.mesh.shape.get(a, 1)) + int(
                    self.coords.get(a, 0))
            return i
        return int(self.coords.get(axis, 0))

    def axis_ranks(self, axis):
        """The global ranks of this rank's group along ``axis``, in the
        axis's order."""
        for ranks in self.mesh.all_groups(axis):
            if self.rank in ranks:
                return ranks
        raise ValueError(f"rank {self.rank} is not on {self.mesh}")

    def backend(self, axis):
        import torch.distributed as dist

        return dist.get_backend(self.mesh.group(axis))

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
    def all_reduce(self, t, axis, var=None, op="sum", block=None,
                   async_op=False):
        """Sum ``t`` (``op="max"``: take the max) in place over ``axis``
        (a no-op where it spans one rank); returns ``t``.  ``block``: the
        log's note that ``t`` is one block, over those axes, of a whole
        value.  ``async_op`` (``t`` contiguous): start the reduction and
        return its work handle (None where nothing runs); ``t`` holds
        the sum once the handle's ``wait()`` returns."""
        import torch.distributed as dist

        if self.size(axis) <= 1:
            return None if async_op else t
        buf = t if t.is_contiguous() else t.contiguous()
        if async_op and buf is not t:
            raise ValueError("an async all-reduce needs a contiguous tensor")
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        work = dist.all_reduce(buf, op=rop, group=self.mesh.group(axis),
                               async_op=async_op)
        if buf is not t:
            t.copy_(buf)
        axes = axis if isinstance(axis, tuple) else (axis,)
        self.record("all-reduce", buf.numel() * buf.element_size(),
                    tuple(a for a in axes if self.size(a) > 1), var, block)
        return work if async_op else t

    def shift(self, tensors, axis, shift=1, var=None):
        """Ring shift of ``tensors`` over ``axis``: rank ``i`` of the axis
        gets rank ``i - shift``'s tensors (the reference's ``ppermute``
        with ``perm = [(j, (j + shift) % n)]``), all in one call."""
        import torch.distributed as dist

        n = self.size(axis)
        if n <= 1 or shift % n == 0:
            return list(tensors)
        me = self.index(axis)
        ranks = self.axis_ranks(axis)
        dst, src = (me + shift) % n, (me - shift) % n
        flat = _pack(tensors)
        out = torch.empty_like(flat)
        group = self.mesh.group(axis)
        if self.backend(axis) == "nccl":
            ops = [dist.P2POp(dist.isend, flat, ranks[dst], group),
                   dist.P2POp(dist.irecv, out, ranks[src], group)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        else:
            k = flat.numel()
            send = [k if r == dst else 0 for r in range(n)]
            recv = [k if r == src else 0 for r in range(n)]
            dist.all_to_all_single(out, flat, recv, send, group=group)
        self.record("collective-permute", _nbytes(flat), (axis,), var)
        return _unpack(out, tensors)

    def exchange(self, t, axis, var=None):
        """All-to-all over ``axis``: ``t``'s leading dim (the axis's size)
        is cut in chunks, chunk ``j`` goes to rank ``j`` of the axis, and
        chunk ``j`` of the result came from rank ``j``."""
        import torch.distributed as dist

        n = self.size(axis)
        if n <= 1:
            return t
        if t.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs "
                             f"a leading dim of {n}, got {tuple(t.shape)}")
        flat = _pack([t])
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, group=self.mesh.group(axis))
        self.record("all-to-all", _nbytes(flat), (axis,), var)
        return _unpack(out, [t])[0]

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


def _nbytes(t):
    return t.numel() * t.element_size()


def _pack(tensors):
    """The tensors' bytes, one after another, in one flat uint8 buffer."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _unpack(flat, like):
    out, off = [], 0
    for t in like:
        k = t.numel() * t.element_size()
        out.append(flat[off:off + k].view(t.dtype).view(t.shape))
        off += k
    return out


# -- the current comm (the port's counterpart of shard_map's manual axes) --
_CURRENT = []


def mesh_comm(mesh):
    """The :class:`MeshComm` of a :class:`~.mesh.Mesh` (one a mesh, kept
    on it: its log gathers every call's collectives), or ``mesh`` itself
    when it is one.  A mesh of several ranks is bound to this process's
    rank first where it is not."""
    if isinstance(mesh, MeshComm):
        return mesh
    comm = getattr(mesh, "_comm", None)
    if comm is None:
        rank = mesh._rank
        if rank is None:
            if mesh.size == 1:
                rank = int(mesh.devices.reshape(-1)[0])
            else:
                import torch.distributed as dist

                rank = dist.get_rank()
                mesh.bind(rank)
        comm = mesh._comm = MeshComm(mesh, rank)
    return comm


@contextlib.contextmanager
def bound(comm):
    """Make ``comm`` the current comm inside (what
    ``ring_attention_local`` reads when it is called from a stage of
    ``pipeline``)."""
    _CURRENT.append(comm)
    try:
        yield comm
    finally:
        _CURRENT.pop()


def current_comm():
    if not _CURRENT:
        raise RuntimeError(
            "no mesh is bound: call this inside parallel.pipeline / "
            "ring_attention, or pass comm=")
    return _CURRENT[-1]


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


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, axis, shift, var, n, *ts):
        ctx.comm, ctx.axis, ctx.shift, ctx.var, ctx.n = (
            comm, axis, shift, var, n)
        moved = comm.shift(ts[:n], axis, shift, var)
        return (*moved, *(c.view_as(c) for c in ts[n:]))

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        with ctx.comm.where("backward"):
            back = ctx.comm.shift(gs[:n], ctx.axis, -ctx.shift, ctx.var)
        return (None, None, None, None, None, *back, *gs[n:])


def ppermute(tensors, comm, axis, shift=1, carry=(), var=None):
    """Ring shift of ``tensors`` over ``axis`` (rank ``i`` gets rank ``i -
    shift``'s), differentiable: the backward shifts the gradients back.
    ``carry``: tensors passed through unchanged, which ties this shift
    into the path to the result (see the module's docstring).  Returns
    ``(shifted list, carry list)``."""
    tensors, carry = list(tensors), list(carry)
    if comm.size(axis) <= 1:
        return tensors, carry
    out = _Shift.apply(comm, axis, int(shift), var, len(tensors),
                       *tensors, *carry)
    return list(out[:len(tensors)]), list(out[len(tensors):])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, var):
        ctx.comm, ctx.axis, ctx.var = comm, axis, var
        return comm.exchange(t, axis, var)

    @staticmethod
    def backward(ctx, g):
        with ctx.comm.where("backward"):
            return ctx.comm.exchange(g, ctx.axis, ctx.var), None, None, None


def all_to_all(t, comm, axis, var=None):
    """All-to-all over ``axis`` on ``t``'s leading dim (the axis's size),
    differentiable: the backward is the same exchange (its own
    inverse)."""
    if comm.size(axis) <= 1:
        return t
    return _AllToAll.apply(t, comm, axis, var)


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, plan, *ts):
        ctx.comm, ctx.plan = comm, plan
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g.contiguous().clone() for g in gs]
        with ctx.comm.where("backward"):
            for axes, idx in ctx.plan:
                by_dtype = {}
                for i in idx:
                    by_dtype.setdefault(gs[i].dtype, []).append(i)
                for dtype, ii in sorted(by_dtype.items(), key=str):
                    flat = torch.cat([gs[i].reshape(-1) for i in ii])
                    ctx.comm.all_reduce(flat, axes, "@REPLICA_GRADS@")
                    off = 0
                    for i in ii:
                        k = gs[i].numel()
                        gs[i] = flat[off:off + k].view(gs[i].shape)
                        off += k
        return (None, None, *gs)


def grad_sum(groups, comm):
    """``groups``: ``[(tensors, axes), ...]`` — values replicated over
    ``axes`` (a tuple of mesh axes).  Identity forward; the backward sums
    each group's gradients over its axes (one all-reduce a group and
    dtype), so a replicated parameter's gradient comes out whole on every
    rank, as the reference's ``shard_map`` transposes give it.  One node
    for every group: it runs wherever any of its values reaches the
    loss.  Returns the tensors in the order given."""
    flat, plan = [], []
    for tensors, axes in groups:
        axes = tuple(a for a in axes if comm.size(a) > 1)
        idx = list(range(len(flat), len(flat) + len(tensors)))
        flat.extend(tensors)
        if axes and idx:
            plan.append((axes, idx))
    if not plan or not any(t.requires_grad for t in flat):
        return flat
    return list(_GradSum.apply(comm, tuple(plan), *flat))
