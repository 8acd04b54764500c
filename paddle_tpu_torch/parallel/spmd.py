"""One rank's share of a mesh step — the Executor's mesh path.

The reference hands GSPMD one program annotated with PartitionSpecs and
lets it partition the jitted step.  The port's Executor runs eagerly in
one process per rank, so it does the partitioner's work itself, op by op,
with explicit collectives (``collectives.py``) recorded in the step's
collective log.  What one rank holds:

* a persistable rests as its block under the resolved spec
  (``api.compile_shardings``): tp-sharded weights, FSDP-sharded weights
  (the ``fsdp`` axes ``fsdp_spec_for`` composes onto their leading dim),
  ZeRO-1 moments (``dp`` on their leading dim);
* a feed is this rank's rows of the batch (its spec's ``dp`` dim);
* an activation is either replicated over ``tp`` or sharded on one dim
  over it (its *placement*, tracked by name).

Each op of the forward reads an FSDP weight through an all-gather of its
``fsdp`` axes (again in the backward: a saved gathered weight is dropped
and gathered anew when autograd reads it), and then runs by the rule
registered for its type when an input is tp-sharded: a column-parallel
``mul`` takes its replicated input through :func:`reduce_grad` and gives
a sharded output, a row-parallel one sums its partial products with
:func:`reduce_fwd`, elementwise ops, activations, reshapes and
transposes keep the shard, and the flash and fused-CE ops run their
kernels on local heads and vocab shards (their rules live beside them in
``ops/attention_ops.py`` and ``ops/loss_ops.py``).  An op without a rule
gathers its sharded inputs first — correct, costly, and in the log under
the variable it gathered.

Gradients: each rank's loss is over its own rows, so the gradients of the
step are each rank's; the optimizer boundary averages them over ``dp``
once a step — DDP's semantics, the reference's local accumulation's
numerics, equal to the global batch's loss when every rank's loss has the
same denominator.  The average runs over every axis that holds a replica
of the parameter (``tp`` and ``fsdp`` peers compute the same rows, each
in its own summation order), so replicas stay identical.  A FSDP
weight's gradient comes out of its gather's backward as this rank's
block, and its boundary all-reduce is at the block's volume — the log
says so, and ``analysis.comm`` names it the reference's reduce-scatter
over ``dp`` and ``fsdp`` (``PADDLE_TPU_ZERO3_RS=0``: the whole gradient
is reduced and then cut).  Under ZeRO-1 each rank updates its rows of a
parameter against its rows of the moments and all-gathers the parameter
over ``dp``.

Loops: a collective runs in a loop when it runs once per microbatch of
gradient accumulation, or inside a repeat of a uniform layer group of a
memory-optimized program (the layers the reference runs as a scan) — the
``in_loop`` the contracts read.
"""

import math
import weakref

import torch

from .api import spec_axes
from .collectives import gather_fwd, reduce_fwd, reduce_grad

__all__ = ["Spmd", "tp_rule", "TP_RULES", "local_block", "shard_index"]

TP_RULES = {}


def tp_rule(*op_types):
    """Register ``fn(sp, op, ins, pls, attrs, run) -> (outs, out_pls) or
    None`` as the tensor-parallel rule of ``op_types``: ``pls`` maps each
    input slot to its tp placement (a dim, or None), ``run(ins, attrs)``
    runs the op's own implementation; None means "no rule applies here"
    and the op gathers its inputs."""
    def deco(fn):
        for t in op_types:
            TP_RULES[t] = fn
        return fn
    return deco


def _entry_axes(entry):
    if not entry:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _block_range(dim, spec_entry, mesh, coords):
    axes = _entry_axes(spec_entry)
    n, idx = 1, 0
    for a in axes:
        s = int(mesh.shape.get(a, 1))
        idx = idx * s + coords.get(a, 0)
        n *= s
    k = dim // n
    return idx * k, idx * k + k


def shard_index(shape, spec, mesh, coords):
    """``((start, stop), ...)``: the block of a ``shape`` tensor a rank
    at ``coords`` holds under ``spec`` (composed axes major first)."""
    spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    return tuple(_block_range(int(s), e, mesh, coords)
                 for s, e in zip(shape, spec))


def local_block(t, spec, mesh, coords):
    """This rank's block of the full tensor ``t`` under ``spec``, in its
    own storage."""
    for d, (a, b) in enumerate(shard_index(t.shape, spec, mesh, coords)):
        if b - a != t.shape[d]:
            t = t.narrow(d, a, b - a)
    return t.contiguous().clone()


class _Regather:
    __slots__ = ("shard", "name", "loop")

    def __init__(self, shard, name, loop):
        self.shard, self.name, self.loop = shard, name, loop


class Spmd:
    """The static view of one program on one rank — resolved specs,
    layer-group ops — and the state of the step that runs now (tp
    placements by name, the microbatch flag, the FSDP gradient stash)."""

    def __init__(self, comm, program, specs, loop_ops=(), rs=True):
        self.comm = comm
        self.block = program.global_block()
        self.specs = specs            # at-rest spec of every persistable
        self.loop_ops = frozenset(loop_ops)
        self.rs = rs
        self.tp = comm.size("tp")
        self.pl = {}
        self.micro = False
        self.stash = {}
        self._gathered = {}
        self._zero_pending = []
        self.explicit = {}
        self.extra = {}
        for name, rest in specs.items():
            var = self.block._find_var(name)
            exp = tuple(getattr(var, "partition_spec", None) or ())
            rest = tuple(rest)
            extra = []
            for d, e in enumerate(rest):
                have = _entry_axes(exp[d] if d < len(exp) else None)
                want = _entry_axes(e)
                if want[:len(have)] != have:
                    raise NotImplementedError(
                        f"{name}: resolved spec {rest} does not extend the "
                        f"explicit spec {exp}")
                if want[len(have):]:
                    extra.append((d, want[len(have):]))
            bad = spec_axes(exp) - {"tp"}
            if bad:
                raise NotImplementedError(
                    f"{name}: the mesh path shards parameters over tp and "
                    f"fsdp only, not {sorted(bad)}")
            if any(len(_entry_axes(e)) > 1 and "tp" in _entry_axes(e)
                   for e in exp):
                raise NotImplementedError(
                    f"{name}: tp composed with another axis in the "
                    f"explicit spec {exp}")
            self.explicit[name] = exp
            if extra:
                self.extra[name] = extra

    # -- step state -----------------------------------------------------
    def reset(self):
        self._zero_pending = []
        self.pl = {}
        self.stash = {}
        self._gathered = {}
        self.micro = False

    def tp_dim(self, name):
        """The tp placement of a persistable's value as ops read it."""
        for d, e in enumerate(self.explicit.get(name, ())):
            if "tp" in _entry_axes(e):
                return d if self.tp > 1 else None
        return None

    def sharded_over(self, name):
        """Mesh axes a persistable's at-rest block is cut over."""
        return spec_axes(self.specs.get(name, ()))

    # -- reads ------------------------------------------------------------
    def _gather_param(self, name, shard, autograd=True):
        stash = None if self.rs else self.stash
        t = shard
        for d, axes in self.extra[name]:
            for i, ax in enumerate(reversed(axes)):
                last = i == len(axes) - 1
                if autograd:
                    t = gather_fwd(t, self.comm, ax, d, name,
                                   stash if last else None)
                else:
                    t = self.comm.all_gather(t, ax, d, name)
        return t

    def read(self, name, val):
        """The value an op of the forward reads for ``name`` and its tp
        placement: an FSDP weight gathered, anything else as it is."""
        if name in self.extra:
            full = self._gather_param(name, val, autograd=val.requires_grad)
            if full.requires_grad:
                self._gathered[id(full)] = (weakref.ref(full), val, name,
                                            self.comm.in_loop)
            return full, self.tp_dim(name)
        if name in self.specs:
            return val, self.tp_dim(name)
        return val, self.pl.get(name)

    def saved_hooks(self):
        """Saved-tensor hooks for the forward: a gathered FSDP weight that
        autograd saves is kept as its block and gathered again when the
        backward reads it."""
        def pack(t):
            rec = self._gathered.get(id(t))
            if rec is None or rec[0]() is not t:
                return t
            return _Regather(rec[1], rec[2], rec[3])

        def unpack(obj):
            if not isinstance(obj, _Regather):
                return obj
            with self.comm.where("backward", obj.loop):
                return self._gather_param(obj.name, obj.shard.detach(),
                                          autograd=False)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    # -- tp ops -----------------------------------------------------------
    def gather(self, t, dim, var=None):
        return gather_fwd(t, self.comm, "tp", dim, var)

    def f(self, t, var=None):
        return reduce_grad(t, self.comm, "tp", var)

    def g(self, t, var=None):
        return reduce_fwd(t, self.comm, "tp", var)

    def call(self, op, ins, attrs, run, in_loop):
        """Run one forward op on this rank's values; returns its outputs
        and records their placements."""
        self.comm.in_loop = self.micro or in_loop
        pls, vals = {}, {}
        for slot, names in op.inputs.items():
            if not names or slot not in ins:
                continue
            got = ins[slot] if len(names) > 1 else [ins[slot]]
            read = [self.read(n, v) for n, v in zip(names, got)]
            vals[slot] = ([r[0] for r in read] if len(names) > 1
                          else read[0][0])
            pls[slot] = ([r[1] for r in read] if len(names) > 1
                         else read[0][1])
        flat = [p for v in pls.values()
                for p in (v if isinstance(v, list) else [v])]
        out_pls = {}
        if any(p is not None for p in flat):
            rule = TP_RULES.get(op.type)
            res = rule(self, op, vals, pls, attrs, run) if rule else None
            if res is None:
                for slot, names in op.inputs.items():
                    if slot not in vals:
                        continue
                    if len(names) > 1:
                        vals[slot] = [
                            v if p is None else self.gather(v, p, n)
                            for v, p, n in zip(vals[slot], pls[slot], names)]
                    elif pls[slot] is not None:
                        vals[slot] = self.gather(vals[slot], pls[slot],
                                                 names[0])
                outs = run(vals, attrs)
            else:
                outs, out_pls = res
        else:
            outs = run(vals, attrs)
        for slot, names in op.outputs.items():
            p = out_pls.get(slot)
            for n in names:
                if p is None:
                    self.pl.pop(n, None)
                else:
                    self.pl[n] = p
        return outs

    def replicate_reads(self, names, env):
        """Before a control-flow op: ``{name: value}`` of what it reads,
        gathered where sharded (its sub-block runs replicated)."""
        out = {}
        for n in names:
            if n not in env:
                continue
            v, p = self.read(n, env[n])
            if p is not None:
                v = self.gather(v, p, n)
            if v is not env[n]:
                out[n] = v
        return out

    def fetch(self, name, val):
        """A fetched value whole over tp (no autograd)."""
        p = self.pl.get(name) if name not in self.specs else None
        if p is None:
            return val
        return self.comm.all_gather(val, "tp", p, name)

    # -- the optimizer boundary ---------------------------------------------
    def replicas(self, name):
        """The mesh axes of size > 1 over which a persistable's block is
        held alike: its gradient is averaged over all of them, so that its
        replicas stay identical — ``dp`` peers computed other rows, ``tp``
        and ``fsdp`` peers the same rows, but each summed in its own order
        (the card's atomics)."""
        cut = self.sharded_over(name)
        return tuple(a for a in self.comm.mesh.axis_names
                     if self.comm.size(a) > 1 and a not in cut)

    def boundary_grads(self, names, grads, accum=1):
        """Each parameter's gradient as its optimizer op reads it: the mean
        over the axes that hold the parameter's replicas (one f32 bucket
        per set of axes for the gradients at their full volume; one
        all-reduce per FSDP block, at the block's volume), FSDP gradients
        cut to this rank's block."""
        comm = self.comm
        out = list(grads)
        buckets = {}
        with comm.where("boundary", False):
            for i, (n, g) in enumerate(zip(names, grads)):
                axes = self.replicas(n)
                if n in self.extra:
                    block = tuple(a for _, ax in self.extra[n] for a in ax)
                    if not self.rs:
                        g = self.stash.pop(n) / accum
                        block = None
                    if axes:
                        comm.all_reduce(g, axes, n, block=block)
                        g.div_(comm.size(axes))
                    if not self.rs:
                        out[i] = self._cut(n, g).to(grads[i].dtype)
                    continue
                if axes:
                    buckets.setdefault(axes, []).append(i)
            for axes, idx in buckets.items():
                flat = torch.cat([out[i].reshape(-1).float() for i in idx])
                comm.all_reduce(flat, axes, ",".join(names[i] for i in idx))
                flat.div_(comm.size(axes))
                off = 0
                for i in idx:
                    g = out[i]
                    k = g.numel()
                    out[i] = flat[off:off + k].view(g.shape).to(g.dtype)
                    off += k
        return out

    def _cut(self, name, full):
        coords = self.comm.coords
        for d, axes in self.extra[name]:
            n, idx = 1, 0
            for a in axes:
                s = self.comm.size(a)
                idx, n = idx * s + coords.get(a, 0), n * s
            k = full.shape[d] // n
            full = full.narrow(d, idx * k, k)
        return full.contiguous()

    def grad_norm(self, names, grads, device):
        """The global gradient norm from the blocks: squares summed per set
        of axes the blocks are cut over, each set all-reduced over them."""
        parts = {}
        for n, g in zip(names, grads):
            axes = tuple(sorted(a for a in self.sharded_over(n)
                                if a != "dp" and self.comm.size(a) > 1))
            sq = torch.linalg.vector_norm(g.float()).square().reshape(1)
            parts[axes] = parts[axes] + sq if axes in parts else sq
        total = torch.zeros(1, device=device)
        with self.comm.where("boundary", False):
            for axes, s in sorted(parts.items()):
                for a in axes:
                    self.comm.all_reduce(s, a, "@GRAD_NORM@")
                total = total + s
        return torch.sqrt(total[0])

    def zero_param(self, op):
        """The parameter name an optimizer op updates under ZeRO-1 (its
        moments rest as ``dp`` rows while it does not), else None."""
        pnames = op.inputs.get("Param") or ()
        if len(pnames) != 1 or self.comm.size("dp") <= 1:
            return None
        p = pnames[0]
        if "dp" in self.sharded_over(p):
            return None
        for slot, names in op.inputs.items():
            for n in names:
                var = self.block._find_var(n)
                spec = self.specs.get(n)
                if (var is not None and getattr(var, "zero_param", None) == p
                        and spec and "dp" in _entry_axes(spec[0])):
                    return p
        return None

    def _suffix(self, p, n):
        """``[(dim, axes)]``: the mesh axes parameter ``p`` rests cut over
        that its accumulator ``n`` does not (the reference's replicated
        moment of a tp or FSDP weight with ZeRO off), by dim."""
        ps, ns = self.specs.get(p, ()), self.specs.get(n, ())
        out = []
        for d, e in enumerate(ps):
            have = _entry_axes(ns[d] if d < len(ns) else None)
            want = tuple(a for a in _entry_axes(e) if a != "dp")
            if want[:len(have)] != have:
                raise NotImplementedError(
                    f"{n}: spec {ns} does not cover {p}'s {ps}")
            if want[len(have):]:
                out.append((d, want[len(have):]))
        return out

    def _accumulators_to_block(self, op, ins, env):
        """Cut the whole accumulators of a sharded parameter to its block
        (views); returns what :meth:`_accumulators_back` needs."""
        p = (op.inputs.get("Param") or [None])[0]
        fixes = []
        if p is None:
            return fixes
        coords = self.comm.coords
        for slot, names in op.inputs.items():
            if slot in ("Param", "Grad") or len(names) != 1:
                continue
            n = names[0]
            var = self.block._find_var(n)
            if getattr(var, "zero_param", None) != p:
                continue
            suffix = self._suffix(p, n)
            if not suffix:
                continue
            view = env[n]
            for d, axes in suffix:
                k, idx = view.shape[d], 0
                for a in axes:
                    k //= self.comm.size(a)
                    idx = idx * self.comm.size(a) + coords.get(a, 0)
                view = view.narrow(d, idx * k, k)
            ins[slot] = view
            fixes.append((n, view, suffix))
        return fixes

    def _accumulators_back(self, fixes, env):
        """All-gather each updated block back into its whole accumulator."""
        with self.comm.where("boundary", False):
            for n, view, suffix in fixes:
                t = view
                for d, axes in reversed(suffix):
                    for a in reversed(axes):
                        t = self.comm.all_gather(t, a, d, n)
                env[n].copy_(t)

    def optimizer_op(self, op, ins, attrs, run, env):
        """Run an optimizer op; under ZeRO-1 on this rank's ``dp`` rows of
        the parameter and its gradient — the other ranks' rows arrive in
        :meth:`flush_zero`'s one all-gather after the last optimizer op.
        A whole accumulator of a sharded parameter is updated on the
        parameter's block and all-gathered back."""
        p = self.zero_param(op)
        if p is None:
            ins = dict(ins)
            fixes = self._accumulators_to_block(op, ins, env)
            outs = run(ins, attrs)
            if fixes:
                outs = dict(outs)
                for slot, names in op.outputs.items():
                    for n, view, _ in fixes:
                        if names == [n] and outs.get(slot) is not None \
                                and outs[slot] is not view:
                            view.copy_(outs[slot])
                        if names == [n]:
                            outs[slot] = env[n]
                self._accumulators_back(fixes, env)
            return outs
        full = env[p]
        rows = self.comm.block(full, "dp", 0)
        ins = dict(ins)
        ins["Param"] = rows
        ins["Grad"] = self.comm.block(ins["Grad"], "dp", 0)
        outs = run(ins, attrs)
        new = outs.get("ParamOut")
        if new is not None and new is not rows:
            rows.copy_(new)
        self._zero_pending.append((p, full))
        outs = dict(outs)
        outs["ParamOut"] = full
        return outs

    def flush_zero(self):
        """All-gather over ``dp`` every parameter ZeRO-1 updated by rows
        (one collective a dtype), into the parameters in place."""
        comm, pending = self.comm, self._zero_pending
        self._zero_pending = []
        by_dtype = {}
        for p, full in pending:
            by_dtype.setdefault(full.dtype, []).append((p, full))
        n, me = comm.size("dp"), comm.index("dp")
        with comm.where("boundary", False):
            for items in by_dtype.values():
                flat = torch.cat([comm.block(f, "dp", 0).reshape(-1)
                                  for _, f in items])
                whole = comm.all_gather(flat, "dp", 0,
                                        ",".join(p for p, _ in items))
                parts = whole.view(n, -1)
                for r in range(n):
                    if r == me:
                        continue
                    off = 0
                    for _, f in items:
                        k = f.shape[0] // n
                        seg = f.narrow(0, r * k, k)
                        seg.copy_(parts[r, off:off + seg.numel()]
                                  .view(seg.shape))
                        off += seg.numel()


# -- the generic tp rules ----------------------------------------------------
@tp_rule("mul")
def _mul_rule(sp, op, ins, pls, attrs, run):
    x, y = ins["X"], ins["Y"]
    px, py = pls.get("X"), pls.get("Y")
    k = int(attrs.get("x_num_col_dims", 1))
    if y.dim() != 2 or int(attrs.get("y_num_col_dims", 1)) != 1:
        return None
    if px is None and py == 1:
        outs = run({"X": sp.f(x, op.inputs["X"][0]), "Y": y}, attrs)
        return outs, {"Out": k}
    if py == 0 and px == x.dim() - 1 and k == x.dim() - 1:
        outs = dict(run(ins, attrs))
        outs["Out"] = sp.g(outs["Out"], op.outputs["Out"][0])
        return outs, {"Out": None}
    return None


@tp_rule("elementwise_add", "elementwise_sub", "elementwise_mul",
         "elementwise_div", "elementwise_max", "elementwise_min")
def _elementwise_rule(sp, op, ins, pls, attrs, run):
    x, y = ins["X"], ins["Y"]
    px, py = pls.get("X"), pls.get("Y")
    if px is None or x.dim() < y.dim():
        return None
    axis = int(attrs.get("axis", -1))
    off = x.dim() - y.dim() if axis == -1 else axis
    if py is None:
        j = px - off
        if 0 <= j < y.dim() and y.shape[j] != 1:
            return None
    elif py + off != px:
        return None
    return run(ins, attrs), {"Out": px}


_UNARY = ("relu", "gelu", "tanh", "sigmoid", "scale", "cast", "exp",
          "sqrt", "square", "abs", "leaky_relu", "swish", "silu", "relu6",
          "elu", "softplus", "softsign", "log", "reciprocal", "sin", "cos",
          "logsigmoid", "hard_sigmoid", "brelu", "stanh", "ceil", "floor",
          "round", "sign", "rsqrt", "pow")


@tp_rule(*_UNARY)
def _unary_rule(sp, op, ins, pls, attrs, run):
    if set(ins) != {"X"} or set(op.outputs) != {"Out"}:
        return None
    return run(ins, attrs), {"Out": pls["X"]}


@tp_rule("transpose", "transpose2")
def _transpose_rule(sp, op, ins, pls, attrs, run):
    perm = [int(a) for a in attrs.get("axis", ())]
    px = pls.get("X")
    if set(ins) != {"X"} or px is None or not perm:
        return None
    return run(ins, attrs), {"Out": perm.index(px)}


@tp_rule("reshape", "reshape2")
def _reshape_rule(sp, op, ins, pls, attrs, run):
    x, px, tp = ins["X"], pls.get("X"), sp.tp
    if set(ins) != {"X"} or px is None:
        return None
    gin = list(x.shape)
    gin[px] *= tp
    shape = [int(s) for s in attrs.get("shape", ())]
    gout = [gin[i] if s == 0 else s for i, s in enumerate(shape)]
    if -1 in gout:
        known = math.prod(s for s in gout if s != -1)
        gout[gout.index(-1)] = math.prod(gin) // max(known, 1)
    lead = math.prod(gin[:px])
    for k in range(len(gout)):
        if math.prod(gout[:k]) == lead and gout[k] % tp == 0 and (
                shape[k] != 0 or k == px):
            local = list(shape)
            if local[k] > 0:
                local[k] //= tp
            return run(ins, dict(attrs, shape=local)), {"Out": k}
        if math.prod(gout[:k]) > lead:
            break
    return None


@tp_rule("lookup_table")
def _lookup_rule(sp, op, ins, pls, attrs, run):
    """A table row-sharded over tp: each rank looks up the ids its block
    holds and the partial rows are summed over tp."""
    w, ids = ins["W"], ins["Ids"]
    if pls.get("W") != 0 or pls.get("Ids") is not None:
        return None
    pad = attrs.get("padding_idx", -1)
    if pad is not None and int(pad) >= 0:
        return None
    rows = w.shape[0]
    off = sp.comm.index("tp") * rows
    i = ids.long()
    hit = (i >= off) & (i < off + rows)
    local = torch.where(hit, i - off, torch.zeros_like(i))
    out = run({"W": w, "Ids": local.to(ids.dtype)}, attrs)["Out"]
    mask = hit if hit.dim() == out.dim() - 1 else hit.reshape(
        out.shape[:-1])
    out = out * mask[..., None].to(out.dtype)
    return {"Out": sp.g(out, op.outputs["Out"][0])}, {"Out": None}

