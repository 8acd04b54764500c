"""Executor — runs a Program on torch tensors (the port's counterpart of
``paddle_tpu/core/executor.py``, single device).

The JAX package traces a block once and jits the whole step.  PyTorch
runs eagerly, so the port walks the block on every ``run``: each op's
registered torch implementation is called in program order on a
name -> tensor environment.  For a program with a backward marker
(``append_backward`` / ``Optimizer.minimize``) one step is:

1. ``block.ops[:bw]`` — the forward prefix — under autograd, with the
   trainable parameters requiring grad;
2. ``torch.autograd.grad(loss, params)`` in place of ``jax.grad``; the
   results enter the environment as ``<param>@GRAD``, and their global
   norm goes to the scope as ``@GRAD_NORM@``;
3. ``block.ops[bw:]`` — the optimizer ops — under ``torch.no_grad()``.
   They update parameters and moments **in place** (where the JAX
   package donates the old buffers), so the scope's tensors keep their
   identity from step to step.

Random ops draw from one ``torch.Generator`` per run, whose state is the
scope's ``@RNG@`` entry: read before the step, written back after — the
state at the end of the forward, whatever a recompute did to it since.

Memory: the environment drops a value right after its last reader (the
autograd graph keeps what the backward needs), and an op that takes
``_live`` skips outputs nothing reads — eager execution has no compiler
to remove them.  A control-flow op (``raw=True``: ``scan_block``) reads
what its sub-block reads of the outer names too (:func:`op_reads`), so
an encoder output that only a decoder's sub-block reads lives until the
scan has run.

Remat (``memory_optimize``, ``program._remat_segments``, the reference's
``executor.py:1132-1200``): each wrapped forward region runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so autograd
keeps only the region's inputs and the backward recomputes the rest;
unwrapped ones run plainly, so the kernels' residuals
(``FLASH_BWD_RESIDUALS``, the CE head's ``lse``) stay saved and no kernel
re-runs.  ``compact`` and ``full`` wrap the transpiler's segments as they
are.  ``selective`` saves what the reference saves, the outputs of the
matrix and kernel ops (``MXU_OPS``, ``EXPENSIVE_OPS``): each repeat of a
uniform group of segments (``core/ir.py: find_uniform_groups``, one
transformer layer) is ONE region, cut only at the kernel ops, which stay
outside with their residuals (a CUDA kernel launched through ctypes is
invisible to the dispatcher, so a region could only re-run it); inside,
selective activation checkpointing caches the output of every ATen call
a matrix op makes (views aside) and recomputes the rest (LayerNorm,
activations, bias and residual adds, dropout).  Wrapping the cheap runs alone would save
nothing: each matrix op would keep its input, the run before it.  A
wrapped region returns only the names read after it: if it returned
everything it writes, the next one would keep every internal activation
alive.  ``torch.utils.checkpoint`` restores only the global RNG, and
dropout draws from the step's generator, so each wrapped region that
draws snapshots the generator at entry and restores it before its
recompute: the recomputed mask is the forward's mask.

``offload`` (``program._offload``, the reference's ``executor.py:46-94``
and ``:1373-1391``) runs ``selective``'s regions and moves each layer's
block inputs (what a repeat of the layer group reads from the one
before, the reference's scan carry: the residual stream and its first
LayerNorm's output) to pinned host memory: a ``saved_tensors_hooks``
around each wrapped region catches the checkpoint saving those inputs
(``torch.utils.checkpoint`` saves its inputs before it installs its own
hooks) and hands back a record; ``_Offload`` copies the tensor out on a
side stream without blocking, and the device copy is freed once no
region holds it.  In the backward the first recompute that reads an
input brings it back (waiting on its event in the compute stream) and
starts the copy of the input saved before it, so each transfer runs
under the backward of the region before.  On CPU
tensors the same records keep the inputs in place (mode ``"save"``);
``PADDLE_TPU_OFFLOAD=0`` runs plain ``selective`` (mode ``"off"``).
``Executor.last_remat_plan`` records the mode, the bytes sent to the
host and the layer groups.

Gradient accumulation (``gradient_accumulation``,
``program._grad_accum``, the reference's single-device ``_accum_grads``):
every non-scalar feed is sliced along its leading axis into
``micro_steps`` microbatches (a leading dim that does not divide
raises); forward and backward run per microbatch, with the segments
applied inside each; gradients sum in f32 and the optimizer ops see the
mean once.  Forward-written persistables thread from one microbatch to
the next, but for those an ``optimize``-role op of the forward prefix
writes (a learning-rate schedule's step counter): each microbatch reads
the step's value, so the counter advances once a step and every
microbatch sees the step's rate (the reference advances it once a
microbatch).  Fetches are reassembled as the reference does
(batch-leading values concatenate, batch sums add, other float values
average); ``@GRAD_NORM@`` is the mean gradient's norm.

``run_steps`` takes feeds stacked ``[steps, ...]`` and runs the lowered
step once for each, threading the state (the RNG included) exactly as
``steps`` calls of ``run`` do: the losses and parameters are those calls'
bits.  It is one host call that loops; it does not capture the loop as a
CUDA graph (ROADMAP B).

``last_step_cost`` is the reference's dict for the last ``run`` /
``run_steps``: ``compile_seconds`` (the lowering's host time, on the
cache miss that built it), ``flops`` (:func:`step_flops`, a ``while``
loop's sub-block counted for the trips it ran),
``bytes_accessed`` (None: nothing measures it), ``cache_hit`` and, for
``run_steps``, ``steps``.
"""

import contextlib
import os
import time
import weakref

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from ..flags import FLAGS
from ..observability import metrics as _obs
from .dtypes import torch_dtype
from .ir import sub_block_names
from .place import resolve_device
from .program import GRAD_SUFFIX, Parameter, default_main_program
from .registry import get_op_impl
from .scope import (GRAD_NORM_VAR, RNG_VAR, global_scope, tensor_from_numpy,
                    tensor_to_numpy)

__all__ = ["Executor", "LoweringCtx", "run_block_ops", "step_flops",
           "draws_random", "op_reads"]

# depth of the active ``profiler.nan_guard()`` contexts: while above 0,
# every training step checks its loss and gradient norm before the
# optimizer ops (the reference's process-wide ``jax_debug_nans`` flag)
NAN_GUARD = [0]


def draws_random(program):
    """Whether any op of ``program`` draws from the step's generator
    (dropout) — a program that does not has no RNG stream to resume."""
    return any(get_op_impl(op.type).stateful_rng
               for blk in program.blocks for op in blk.ops)


def op_reads(program, op):
    """The names ``op`` reads: its inputs and, for a control-flow op,
    every name its sub-block (and the blocks nested in it) reads —
    outer activations and parameters the op's own slots do not list."""
    names = op.input_names()
    sub = op.attrs.get("sub_block")
    if sub is not None:
        seen = set(names)
        names += sorted(n for n in sub_block_names(program, sub)[0]
                        if n not in seen)
    return names


def step_flops(program, batch=1, trips=None):
    """The FLOPs of one step of ``program``, counted from its static
    shapes with ``batch`` for their -1 dims: the sum of the ``flops``
    hooks of its ops' registrations (the matrix products of ``mul`` and
    ``matmul``, the recurrent ops, the flash ops and the fused CE head),
    a control-flow op's sub-block counted once for each time the step
    runs it: its ``trips`` hook (``scan_block``: the time steps), or, for
    a loop whose count is known only once it has run (``while``), the
    entry of ``trips`` that the run recorded, ``{id(op): (n, shapes)}``
    with the shapes its sub-block's values took (a -1 dim inside a loop
    need not be the batch: the beam decode's are batch x beam); 0
    without it.  An op without a hook counts 0, so
    this is a count of the products, a lower bound of the work."""
    gb = program.global_block()
    bw = gb.backward_index
    info = program._backward_info.get(0)
    train = bw is not None and info is not None
    trained = set(info["params"]) if train else set()
    trips = trips or {}

    def block_flops(block, ops, ran=None):
        def shape(name):
            if ran is not None and name in ran:
                return list(ran[name])
            return [batch if s == -1 else s
                    for s in block._find_var(name).shape]

        def grad(name):
            """A trained parameter, or a computed value the backward
            reaches."""
            if name in trained:
                return True
            var = block._find_var(name)
            return train and not (isinstance(var, Parameter) or var.is_data
                                  or var.stop_gradient)

        total = 0
        for op in ops:
            impl = get_op_impl(op.type)
            if impl.flops is not None:
                total += impl.flops(op, shape, grad, train)
            sub = op.attrs.get("sub_block")
            if sub is None:
                continue
            n, ran = trips.get(id(op), (None, None))
            if n is None and impl.trips is not None:
                n = impl.trips(op, shape)
            if n:
                sub_blk = program.block(sub)
                total += n * block_flops(sub_blk, sub_blk.ops, ran)
        return total

    return block_flops(gb, gb.ops[:bw] if train else gb.ops)


def _feed_batch(block, feeds):
    """The batch a run's -1 dims stand for: the leading dim of the first
    feed whose variable is batch-leading (-1 first), else 1."""
    for n, val in feeds.items():
        var = block._find_var(n)
        if var is not None and var.shape and var.shape[0] == -1 \
                and val.dim():
            return int(val.shape[0])
    return 1


def _grad_norm_enabled():
    """``PADDLE_TPU_GRADNORM=0`` (the JAX package's kill switch) drops the
    global gradient norm from the step: nothing computes it and the scope
    gets no ``@GRAD_NORM@``.  Read when a step is lowered (a setting
    change lowers the step anew)."""
    return os.environ.get("PADDLE_TPU_GRADNORM", "1").lower() not in (
        "0", "", "false", "off", "no")


def _raise_if_not_finite(values, when="before the optimizer ops"):
    """``nan_guard``'s and ``FLAGS.check_nan_inf``'s check: record and
    raise on the first non-finite value of ``{name: tensor}``."""
    for name, val in values.items():
        if val is None or bool(torch.isfinite(val).all()):
            continue
        _obs.get_registry().counter(
            "executor.nan_trips",
            help="NaN/Inf aborts caught by nan_guard").inc()
        from ..observability import flight as _flight
        from ..observability import trace as _trace

        _trace.get_tracer().instant("nan_guard_trip", cat="executor",
                                    var=name)
        _flight.dump("nan_trip", var=name)
        err = FloatingPointError(
            f"NaN/Inf detected in {name!r} {when}")
        err._pt_nan_counted = True   # recorded here; do not count twice
        raise err


class LoweringCtx:
    """What op implementations may ask of the run: the device tensors are
    made on, the step's random generator, and the program (where a
    control-flow op finds its sub-block).  ``op_type`` is the type of the
    op running now (what a selective-remat policy keys on);
    ``grad_prefix`` whether a control-flow op runs in the differentiated
    forward (its sub-block then runs the same way); ``spmd`` the mesh
    path's view of this rank (None off a mesh); ``trips`` where a
    ``while`` op records the trips it ran and the shapes its sub-block's
    values took (``{id(op): (n, shapes)}``, for :func:`step_flops`)."""

    def __init__(self, device, gen, program=None, trips=None, spmd=None):
        self.device = device
        self.gen = gen
        self.program = program
        self.op_type = None
        self.grad_prefix = False
        self.trips = {} if trips is None else trips
        # the mesh path's rank view (``parallel/spmd.py``), None off-mesh
        self.spmd = spmd


def _check_fetches(program, fetch_names):
    """Fail fast with a useful message when a fetch var is not in the
    program — usually the default program is not the one the model was
    built in (missing program= argument / program_guard)."""
    known = {n for blk in program.blocks for n in blk.vars}
    missing = [n for n in fetch_names if n not in known]
    if missing:
        raise ValueError(
            f"fetch var(s) {missing} not found in the program "
            f"({len(program.global_block().ops)} ops); pass the program "
            f"the model was built in (program= argument or program_guard)"
        )


class _Plan:
    """Static liveness of one block walk: for op ``i``, ``drop[i]`` names
    the values nobody reads after it, ``live[i]`` the output slots
    somebody does read (``keep`` — fetches, state, the loss — is always
    read).  An op's reads are :func:`op_reads`: a control-flow op keeps
    alive what its sub-block reads."""

    def __init__(self, program, ops, keep):
        reads = [op_reads(program, op) for op in ops]
        last = {}
        for i, op in enumerate(ops):
            for n in reads[i] + op.output_names():
                last[n] = i
        self.drop = [[] for _ in ops]
        for n, i in last.items():
            if n not in keep:
                self.drop[i].append(n)
        self.live = [None] * len(ops)
        read_later = set(keep)
        for i in range(len(ops) - 1, -1, -1):
            self.live[i] = {slot for slot, names in ops[i].outputs.items()
                            if any(n in read_later for n in names)}
            read_later.update(reads[i])


def run_block_ops(ctx, block, ops, env, inside_grad_prefix=False, plan=None,
                  first=0):
    """Evaluate ``ops`` (``block.ops[first:first + len(ops)]`` of ``plan``)
    over the name -> tensor environment ``env``.  A control-flow op
    (``raw``) is called as ``fn(ctx, block, op, env)`` and writes its
    outputs itself."""
    sp = ctx.spmd
    for i, op in enumerate(ops, start=first):
        impl = get_op_impl(op.type)
        if impl.raw:
            ctx.op_type = op.type
            ctx.grad_prefix = inside_grad_prefix
            subs = {}
            if sp is not None:
                # a sub-block runs replicated: what it reads, gathered
                subs = sp.replicate_reads(op_reads(ctx.program, op), env)
                saved = {n: env[n] for n in subs}
                env.update(subs)
            try:
                impl.fn(ctx, block, op, env)
            except Exception as e:
                raise RuntimeError(f"error running {op}: {e}") from e
            for n, v in subs.items():
                if env.get(n) is v:
                    env[n] = saved[n]
            if plan is not None:
                for n in plan.drop[i]:
                    env.pop(n, None)
            continue
        detach_all = inside_grad_prefix and impl.nondiff
        ins = {}
        for slot, names in op.inputs.items():
            if not names:
                continue
            vals = []
            for n in names:
                val = env[n]
                if inside_grad_prefix:
                    var = block._find_var(n)
                    if detach_all or (
                            var is not None and var.stop_gradient
                            and not isinstance(var, Parameter)):
                        val = val.detach()
                vals.append(val)
            ins[slot] = vals if len(names) > 1 else vals[0]
        attrs = dict(op.attrs)
        if impl.stateful_rng and "_gen" not in attrs:
            attrs["_gen"] = ctx.gen
        ctx.op_type = op.type
        live = None if plan is None else plan.live[i]
        try:
            if sp is None:
                outs = impl.call(ins, attrs, ctx, live=live)
            else:
                def run(ins_, attrs_, _impl=impl, _live=live):
                    return _impl.call(ins_, attrs_, ctx, live=_live)

                if op.role == "optimize":
                    outs = sp.optimizer_op(op, ins, attrs, run, env)
                else:
                    outs = sp.call(op, ins, attrs, run,
                                   block.idx != 0 or i in sp.loop_ops)
        except Exception as e:
            raise RuntimeError(f"error running {op}: {e}") from e
        outs = outs or {}
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            if len(vals) != len(names):
                raise RuntimeError(
                    f"op {op.type}: output slot {slot} produced {len(vals)} "
                    f"values for {len(names)} variables"
                )
            for n, v in zip(names, vals):
                env[n] = v
        if plan is not None:
            for n in plan.drop[i]:
                env.pop(n, None)


def _checkpointed(ctx, block, ops, first, env, plan, in_names, out_names,
                  draws, saved_types):
    """Run ``ops`` (``block.ops[first:...]``) under
    ``torch.utils.checkpoint``: autograd keeps the inputs, the backward
    recomputes the rest — but for the outputs of the ATen calls made by
    ops of ``saved_types``, which selective activation checkpointing
    caches in the forward (none when empty).  ``draws``: the region holds
    a random op, so the generator's state at entry is restored before the
    recompute."""
    rng0 = ctx.gen.get_state() if draws else None

    def seg_fn(*vals):
        if draws:
            ctx.gen.set_state(rng0)
        e = dict(zip(in_names, vals))
        run_block_ops(ctx, block, ops, e, inside_grad_prefix=True,
                      plan=plan, first=first)
        return tuple(e[n] for n in out_names)

    kw = {}
    if saved_types:
        # a view (the reshapes around a product) is not cached: it would
        # keep the product's input alive, which is what the remat frees
        def policy(_sac_ctx, func, *_args, **_kwargs):
            return (CheckpointPolicy.MUST_SAVE
                    if ctx.op_type in saved_types and not func.is_view
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            policy)
    # early stop ends a recompute by raising from inside an op, which
    # run_block_ops would report as that op's failure: recompute whole
    with set_checkpoint_early_stop(False):
        outs = checkpoint(seg_fn, *[env[n] for n in in_names],
                          use_reentrant=False, preserve_rng_state=False,
                          **kw)
    env.update(zip(out_names, outs))


def _offload_mode(program, device):
    """How a step runs an ``offload`` program: ``"host"`` (block inputs
    to pinned host memory; CUDA tensors), ``"save"`` (the same records,
    the inputs kept in place; CPU tensors), or ``"off"`` (not an offload
    program, or ``PADDLE_TPU_OFFLOAD=0``: plain ``selective``)."""
    if not getattr(program, "_offload", False):
        return "off"
    if os.environ.get("PADDLE_TPU_OFFLOAD", "1").lower() in (
            "0", "", "false"):
        return "off"
    return "host" if device.type == "cuda" else "save"


class _Saved:
    """One offloaded block input: its pinned host copy, and its device
    copy from the fetch that brings it back until a recompute takes it."""

    __slots__ = ("index", "host", "dev", "ready")

    def __init__(self, index):
        self.index = index
        self.host = self.dev = self.ready = None


class _Offload:
    """The block inputs of one forward under ``offload``.  ``saving(xs)``
    is a ``saved_tensors_hooks`` context: a save of one of the tensors
    ``xs`` (the checkpoint saving its inputs) becomes a :class:`_Saved`.
    Mode ``"host"`` copies the tensor to pinned memory on a side stream
    ordered after the compute stream (``record_stream`` keeps the device
    block until the copy is done) and drops it; its unpack in the
    backward copies it back on the side stream, makes the compute stream
    wait for that copy's event, and starts the copy of the input saved
    before it, the next one the backward reads.  Mode ``"save"`` keeps
    the tensor."""

    def __init__(self, mode, device):
        self.mode = mode
        self.device = device
        self.records = []
        self.bytes = 0
        self.side = torch.cuda.Stream(device) if mode == "host" else None

    def saving(self, tensors):
        # weak: every saved variable keeps these hooks (and what they
        # close over) alive until the backward frees it
        targets = {id(t): weakref.ref(t) for t in tensors}

        def pack(t):
            ref = targets.get(id(t))
            if ref is None or ref() is not t:
                return t
            return self._pack(t)

        def unpack(obj):
            return self._unpack(obj) if isinstance(obj, _Saved) else obj

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    def _pack(self, t):
        rec = _Saved(len(self.records))
        self.records.append(rec)
        if self.mode == "save":
            rec.dev = t
            return rec
        self.side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(self.side):
            rec.host = torch.empty_like(t, device="cpu", pin_memory=True)
            rec.host.copy_(t.detach(), non_blocking=True)
        t.record_stream(self.side)
        self.bytes += t.numel() * t.element_size()
        return rec

    def _fetch(self, rec):
        if rec.dev is not None:
            return
        with torch.cuda.stream(self.side):
            rec.dev = torch.empty_like(rec.host, device=self.device)
            rec.dev.copy_(rec.host, non_blocking=True)
            rec.ready = torch.cuda.Event()
            rec.ready.record(self.side)

    def _unpack(self, rec):
        if self.mode == "save":
            return rec.dev
        self._fetch(rec)
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(rec.ready)
        t, rec.dev = rec.dev, None
        t.record_stream(cur)
        if rec.index > 0:
            self._fetch(self.records[rec.index - 1])
        return t


def _uniform_groups(program, segments):
    """The uniform layer groups among ``segments`` (``core.ir.
    find_uniform_groups``), each with the canonical names of its
    ``carry`` (inputs each repeat reads from the one before, the
    reference's scan carry) and its repeats' carry names (the block
    inputs)."""
    from .ir import find_uniform_groups

    out = []
    for g in find_uniform_groups(program, segments):
        ext, outs, count = g["ext_maps"], g["out_maps"], g["count"]
        carry = sorted(
            n for n in ext[0]
            if ext[1][n] in outs[0] and all(
                ext[k][n] == outs[k - 1][ext[1][n]] for k in range(1, count)))
        out.append({"start": g["start"], "period": g["period"],
                    "count": count, "carry": carry,
                    "inputs": [ext[k][n] for k in range(count)
                               for n in carry]})
    return out


def _layer_regions(program, segments, cut_types):
    """``selective``'s regions ``[(start, end, wrapped), ...]``: each
    repeat of a uniform group of ``segments`` is one wrapped region, cut
    at the ops of ``cut_types`` (each runs unwrapped on its own); segments
    outside every group keep their own wrap flag.  Also the groups
    (``start``, ``period``, ``count`` and the ``carry``) and the block
    inputs, every repeat's carry names."""
    ops = program.global_block().ops
    out, i = [], 0
    groups, block_inputs = [], []
    for g in _uniform_groups(program, segments):
        groups.append({k: g[k] for k in ("start", "period", "count",
                                         "carry")})
        block_inputs += g["inputs"]
        out += segments[i:g["start"]]
        for k in range(g["count"]):
            first = g["start"] + k * g["period"]
            s = segments[first][0]
            t = segments[first + g["period"] - 1][1]
            for j in range(s, t):
                if ops[j].type in cut_types:
                    out += [(s, j, True)] if j > s else []
                    out.append((j, j + 1, False))
                    s = j + 1
            if t > s:
                out.append((s, t, True))
        i = g["start"] + g["count"] * g["period"]
    return out + segments[i:], groups, block_inputs


def _remat_layout(program):
    """``(regions, groups, block_inputs, saved_types)`` of a program's
    ``memory_optimize`` marking, as the step runs it: ``selective`` and
    ``offload`` merge each layer's segments into one region
    (:func:`_layer_regions`) that saves the outputs of ``saved_types``;
    the other policies run the marked segments as they are (groups None:
    not computed)."""
    from ..memory_optimization_transpiler import EXPENSIVE_OPS, MXU_OPS

    segments = list(getattr(program, "_remat_segments", None) or [])
    if segments and getattr(program, "_remat_policy", None) in (
            "selective", "offload"):
        regions, groups, block_inputs = _layer_regions(
            program, segments, EXPENSIVE_OPS)
        return (regions, groups, frozenset(block_inputs),
                frozenset(MXU_OPS + EXPENSIVE_OPS))
    return segments, None, frozenset(), ()


def remat_plan(program, device):
    """The remat plan of ``program``'s step on ``device``, read without
    running it: ``{"policy", "offload"`` (the mode, ``_offload_mode``),
    ``"groups"`` (the uniform layer groups, each with its ``op_start`` /
    ``op_end`` range of ops), ``"regions"`` (``[(start, end, wrapped)]``:
    a wrapped region runs under ``torch.utils.checkpoint``),
    ``"saved_types"`` (op types whose outputs a wrapped region keeps),
    ``"block_inputs"`` (the names ``offload`` sends to the host)``}``;
    None without a ``memory_optimize`` marking.  The static half of
    ``Executor.last_remat_plan``, which the analysis checks read."""
    segments = list(getattr(program, "_remat_segments", None) or [])
    if not segments:
        return None
    regions, groups, block_inputs, saved = _remat_layout(program)
    if groups is None:
        groups = [{k: g[k] for k in ("start", "period", "count", "carry")}
                  for g in _uniform_groups(program, segments)]
    for g in groups:
        g["op_start"] = segments[g["start"]][0]
        g["op_end"] = segments[g["start"] + g["count"] * g["period"] - 1][1]
    return {"policy": getattr(program, "_remat_policy", None),
            "offload": _offload_mode(program, device),
            "groups": groups, "regions": [tuple(r) for r in regions],
            "saved_types": sorted(saved),
            "block_inputs": sorted(block_inputs)}


class _Forward:
    """The differentiated forward prefix ``block.ops[:bw]`` of a training
    program, with its remat regions when ``memory_optimize`` marked
    them."""

    def __init__(self, program, plan, aux_names):
        from .registry import get_op_impl

        self.block = block = program.global_block()
        self.bw = bw = block.backward_index
        self.plan = plan
        self.aux_names = aux_names
        ops = block.ops
        self.program = program
        segments, groups, self.block_inputs, saved_types = _remat_layout(
            program)
        self.groups = groups or []
        self.remat = bool(segments)
        self.saved_types = saved_types
        self.offloaded = []      # this step's _Offload of each forward
        # needed[i]: names read by ops[i:bw], the optimizer ops, fetches,
        # state or the loss
        needed = [set() for _ in range(bw + 1)]
        acc = set(aux_names)
        needed[bw] = set(acc)
        for i in range(bw - 1, -1, -1):
            acc.update(op_reads(program, ops[i]))
            needed[i] = set(acc)
        self.segments = []
        for s, t, wrap in segments:
            if not wrap:
                self.segments.append((s, t, None))
                continue
            seg_ops = ops[s:t]
            reads = []
            for op in seg_ops:
                reads += [n for n in op_reads(program, op)
                          if n not in reads]
            out_names = tuple(sorted(
                {n for op in seg_ops for n in op.output_names()}
                & needed[t]))
            draws = any(get_op_impl(op.type).stateful_rng
                        for op in seg_ops)
            self.segments.append((s, t, (reads, out_names, draws)))

    def run(self, ctx, env):
        """Evaluate the forward prefix into ``env`` under autograd."""
        ops, block, plan = self.block.ops, self.block, self.plan
        if not self.segments:
            run_block_ops(ctx, block, ops[:self.bw], env,
                          inside_grad_prefix=True, plan=plan)
            return
        mode = _offload_mode(self.program, ctx.device)
        off = None
        if mode != "off" and self.block_inputs:
            off = _Offload(mode, ctx.device)
            self.offloaded.append(off)
        for s, t, wrapped in self.segments:
            if wrapped is None:
                run_block_ops(ctx, block, ops[s:t], env,
                              inside_grad_prefix=True, plan=plan, first=s)
                continue
            reads, out_names, draws = wrapped
            in_names = [n for n in reads if n in env]
            moved = [env[n] for n in in_names if n in self.block_inputs]
            with (off.saving(moved) if off is not None and moved
                  else contextlib.nullcontext()):
                _checkpointed(ctx, block, ops[s:t], s, env, plan, in_names,
                              out_names, draws, self.saved_types)
            del moved
            for i in range(s, t):
                for n in plan.drop[i]:
                    env.pop(n, None)

    def plan_log(self, device):
        """``Executor.last_remat_plan`` for the step that just ran: the
        policy, the offload mode, the block inputs sent to the host (count
        and bytes, over every microbatch) and the layer groups; None
        without remat."""
        if not self.remat:
            return None
        offs, self.offloaded = self.offloaded, []
        return {"policy": getattr(self.program, "_remat_policy", None),
                "offload": _offload_mode(self.program, device),
                "offloaded": sum(len(o.records) for o in offs),
                "offloaded_bytes": sum(o.bytes for o in offs),
                "groups": [dict(g) for g in self.groups]}

    def grads(self, ctx, env, params, loss_name):
        """Forward into ``env``, then the parameters' gradients (zeros for
        an unused one).  ``env[loss_name]`` is left detached, and the
        generator at its end-of-forward state."""
        with torch.enable_grad():
            self.run(ctx, env)
            rng_after = ctx.gen.get_state()
            loss = env[loss_name]
            grads = torch.autograd.grad(loss.sum(), params,
                                        allow_unused=True)
        ctx.gen.set_state(rng_after)
        env[loss_name] = loss.detach()
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)]


def _accum_grads(fwd, ctx, env, params, feeds, persist_out, accum,
                 loss_name):
    """The mean gradient over ``accum`` microbatches of the feed batch
    (the reference's single-device ``_accum_grads``); writes the
    forward-written persistables and the reassembled fetches into
    ``env``."""
    mbs = {}
    for n, val in feeds.items():
        if val.dim() == 0:
            continue                    # 0-d feeds pass through unsplit
        b0 = val.shape[0]
        if b0 % accum:
            raise ValueError(
                f"gradient_accumulation(micro_steps={accum}): feed {n!r} "
                f"leading dim {b0} is not divisible")
        mbs[n] = b0 // accum
    full_b = feeds[sorted(mbs)[0]].shape[0] if mbs else 0
    block, bw = fwd.block, fwd.bw
    fwd_written = {n for op in block.ops[:bw] for n in op.output_names()}
    # state an optimize-role op of the forward writes (a schedule's step
    # counter) advances once a step: every microbatch starts from the
    # step's value, and the last one's result is kept
    once = {n for op in block.ops[:bw] if op.role == "optimize"
            for n in op.output_names()} & set(persist_out)
    carry = sorted(n for n in persist_out
                   if n in fwd_written and n in env and n not in once)
    # names the forward merely passes through (parameters, optimizer
    # state): env already holds their exact values
    passthrough = {v.name for v in block.program.persistable_vars()
                   if v.name not in fwd_written}
    gsum = None
    ys = {}
    for i in range(accum):
        e = dict(env)
        for n, mb in mbs.items():
            e[n] = env[n][i * mb:(i + 1) * mb]
        g = fwd.grads(ctx, e, params, loss_name)
        with torch.no_grad():
            if gsum is None:
                gsum = [x.float() for x in g]
            else:
                for acc, x in zip(gsum, g):
                    acc.add_(x.float())
        del g
        for n in carry:
            env[n] = e[n]
        last = {n: e[n] for n in once if n in e}
        for n in fwd.aux_names:
            if (n in e and n not in carry and n not in once
                    and n not in passthrough):
                ys.setdefault(n, []).append(e[n].detach())
        del e
    env.update(last)
    env.update(_reassemble(block, bw, ys, full_b))
    return [(x / accum).to(p.dtype) for x, p in zip(gsum, params)]


# additive combiners through which batch-sum-ness propagates linearly
_ADDITIVE = {"elementwise_add", "elementwise_sub", "sum", "scale"}


def _reassemble(block, bw, ys, full_b):
    """Per-microbatch values ``ys`` -> their big-batch values (the
    reference's ``_reassemble_accum_aux``, single device): a value whose
    variable's static leading dim is -1 or the feed batch concatenates; a
    pure batch-reduction sum (a ``reduce_sum`` over batch data, or an
    additive composite of such) adds; another float value is the mean of
    equal-weight microbatch values; anything else keeps the last."""
    producer = {}
    for op in block.ops[:bw]:
        for n in op.output_names():
            producer[n] = op

    def batch_leading(name):
        var = block._find_var(name)
        shape = tuple(var.shape) if var is not None else ()
        return len(shape) >= 1 and (
            shape[0] == -1 or (full_b and shape[0] == full_b))

    memo, cap_hits = {}, [0]

    def is_batch_sum(name, depth=0):
        """Memoized per name, except where the depth cap cut the subtree:
        that answer is conservative for this path only."""
        if depth > 64:
            cap_hits[0] += 1
            return False
        if name in memo:
            return memo[name]
        before = cap_hits[0]
        r = _batch_sum_uncached(name, depth)
        if cap_hits[0] == before:
            memo[name] = r
        return r

    def _batch_sum_uncached(name, depth):
        op = producer.get(name)
        if op is None:
            return False
        ins = op.input_names()
        if op.type == "reduce_sum":
            return any(batch_leading(i) for i in ins) or all(
                is_batch_sum(i, depth + 1) for i in ins)
        if op.type in _ADDITIVE:
            flags = [is_batch_sum(i, depth + 1) for i in ins]
            if op.type == "scale" and any(flags) and (
                    float(op.attrs.get("bias", 0.0)) != 0.0):
                # summing microbatch values would inflate the bias
                raise ValueError(
                    f"gradient_accumulation cannot reassemble fetch "
                    f"{name!r}: scale with a nonzero bias over a "
                    f"batch-sum term; apply the bias on the host")
            if any(flags) and not all(flags):
                raise ValueError(
                    f"gradient_accumulation cannot reassemble fetch "
                    f"{name!r}: it mixes batch-sum terms with non-sum "
                    f"terms (op {op.type!r}); fetch the parts separately "
                    f"and combine on the host")
            return all(flags) and bool(flags)
        return False

    out = {}
    for n, vals in ys.items():
        if vals[0].dim() >= 1 and batch_leading(n):
            out[n] = torch.cat(vals, dim=0)
        elif is_batch_sum(n):
            out[n] = torch.stack(vals).sum(dim=0)
        elif vals[0].is_floating_point():
            out[n] = torch.stack(vals).mean(dim=0)
        else:
            out[n] = vals[-1]
    return out


class Executor:
    """``Executor(place, mesh=None, donate_state=True)`` — ``place`` is
    ``CUDAPlace()``, ``CPUPlace()``, a device string, or None for the
    card.  With no place and no usable card it raises; the CPU must be
    asked for.  On the card every kernel library (flash attention, the
    fused CE head, ...) is built here, outside any timed step.
    ``donate_state`` is the JAX package's buffer-donation switch; it is
    accepted and does nothing in eager PyTorch, where the optimizer ops
    update the scope's tensors in place.

    ``mesh`` (``parallel.make_mesh``) runs this process as one rank of a
    mesh step (``parallel/spmd.py``): ``torch.distributed`` must be
    initialised with the mesh's size (``distributed.launch``), except for
    a mesh of one rank.  Persistables rest as this rank's blocks under
    their resolved specs, feeds are cut to this rank's rows (a tensor
    from ``parallel.local_shard`` is taken as already cut), fetches come
    back whole, the comm fields of ``last_step_cost`` count the last
    step's collectives as they ran, and ``last_comm_plan`` is the same log
    as a ``CommPlan`` in the reference's names
    (``analysis.comm.plan_from_log``), which its contracts read."""

    def __init__(self, place=None, mesh=None, donate_state=True):
        self.place = place
        # accepted for the JAX package's signature: eager PyTorch has no
        # buffers to donate (the optimizer ops update the scope's tensors
        # in place whatever this says), so it changes nothing
        self.donate_state = donate_state
        self.device = resolve_device(place)
        self._cache = {}
        self.last_step_cost = None
        # the last training step's remat plan (``_Forward.plan_log``):
        # policy, offload mode and bytes, layer groups; None without remat
        self.last_remat_plan = None
        self.mesh = mesh
        self.comm = None
        self.last_comm_plan = None
        # the attribution table of the last step folded in
        # (``_fold_in``); None until one is, or under PADDLE_TPU_ATTR=0
        self.last_attribution = None
        if self.device.type == "cuda":
            if self.device.index is None:  # "cuda" -> the current card
                self.device = torch.device(
                    "cuda", torch.cuda.current_device())
            from ..kernels import build_all

            build_all()
        if mesh is not None:
            import torch.distributed as dist

            from ..parallel.collectives import MeshComm

            if dist.is_available() and dist.is_initialized():
                rank = dist.get_rank()
                mesh.bind(rank)
            elif mesh.size == 1:
                rank = 0
            else:
                raise RuntimeError(
                    f"Executor(mesh={mesh}) needs torch.distributed "
                    f"initialised with {mesh.size} ranks "
                    f"(distributed.launch.init_multihost)")
            self.comm = MeshComm(mesh, rank)

    def shard_spec(self, program, name):
        """The resolved spec a persistable of ``program`` rests under on
        this executor's mesh (None off a mesh)."""
        if self.mesh is None:
            return None
        from ..parallel.api import compile_shardings

        return compile_shardings(self.mesh, program, [name])[name]

    def gather_state(self, program, scope=None, names=None):
        """``{name: whole tensor}`` of ``program``'s persistables the scope
        holds (``names`` to choose), each sharded one all-gathered from
        the ranks' blocks — a collective call: every rank calls it.  Off
        a mesh, the scope's tensors."""
        scope = scope or global_scope()
        names = names or [v.name for v in program.persistable_vars()
                          if scope.find_var(v.name) is not None]
        if self.mesh is None:
            return {n: scope.get(n) for n in names}
        specs = self._specs(program)
        block = program.global_block()
        out, saved = {}, self.comm.take_log()
        for n in names:
            t = scope.get(n)
            full = tuple(int(d) for d in block._find_var(n).shape)
            spec = tuple(specs.get(n) or ())
            if tuple(t.shape) != full:
                for d, e in enumerate(spec):
                    axes = e if isinstance(e, tuple) else ((e,) if e else ())
                    for ax in reversed(axes):
                        t = self.comm.all_gather(t, ax, d, n)
            out[n] = t
        self.comm.log = saved
        return out

    def _specs(self, program):
        """``{persistable: resolved spec}`` of ``program`` on the mesh,
        memoized per program version."""
        key = (program._serial, program._version)
        memo = getattr(self, "_spec_memo", None)
        if memo is None or memo[0] != key:
            from ..parallel.api import compile_shardings

            names = [v.name for v in program.persistable_vars()]
            self._spec_memo = memo = (key, compile_shardings(
                self.mesh, program, names))
        return memo[1]

    def feed_slicer(self, program):
        """``fn(name, tensor) -> this rank's rows`` of ``program``'s feeds,
        marked as cut (``parallel.local_shard``) — what a prefetcher
        applies before it copies a batch to the card."""
        from ..parallel import local_shard

        block = program.global_block()

        def cut(name, val):
            if block._find_var(name) is None or not val.dim():
                return val
            return local_shard(self._local_feed(block, name, val, 0)
                               .contiguous())

        return cut

    def _local_feed(self, block, name, val, dim):
        """This rank's rows of a feed (dim ``dim`` is the batch), by the
        feed's spec."""
        if getattr(val, "_pt_local_shard", False):
            return val
        var = block._find_var(name)
        spec = tuple(getattr(var, "partition_spec", None) or ())
        if not spec or spec[0] is None:
            return val
        axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        if axes != ("dp",) or any(e is not None for e in spec[1:]):
            raise NotImplementedError(
                f"feed {name!r} spec {spec}: the mesh path cuts feeds "
                f"along their batch dim over dp only")
        n = self.comm.size("dp")
        b = val.shape[dim]
        if b % n:
            raise ValueError(f"feed {name!r} batch {b} not divisible by "
                             f"dp={n}")
        return val.narrow(dim, self.comm.index("dp") * (b // n), b // n)

    # ------------------------------------------------------------------
    def _prepare(self, program, feed, fetch_list, scope, stacked=False):
        program = program or default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        scope.ensure_rng(program.random_seed, self.device)

        fetch_names = [
            v.name if hasattr(v, "name") else str(v) for v in fetch_list
        ]
        block = program.global_block()
        feeds = {}
        for n in sorted(feed):
            var = block._find_var(n)
            dtype = torch_dtype(var.dtype) if var is not None else None
            val = feed[n]
            if not isinstance(val, torch.Tensor):
                val = tensor_from_numpy(np.asarray(val))
            if self.mesh is not None and val.dim() > int(stacked):
                val = self._local_feed(block, n, val, int(stacked))
            # a tensor already on the device makes no host round trip
            feeds[n] = val.to(device=self.device, dtype=dtype)
        state_names = tuple(sorted(
            v.name for v in program.persistable_vars()
            if scope.find_var(v.name) is not None))
        if self.mesh is not None:
            self._shard_state(program, scope, state_names)
        state = {n: scope.get(n) for n in state_names}
        for n, t in state.items():
            if t.device != self.device:
                raise ValueError(
                    f"scope variable {n!r} lies on {t.device}, this "
                    f"Executor runs on {self.device}")
        return program, scope, feeds, fetch_names, state_names, state

    def _shard_state(self, program, scope, state_names):
        """Cut every whole persistable the scope holds to this rank's block
        (a fresh startup state, a loaded checkpoint); blocks stay."""
        from ..parallel.api import spec_axes
        from ..parallel.spmd import local_block

        specs = self._specs(program)
        block = program.global_block()
        for n in state_names:
            spec = specs.get(n)
            if not spec or not any(self.comm.size(a) > 1
                                   for a in spec_axes(spec)):
                continue
            t = scope.get(n)
            full = tuple(int(d) for d in block._find_var(n).shape)
            if tuple(t.shape) == full:
                scope.set(n, local_block(t, spec, self.mesh,
                                         self.comm.coords))

    def lower(self, program, fetch_names, state_names):
        """Build ``step(state, feeds, gen) -> (new_state, fetches,
        grad_norm)`` for a program — the eager counterpart of the JAX
        Executor's ``lower``.  The liveness plans and the remat segments'
        outputs are computed here, once per (program version, fetches,
        state)."""
        block = program.global_block()
        ops = block.ops
        bw = block.backward_index
        info = program._backward_info.get(0)
        written = {n for blk in program.blocks for op in blk.ops
                   for n in op.output_names()}
        persist_out = [v.name for v in program.persistable_vars()
                       if v.name in written or v.name in state_names]
        keep = set(fetch_names) | set(persist_out)
        if info is not None:
            keep.add(info["loss"])
        plan = _Plan(program, ops, keep)
        device = self.device
        sp = self._spmd(program) if self.mesh is not None else None
        if bw is None or info is None:
            def step(state, feeds, gen, trips=None):
                ctx = LoweringCtx(device, gen, program, trips, sp)
                env = dict(state)
                env.update(feeds)
                if sp is not None:
                    sp.reset()
                with torch.no_grad():
                    run_block_ops(ctx, block, ops, env, plan=plan)
                fetches = [env[n].detach() for n in fetch_names]
                if sp is not None:
                    fetches = self._mesh_fetches(sp, block, len(ops),
                                                 fetch_names, fetches, feeds)
                return ({n: env[n] for n in persist_out}, fetches, None)
            return step

        # what the forward hands the optimizer ops and the caller
        aux_names = set(keep)
        for op in ops[bw:]:
            aux_names.update(op.input_names())
        fwd = _Forward(program, plan, aux_names)
        accum = int(getattr(program, "_grad_accum", 1) or 1)
        emit_norm = _grad_norm_enabled()

        def step(state, feeds, gen, trips=None):
            ctx = LoweringCtx(device, gen, program, trips, sp)
            env = dict(state)
            env.update(feeds)
            param_names = [n for n in info["params"] if n in env]
            params = [env[n] for n in param_names]
            for p in params:
                p.requires_grad_(True)
            hooks = contextlib.nullcontext()
            overlap = contextlib.nullcontext()
            if sp is not None:
                sp.reset()
                sp.micro = accum > 1
                if sp.extra:
                    hooks = sp.saved_hooks()
                if accum <= 1:
                    overlap = sp.overlap_hooks(param_names, params)
            try:
                with hooks, overlap:
                    if accum <= 1:
                        grads = fwd.grads(ctx, env, params, info["loss"])
                    else:
                        grads = _accum_grads(fwd, ctx, env, params, feeds,
                                             persist_out, accum,
                                             info["loss"])
            finally:
                for p in params:
                    p.requires_grad_(False)
            with torch.no_grad():
                if sp is not None:
                    sp.micro = False
                    grads = sp.boundary_grads(param_names, grads, accum)
                if not emit_norm:
                    grad_norm = None
                elif sp is not None:
                    grad_norm = sp.grad_norm(param_names, grads, device)
                else:
                    # the step's global gradient norm: one f32 sum of
                    # squares per parameter and one sqrt, a pure extra
                    # output that nothing in the update reads
                    grad_norm = (torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g.float())
                         for g in grads]))
                        if grads else torch.zeros((), device=device))
                if NAN_GUARD[0]:
                    _raise_if_not_finite({info["loss"]: env[info["loss"]],
                                          GRAD_NORM_VAR: grad_norm})
                for n, g in zip(param_names, grads):
                    env[n + GRAD_SUFFIX] = g
                del grads
                run_block_ops(ctx, block, ops[bw:], env, plan=plan, first=bw)
                if sp is not None:
                    sp.flush_zero()
            self.last_remat_plan = fwd.plan_log(device)
            new_state = {n: env[n] for n in persist_out}
            fetches = [env[n].detach() for n in fetch_names]
            if sp is not None:
                fetches = self._mesh_fetches(sp, block, bw, fetch_names,
                                             fetches, feeds)
            return new_state, fetches, grad_norm

        if fwd.remat:
            # what the fold-in's op records read: which ops run inside a
            # checkpointed region, and the op types such a region saves
            step.layout = {"regions": [(s_, t_, w is not None)
                                       for s_, t_, w in fwd.segments],
                           "saved_types": sorted(fwd.saved_types)}
        return step

    def _spmd(self, program):
        """This rank's :class:`~paddle_tpu_torch.parallel.spmd.Spmd` view
        of ``program``: the resolved specs, and the ops of the layer
        groups a memory-optimized program repeats (the loops of its
        step)."""
        from ..parallel.api import _zero3_rs_enabled, scan_groups
        from ..parallel.spmd import Spmd

        loop_ops = set()
        segments = list(getattr(program, "_remat_segments", None) or ())
        if segments:
            for g in scan_groups(program, segments):
                first = segments[g["start"]][0]
                last = segments[g["start"] + g["count"] * g["period"] - 1][1]
                loop_ops.update(range(first, last))
        return Spmd(self.comm, program, self._specs(program), loop_ops,
                    rs=_zero3_rs_enabled())

    def _mesh_fetches(self, sp, block, bw, fetch_names, fetches, feeds):
        """Fetches whole: a tp-sharded value gathered, and over dp every
        rank's value reassembled as gradient accumulation reassembles
        microbatches (batch-leading values concatenate, batch sums add,
        other float values average)."""
        comm = self.comm
        ndp = comm.size("dp")
        out = []
        with comm.where("boundary", False):
            for n, v in zip(fetch_names, fetches):
                v = sp.fetch(n, v)
                if ndp > 1 and n not in sp.specs:
                    vals = comm.gather_objects(v, "dp")
                    full_b = _feed_batch(block, feeds) * ndp
                    v = _reassemble(block, bw, {n: vals}, full_b)[n]
                out.append(v)
        return out

    def _log_comm(self, cost):
        """Fold the step's collective log into the cost dict's comm fields
        (what ran) and ``last_comm_plan`` (the reference's names for it,
        which its contracts read)."""
        from ..analysis.comm import plan_from_log

        log = self.comm.take_log()
        self.last_comm_plan = plan_from_log(
            log, self.mesh.shape, cost.get("label"), reference=True)
        plan = plan_from_log(log, self.mesh.shape, cost.get("label"))
        rep = plan.comm_report()
        cost.update(
            comm_plan=plan.summary(),
            collective_count=rep["collective_count"],
            collective_bytes=rep["collective_bytes"],
            collective_op_kinds=dict(rep["collective_ops"]),
            reduce_ops=rep["reduce_ops"], reduce_bytes=rep["reduce_bytes"],
            reduce_ops_in_loop=rep["reduce_ops_in_loop"],
            collectives_in_loop=rep["collectives_in_loop"],
            overlapped_reductions=self.comm.overlapped)
        reg = _obs.get_registry()
        reg.counter("executor.collective_bytes",
                    help="bytes of the mesh steps' collectives").inc(
            rep["collective_bytes"])
        return cost

    def _entry(self, program, fetch_names, state_names):
        """``(step, cost)`` for this signature, lowered (and counted) on
        a miss; and whether it was a cache hit."""
        key = (program._serial, program._version, tuple(fetch_names),
               state_names, _grad_norm_enabled())
        reg = _obs.get_registry()
        entry = self._cache.get(key)
        if entry is not None:
            reg.counter("executor.cache_hits").inc()
            return entry, True
        reg.counter("executor.cache_misses").inc()
        _check_fetches(program, fetch_names)
        t0 = time.perf_counter()
        step = self.lower(program, fetch_names, state_names)
        dt = time.perf_counter() - t0
        reg.counter("executor.compile_count",
                    help="step lowerings (cache misses)").inc()
        reg.histogram("executor.compile_seconds").observe(dt)
        cost = {"label": f"run:{program._serial}v{program._version}",
                "compile_seconds": dt, "bytes_accessed": None}
        entry = self._cache[key] = (step, cost, {}, {})
        return entry, False

    def _cost(self, program, entry, cache_hit, feeds, steps=None,
              trips=None):
        """The ``last_step_cost`` of a run: the entry's cost with the
        flops of this batch (memoized per batch; a ``while`` loop's
        sub-block added for the ``trips`` the run recorded, over all its
        steps) and the hit flag."""
        _, cost, flops_by_batch, folds = entry
        batch = _feed_batch(program.global_block(), feeds)
        if batch not in flops_by_batch:
            flops_by_batch[batch] = step_flops(program, batch)
        static = flops_by_batch[batch]
        flops = static * (1 if steps is None else steps)
        if trips:
            flops += step_flops(program, batch, trips) - static
        out = dict(cost, flops=flops, cache_hit=cache_hit)
        out.update(folds.get(batch, {}))
        if steps is not None:
            out["steps"] = steps
        from ..tune import tune_stats

        ts = tune_stats()
        if ts:
            out["tune"] = ts
        return out

    def _fold_probe(self, program, entry, feeds, state):
        """What the fold-in needs from before the first run of a lowered
        step at a batch (None on every later run, or with both kill
        switches set): the batch, the updated state's tensors and the
        kernel family counters."""
        from ..analysis import lint_enabled
        from ..observability.attribution import attribution_enabled

        t0 = time.perf_counter()
        batch = _feed_batch(program.global_block(), feeds)
        if batch in entry[3] or not (attribution_enabled()
                                     or lint_enabled()):
            return None
        from .. import kernels
        from ..analysis.hlo_tools import updated_state

        probe = {"batch": batch,
                 "before": {n: state[n] for n in updated_state(program)
                            if n in state},
                 "families": kernels.family_counts()}
        probe["seconds"] = time.perf_counter() - t0
        return probe

    def _fold_in(self, program, entry, probe, scope, trips, fetch_names,
                 steps=None):
        """The reference's compile-time fold-in, over the run just made.
        At the first run of a lowered step at a batch: the attribution
        table of the step (``last_attribution``; ``attribution``,
        ``bytes_accessed``), the cost model's status (``costmodel``) and
        what the kernel ops ran (``kernel_backends``), kept for the step
        and batch.  At the step's first run only: the program- and
        run-level lint findings (``lint_findings`` / ``lint_errors`` /
        ``lint_checks``), kept for the step, since the Program they read
        does not change with the batch.  Every later run's
        ``last_step_cost`` carries both.  ``PADDLE_TPU_ATTR=0`` and
        ``PADDLE_TPU_LINT=0`` leave their keys out; neither ever blocks a
        run.  The hook's own seconds go to ``executor.fold_in_seconds``
        (from before the run: the probe included)."""
        from .. import kernels
        from ..analysis import compile_findings, lint_enabled
        from ..analysis import hlo_tools
        from ..analysis.jaxpr_tools import step_records
        from ..observability import attribution as _attr
        from ..tune.cache import device_platform
        from ..tune.costmodel import model_status

        t1 = time.perf_counter()
        reg = _obs.get_registry()

        def failed():
            # telemetry never blocks a run; each failure is counted
            reg.counter("executor.fold_in_errors",
                        help="fold-in parts that raised (attribution, "
                             "lint, cost model)").inc()

        batch = probe["batch"]
        first = not entry[3]     # the lowered step's first fold
        fold = {}
        records = None
        try:
            records = step_records(program, batch, trips,
                                   plan=getattr(entry[0], "layout", None))
        except Exception:  # noqa: BLE001 — telemetry must never block
            failed()
        comm_plan = self.last_comm_plan if self.comm is not None else None
        if records is not None and _attr.attribution_enabled():
            try:
                flops = self.last_step_cost["flops"] // (steps or 1)
                att = _attr.attribute_step(
                    program, batch, flops=flops, comm_plan=comm_plan,
                    device=self.device, records=records)
                self.last_attribution = att
                fold["attribution"] = _attr.summarize(att)
                fold["bytes_accessed"] = att["bytes_total"]
            except Exception:  # noqa: BLE001 — telemetry must never block
                failed()
        try:
            fold["costmodel"] = model_status(device_platform(self.device))
        except Exception:  # noqa: BLE001 — telemetry must never block
            failed()
        kb = {}
        if records is not None:
            try:
                kb = hlo_tools.kernel_backends(
                    records, probe["families"], kernels.family_counts(),
                    self.device)
            except Exception:  # noqa: BLE001 — telemetry must never block
                failed()
            if kb:
                fold["kernel_backends"] = kb
        entry[3][batch] = fold
        if first and lint_enabled():
            try:
                mem = {"hbm_high_water_bytes": None, "source": None}
                if self.device.type == "cuda":
                    mem = hlo_tools.static_memstats(program, batch)
                names = list(probe["before"])
                mem.update(hlo_tools.inplace_record(
                    probe["before"], {n: scope.get(n) for n in names}))
                findings = compile_findings(
                    program=program, fetch_names=fetch_names, memstats=mem,
                    comm=comm_plan.comm_report() if comm_plan else {},
                    donate=self.donate_state, kernel_backends=kb,
                    mesh=self.mesh, comm_plan=comm_plan,
                    label=self.last_step_cost.get("label"),
                    device=self.device)
            except Exception:  # noqa: BLE001 — lint must never block a run
                failed()
                findings = []
            lint = {"lint_findings": len(findings),
                    "lint_errors": sum(1 for f in findings
                                       if f.severity == "error")}
            if findings:
                lint["lint_checks"] = sorted({f.check
                                              for f in findings})[:8]
            entry[1].update(lint)     # the step's: every batch carries it
            fold.update(lint)
        self.last_step_cost.update(fold)
        # the hook's time: the probe before the run and the fold after it
        reg.histogram("executor.fold_in_seconds").observe(
            time.perf_counter() - t1 + probe["seconds"])

    def _generator(self, scope):
        """The step's generator, at the state the scope carries."""
        gen = torch.Generator(device=self.device)
        gen.set_state(scope.get(RNG_VAR))
        return gen

    @staticmethod
    def _run_lowered(step, scope, state, feeds, gen, trips=None,
                     fetch_names=()):
        """Run one lowered step and write what it leaves — the new state,
        the generator's state, the gradient norm — back to ``scope``;
        the fetches.  ``run`` and every step of ``run_steps`` go through
        here, so both thread the state alike.  A ``while`` loop adds its
        trips to ``trips``.  Under ``FLAGS.check_nan_inf`` every float the
        step wrote or fetched (``fetch_names``) is checked; under
        ``FLAGS.do_memory_benchmark`` the state's bytes are printed."""
        new_state, fetches, grad_norm = step(state, feeds, gen, trips)
        if FLAGS.check_nan_inf:
            # FLAGS_check_nan_inf (reference executor.cc:131): everything
            # the step wrote or fetched; a host sync a tensor, so only
            # when the flag is set
            _raise_if_not_finite(
                {n: t for n, t in list(new_state.items())
                 + list(zip(fetch_names, fetches))
                 if isinstance(t, torch.Tensor) and t.is_floating_point()},
                when="after the step")
        if FLAGS.do_memory_benchmark:
            total = sum(t.numel() * t.element_size()
                        for t in new_state.values()
                        if isinstance(t, torch.Tensor))
            print(f"[memory] live state: {total / 1e6:.2f} MB "
                  f"({len(new_state)} vars)")
        scope.update(new_state)
        scope.set(RNG_VAR, gen.get_state())
        if grad_norm is not None:
            scope.set(GRAD_NORM_VAR, grad_norm)
        return fetches

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program, scope, feeds, fetch_names, state_names, state = (
            self._prepare(program, feed, fetch_list, scope))
        entry, cache_hit = self._entry(program, fetch_names, state_names)
        probe = self._fold_probe(program, entry, feeds, state)
        trips = {}
        fetches = self._run_lowered(entry[0], scope, state, feeds,
                                    self._generator(scope), trips,
                                    fetch_names)
        self.last_step_cost = self._cost(program, entry, cache_hit, feeds,
                                         trips=trips)
        if self.comm is not None:
            self._log_comm(self.last_step_cost)
        if probe is not None:
            self._fold_in(program, entry, probe, scope, trips, fetch_names)
        if return_numpy:
            return [tensor_to_numpy(f) for f in fetches]
        return fetches

    def run_steps(self, program=None, feed=None, fetch_list=None, steps=None,
                  scope=None, return_numpy=True):
        """Run ``steps`` training steps in one call.  ``feed`` values are
        STACKED along a leading steps axis (``[steps, batch, ...]``);
        ``steps`` defaults to that axis.  Fetches come back stacked
        (``[steps, ...]``).  State (parameters, moments, the RNG) threads
        through the steps exactly as across ``steps`` separate ``run``
        calls, so the results are those calls' bits."""
        program, scope, feeds, fetch_names, state_names, state = (
            self._prepare(program, feed, fetch_list, scope, stacked=True))
        if steps is None:
            if not feeds:
                raise ValueError("steps is required when there is no feed")
            steps = int(next(iter(feeds.values())).shape[0])
        for n, v in feeds.items():
            if v.dim() == 0 or v.shape[0] != steps:
                raise ValueError(
                    f"feed {n!r} leading (steps) axis "
                    f"{tuple(v.shape)[:1]} != {steps}; run_steps feeds are "
                    f"stacked [steps, ...]")
        # every step must read the state the last one wrote: a
        # persistable the step would create is not threaded (run()
        # tolerates a step creating it; a fixed state set cannot)
        written = {n for blk in program.blocks for op in blk.ops
                   for n in op.output_names()}
        extra = sorted(v.name for v in program.persistable_vars()
                       if v.name in written and v.name not in state_names)
        if extra:
            raise ValueError(
                f"run_steps needs persistable var(s) {extra} initialized "
                f"before the steps (run the startup program, or one "
                f"regular run() step, first)")
        entry, cache_hit = self._entry(program, fetch_names, state_names)
        step_feeds = [{n: v[i] for n, v in feeds.items()}
                      for i in range(steps)]
        probe = (self._fold_probe(program, entry, step_feeds[0], state)
                 if step_feeds else None)
        gen = self._generator(scope)
        outs, trips = [], {}
        for fs in step_feeds:
            outs.append(self._run_lowered(entry[0], scope, state, fs, gen,
                                          trips, fetch_names))
            state = {n: scope.get(n) for n in state_names}
        self.last_step_cost = self._cost(
            program, entry, cache_hit,
            step_feeds[0] if step_feeds else {}, steps, trips)
        if self.comm is not None:
            self._log_comm(self.last_step_cost)
        if probe is not None:
            self._fold_in(program, entry, probe, scope, trips, fetch_names,
                          steps)
        fetches = [torch.stack(col) for col in zip(*outs)] if outs else []
        if return_numpy:
            return [tensor_to_numpy(f) for f in fetches]
        return fetches
