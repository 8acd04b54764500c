"""Step artifact tools for the static-analysis engine — the port's
counterpart of ``paddle_tpu/analysis/jaxpr_tools.py``.

The reference walks the traced jaxpr of a step.  An eager step has none;
what stands in for it is the **lowered step**:

* its **op records** (:func:`step_records`): every op the step runs —
  the differentiated forward, the optimizer ops, the sub-blocks of the
  control-flow ops for the trips they run — with the shapes and dtypes
  its values take at the run's batch (the static shapes with -1 read as
  the batch, a ``while`` loop's recorded shapes where the run kept them:
  the records ``core.executor.step_flops`` counts), which inputs take a
  gradient, and whether the backward recomputes the op (it sits in a
  checkpointed region of the remat plan and its type is not saved);
* its **remat plan** (``core.executor.remat_plan``): the policy, the
  offload mode, the uniform layer groups (the reference's ``lax.scan``
  over layers) and the checkpointed regions.

:func:`walk_report` makes one pass over both for every ``jaxpr``-level
check, with the reference's field names: the kernel-call locality fields
(``pallas_total`` / ``pallas_outside_scan`` count the flash ops of the
forward, inside or outside a layer group), ``name_tags`` (the offload /
kernel-residual contract, from the plan), ``low_precision_carries`` /
``low_precision_reduces`` (from the records' dtypes), ``tanh_in_scan``
(tanh ops inside a checkpointed region) and ``sharding_constraints``
(``shard_activation``'s recorded specs).
"""

import math

__all__ = [
    "KERNEL_RESIDUAL_TAG", "BLOCK_INPUT_TAG", "KERNEL_OPS", "FLASH_OPS",
    "OpRecord", "step_records", "kernel_call", "jaxpr_report",
    "walk_report",
]

# the reference's checkpoint-name tags; the port's plan reads them as:
# block inputs sent to the host by ``offload`` (BLOCK_INPUT), kernel
# residuals kept for the kernels' own backward (KERNEL_RESIDUAL)
KERNEL_RESIDUAL_TAG = "pt_kernel_res"
BLOCK_INPUT_TAG = "pt_blk_in"

# the Program ops whose lowering is one of the port's hand-written
# kernels (flash attention, the fused CE head)
FLASH_OPS = ("flash_attention", "flash_attention_packed")
KERNEL_OPS = FLASH_OPS + ("fused_softmax_ce_head",)

# reduced-precision dtypes whose naive accumulation loses low bits after
# a few thousand terms (the bf16-accum lint's trigger set)
_LOW_PRECISION = ("bfloat16", "float16")

# a reduction folding at least this many elements per output element in
# reduced precision is worth flagging (under it, the error is noise)
REDUCE_ACCUM_MIN_ELEMS = 4096

# the reductions the bf16-accum probe reads (sum-like: max/min are exact)
_SUM_REDUCES = ("reduce_sum", "reduce_mean", "mean", "sum")

# tanh-based activations: the reference's reassociation hazard set
_TANH_OPS = ("tanh", "stanh", "tanh_shrink")


class OpRecord:
    """One op of the lowered step: ``op`` in block ``block`` at
    ``index``, run ``times`` times a step (a sub-block's trips), in
    ``phase`` ("forward": the differentiated forward of a training step;
    "optimize": the ops after the backward marker; "step": a step with no
    backward), ``ins`` / ``outs`` as ``(name, shape, dtype)`` (shape None
    for an undeclared name), ``grads`` the input names that take a
    gradient, ``wrapped`` whether it runs inside a checkpointed region,
    ``recompute`` whether the backward runs it again, ``depth`` 0 for the
    global block and n inside n control-flow ops."""

    __slots__ = ("block", "index", "op", "times", "phase", "ins", "outs",
                 "grads", "wrapped", "recompute", "depth")

    def __init__(self, block, index, op, times, phase, ins, outs, grads,
                 wrapped, recompute, depth):
        self.block, self.index, self.op = block, index, op
        self.times, self.phase = times, phase
        self.ins, self.outs, self.grads = ins, outs, grads
        self.wrapped, self.recompute, self.depth = wrapped, recompute, depth

    @property
    def type(self):
        return self.op.type

    def __repr__(self):
        return (f"OpRecord({self.type} b{self.block}:{self.index} "
                f"x{self.times} {self.phase})")


def _numel(shape):
    return math.prod(shape) if shape is not None else 0


def step_records(program, batch=1, trips=None, plan=None):
    """The op records of one step of ``program`` at ``batch`` (see
    :class:`OpRecord`).  ``trips``: the ``{id(op): (n, shapes)}`` a run
    recorded for its ``while`` loops (``LoweringCtx.trips``); a loop the
    run did not record counts its sub-block once per trip its ``trips``
    hook gives, or 0 times.  ``plan``: a remat plan
    (``core.executor.remat_plan``, or the lowered step's ``layout``:
    its ``regions`` and ``saved_types``) that marks the checkpointed
    regions of a training step; None reads it from the program at the
    CPU's offload mode, which the regions do not depend on."""
    import torch

    from ..core.executor import remat_plan
    from ..core.program import GRAD_SUFFIX, Parameter
    from ..core.registry import get_op_impl

    gb = program.global_block()
    bw = gb.backward_index
    info = program._backward_info.get(0)
    train = bw is not None and info is not None
    trained = set(info["params"]) if train else set()
    trips = trips or {}
    if plan is None and train:
        plan = remat_plan(program, torch.device("cpu"))
    wrapped_at, saved = set(), frozenset()
    if plan:
        saved = frozenset(plan["saved_types"])
        for s, t, w in plan["regions"]:
            if w:
                wrapped_at.update(range(s, t))
    out = []

    def walk(block, ops, first, ran, times, phase, depth, wrapped):
        seen = {}   # name -> (value, takes a gradient), this block's

        def resolve(name):
            hit = seen.get(name)
            if hit is not None:
                return hit
            base = name[:-len(GRAD_SUFFIX)] if name.endswith(
                GRAD_SUFFIX) else name
            var = block._find_var(base)
            dtype = getattr(var, "dtype", None)
            if ran is not None and name in ran:
                shape = tuple(int(d) for d in ran[name])
            elif var is None or var.shape is None:
                shape = None
            else:
                shape = tuple(batch if int(d) == -1 else int(d)
                              for d in var.shape)
            grad = train and phase == "forward" and (
                name in trained or (var is not None and base == name and not (
                    isinstance(var, Parameter) or var.is_data
                    or var.stop_gradient)))
            hit = seen[name] = ((name, shape, dtype), grad)
            return hit

        for i, op in enumerate(ops):
            idx = first + i
            w = wrapped or (depth == 0 and idx in wrapped_at)
            ins = [seen.get(n) or resolve(n) for n in op.input_names()]
            rec = OpRecord(
                block.idx, idx, op, times, phase, [v for v, _g in ins],
                [(seen.get(n) or resolve(n))[0] for n in op.output_names()],
                {v[0] for v, g in ins if g}, w,
                w and op.type not in saved, depth)
            out.append(rec)
            sub = op.attrs.get("sub_block")
            if sub is None:
                continue
            impl = get_op_impl(op.type)
            n, sub_ran = trips.get(id(op), (None, None))
            if n is None and impl.trips is not None:
                n = impl.trips(
                    op, lambda nm: list(resolve(nm)[0][1] or ()))
            if n:
                sub_blk = program.block(sub)
                walk(sub_blk, sub_blk.ops, 0, sub_ran, times * int(n),
                     phase, depth + 1, w)

    if train:
        walk(gb, gb.ops[:bw], 0, None, 1, "forward", 0, False)
        walk(gb, gb.ops[bw:], bw, None, 1, "optimize", 0, False)
    else:
        walk(gb, gb.ops, 0, None, 1, "step", 0, False)
    return out


def _carry_accumulations(program, rec):
    """Reduced-precision accumulator carries of one ``scan_block``
    record: carried states of a bf16/f16 dtype that the step body writes
    from an ``elementwise_add`` / ``sum`` reading the carried state
    itself — the ``acc = acc + delta`` spelling that drops low bits once
    the running sum outgrows the terms.  A residual stream (``x + attn``)
    does not match: its add combines two derived values."""
    op = rec.op
    sub = program.block(op.attrs["sub_block"])
    states = list(op.attrs.get("state_names", []))
    producer = {}
    for sop in sub.ops:
        for n in sop.output_names():
            producer[n] = sop
    found = []
    t = None
    xs = op.inputs.get("X") or []
    if xs:
        var = program.global_block()._find_var(xs[0])
        if var is not None and len(var.shape) > 1:
            t = int(var.shape[1])
    for i, name in enumerate(states):
        var = sub._find_var(name)
        if var is None or var.dtype.name not in _LOW_PRECISION:
            continue
        p = producer.get(name)
        # the state is written by an assign of the new value
        if p is not None and p.type == "assign":
            p = producer.get(p.inputs["X"][0])
        if p is not None and p.type == "cast":
            p = producer.get(p.inputs["X"][0])
        if p is None or p.type not in ("elementwise_add", "sum"):
            continue
        if name in p.input_names():
            found.append({"carry_index": i, "dtype": var.dtype.name,
                          "shape": tuple(var.shape), "scan_length": t})
    return found


def kernel_call(rec):
    """A kernel op's record as the checks read it: type, place, trips,
    whether the backward recomputes it, its dtype, its values' shapes
    (inputs first), the width its family rule reads (``d``: the head
    dim of a flash op, the model width of the CE head; ``v``: the CE
    head's vocabulary) and its ``backend`` attr (None: env and auto
    decide)."""
    shapes = [s for _n, s, _d in rec.ins + rec.outs if s]
    call = {"type": rec.type, "index": rec.index, "block": rec.block,
            "times": rec.times, "recompute": rec.recompute,
            "dtype": rec.ins[0][2].name if rec.ins and rec.ins[0][2]
            else None, "shapes": shapes, "d": None, "v": None,
            "backend": rec.op.attrs.get("backend") or None}
    if shapes:
        d = shapes[0][-1]
        if rec.type == "flash_attention_packed":
            d //= int(rec.op.attrs.get("n_head") or 1)
        call["d"] = d
        if rec.type == "fused_softmax_ce_head" and len(shapes) > 1:
            call["v"] = shapes[1][-1]
    return call


def walk_report(program, records, plan, layer_counts=(), batch=None):
    """One pass over a lowered step's op records and remat plan feeding
    every ``jaxpr``-level check (the fields are listed in the module
    docstring).  ``layer_counts``: leading-dim candidates for the
    layer-stacked probes (the caller's hint plus every group's repeat
    count); a count equal to the run's ``batch`` cannot tell a stacked
    layer axis from the batch, so it is not probed."""
    layer_counts = tuple(sorted({int(c) for c in layer_counts
                                 if c and c != batch}))
    groups = (plan or {}).get("groups") or []
    spans = [(g["op_start"], g["op_end"]) for g in groups]
    report = {
        "pallas_calls": [],
        "pallas_total": 0,
        "pallas_outside_scan": 0,
        "kernel_calls": [],
        "scan_lengths": [g["count"] for g in groups],
        "layer_stacked_pallas": [],
        "residual_stacks": [],
        "name_tags": set(),
        "low_precision_carries": [],
        "low_precision_reduces": [],
        "tanh_in_scan": 0,
        "sharding_constraints": [],
    }
    train = any(r.phase == "forward" for r in records)
    for r in records:
        if r.type in KERNEL_OPS and r.phase != "optimize":
            call = kernel_call(r)
            shapes = call["shapes"]
            report["kernel_calls"].append(call)
            if layer_counts:
                report["layer_stacked_pallas"] += [
                    s for s in shapes if len(s) >= 2
                    and s[0] in layer_counts]
            if train and not r.recompute:
                # the kernel's residuals are saved for its own backward
                report["name_tags"].add(KERNEL_RESIDUAL_TAG)
        if r.type in FLASH_OPS and r.phase != "optimize":
            inside = r.depth > 0 or any(s <= r.index < e for s, e in spans)
            report["pallas_calls"].append(
                {"index": r.index, "in_group": inside, "times": r.times})
            report["pallas_total"] += 1
            report["pallas_outside_scan"] += 0 if inside else 1
        if r.type in _TANH_OPS and r.wrapped:
            report["tanh_in_scan"] += 1
        if r.type == "scan_block":
            report["scan_lengths"].append(
                _numel(r.ins[0][1][1:2]) if r.ins and r.ins[0][1] else None)
            report["low_precision_carries"] += _carry_accumulations(
                program, r)
        if r.type in _SUM_REDUCES and r.ins and r.outs:
            (_n, ishape, idt), (_m, oshape, odt) = r.ins[0], r.outs[0]
            if (idt is not None and odt is not None and ishape
                    and idt.name in _LOW_PRECISION
                    and odt.name in _LOW_PRECISION):
                folded = _numel(ishape) // max(_numel(oshape or ()), 1)
                if folded >= REDUCE_ACCUM_MIN_ELEMS:
                    report["low_precision_reduces"].append({
                        "op": r.type, "dtype": idt.name,
                        "shape": tuple(ishape), "folded_elems": folded,
                        "scan_depth": r.depth})
    if plan and plan.get("block_inputs") and plan.get("offload") != "off":
        report["name_tags"].add(BLOCK_INPUT_TAG)
    # shard_activation's recorded specs on intermediates: the declared
    # annotations (the reference's pt_shard[var] scope)
    block = program.global_block()
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            var = block._find_var(n)
            spec = getattr(var, "partition_spec", None)
            if spec is None or var.persistable or var.is_data:
                continue
            depth = 1 if any(s <= i < e for s, e in spans) else 0
            axes = sorted({a for e in spec if e
                           for a in (e if isinstance(e, tuple) else (e,))})
            report["sharding_constraints"].append(
                {"scan_depth": depth, "scope": f"pt_shard[{n}]",
                 "spec": str(spec), "axes": axes})
    return report


def jaxpr_report(program, records, plan, layer_count=None, batch=None):
    """The kernel-call locality report of a lowered step (the reference's
    contract): ``pallas_calls``, ``pallas_total`` /
    ``pallas_outside_scan``, ``scan_lengths``, ``layer_stacked_pallas``
    and ``residual_stacks`` (always empty: an eager step stacks no
    layer's residuals)."""
    rep = walk_report(program, records, plan,
                      layer_counts=(layer_count,) if layer_count else (),
                      batch=batch)
    return {k: rep[k] for k in (
        "pallas_calls", "pallas_total", "pallas_outside_scan",
        "scan_lengths", "layer_stacked_pallas", "residual_stacks")}
