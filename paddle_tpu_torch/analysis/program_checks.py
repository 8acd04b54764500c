"""Program-IR-level checks: pure-Python walks over blocks/ops/vars — the
port's counterpart of ``paddle_tpu/analysis/program_checks.py``, ported
as it is.  The port's Program has the reference's ops and vars, so the
Program itself is the artifact here in both packages.  These catch the
defect classes a Program can express before the Executor ever lowers
it: dead code, declared shape/dtype inconsistencies, reads of values
the step will never have, fetch hazards, and sharding specs that cannot
hold (the fallbacks ``parallel/api.py`` records)."""

from .framework import register_check

# findings per check are capped so a pathological program cannot turn
# the report (or the trainer JSONL summary) into a megabyte of text
MAX_FINDINGS = 25

# ops whose output shape/dtype mirror their (single) input — the
# conservative inference set for program.shape-dtype
_UNARY_PRESERVING = frozenset((
    "relu", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt", "abs",
    "square", "softplus", "softsign", "ceil", "floor", "round",
    "reciprocal", "leaky_relu", "elu", "relu6", "brelu", "soft_relu",
    "stanh", "hard_shrink", "softshrink", "thresholded_relu",
    "hard_sigmoid", "swish", "softmax", "scale", "tanh_shrink",
))

_ELEMENTWISE = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
))


def _op_loc(block, i, op):
    return f"block {block.idx} op {i} ({op.type})"


def _static(shape):
    return shape and all(s is not None and int(s) >= 0 for s in shape)


def _sub_block_names(program, block_idx):
    """(reads, writes) anywhere under a sub-block, nested included —
    the pruner's traversal (``core/ir.sub_block_names``), shared so the
    checks can never diverge from what lowering actually touches."""
    from ..core.ir import sub_block_names

    return sub_block_names(program, block_idx)


def _roots(ctx):
    """Liveness roots of the dead-code slice: fetches, the backward
    loss(es) (the Executor differentiates them even when not fetched),
    and every persistable write (parameter updates, BN stats, metric
    accumulators)."""
    program = ctx.program
    roots = set(ctx.fetch_names)
    for info in getattr(program, "_backward_info", {}).values():
        if info.get("loss"):
            roots.add(info["loss"])
    block = program.global_block()
    persistable = {v.name for v in program.persistable_vars()}
    for op in block.ops:
        roots |= set(op.output_names()) & persistable
    return roots


@register_check("program.dead-code", level="program")
def dead_code(ctx):
    """Ops whose outputs are (transitively) unneeded for any fetch, loss,
    or persistable write — traced, differentiated and executed for
    nothing — plus variables declared but touched by no op at all."""
    program = ctx.program
    block = program.global_block()
    needed = _roots(ctx)
    kept = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        outs = set(op.output_names())
        if outs & needed or getattr(op, "role", "forward") == "optimize":
            kept[i] = True
            needed |= set(op.input_names())
            sub = op.attrs.get("sub_block")
            if sub is not None:
                r, _w = _sub_block_names(program, sub)
                needed |= r
    findings = []
    for i, op in enumerate(block.ops):
        if kept[i]:
            continue
        if len(findings) >= MAX_FINDINGS:
            findings.append(ctx.finding(
                "program.dead-code", "warning", "program", "block 0",
                "more dead ops elided (finding cap reached)"))
            break
        findings.append(ctx.finding(
            "program.dead-code", "warning", "program",
            _op_loc(block, i, op),
            f"op {op.type!r} writing {sorted(op.output_names())[:3]} is "
            f"dead: no fetch, loss or persistable state depends on it",
            hint="drop the op (or Program.prune(targets) the program), "
                 "or add its output to fetch_list if it was meant to be "
                 "observed"))
    touched = set()
    for blk in program.blocks:
        for op in blk.ops:
            touched |= set(op.input_names()) | set(op.output_names())
    for blk in program.blocks:
        for v in blk.vars.values():
            if (v.name in touched or v.persistable
                    or getattr(v, "is_data", False)
                    or v.name in set(ctx.fetch_names)):
                continue
            if len(findings) >= 2 * MAX_FINDINGS:
                return findings
            findings.append(ctx.finding(
                "program.dead-code", "warning", "program",
                f"block {blk.idx} var {v.name}",
                f"variable {v.name!r} is declared but no op reads or "
                f"writes it",
                hint="remove the declaration — it is unreachable in the "
                     "lowered step"))
    return findings


@register_check("program.read-before-write", level="program")
def read_before_write(ctx):
    """Reads of non-persistable, non-data variables no earlier op wrote:
    the lowered step's env will not contain them — a guaranteed
    trace-time KeyError, reported here with the op that trips it."""
    from ..core.program import GRAD_SUFFIX

    program = ctx.program
    block = program.global_block()
    available = {v.name for v in program.persistable_vars()}
    for blk in program.blocks:
        for v in blk.vars.values():
            if getattr(v, "is_data", False) or v.persistable:
                available.add(v.name)
    bw = block.backward_index
    findings = []
    for i, op in enumerate(block.ops):
        grads_live = bw is not None and i >= bw
        reads = set(op.input_names())
        sub = op.attrs.get("sub_block")
        sub_writes = set()
        if sub is not None:
            r, sub_writes = _sub_block_names(program, sub)
            # order inside a sub-block is the sub-lowerer's business;
            # only names neither available outside nor written anywhere
            # within the sub-block are definite misses
            reads |= r - sub_writes
        for n in sorted(reads):
            if n in available or n in sub_writes:
                continue
            if grads_live and n.endswith(GRAD_SUFFIX):
                continue  # injected by the Executor's autodiff seam
            if len(findings) >= MAX_FINDINGS:
                return findings
            findings.append(ctx.finding(
                "program.read-before-write", "error", "program",
                _op_loc(block, i, op),
                f"op {op.type!r} reads {n!r} which no earlier op writes "
                f"and which is neither a data var nor persistable",
                hint="write the variable first (or declare it as data / "
                     "persistable so the feed or scope provides it)"))
        available |= set(op.output_names()) | sub_writes
    return findings


@register_check("program.fetch-overwritten", level="program")
def fetch_overwritten(ctx):
    """Fetches of variables written more than once: the env's
    last-write-wins semantics silently return the FINAL value, which may
    not be the definition the fetch intended."""
    program = ctx.program
    block = program.global_block()
    writers = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            writers.setdefault(n, []).append((i, op.type))
    findings = []
    for n in ctx.fetch_names:
        ws = writers.get(n, [])
        if len(ws) <= 1:
            continue
        findings.append(ctx.finding(
            "program.fetch-overwritten", "warning", "program",
            f"fetch {n!r}",
            f"fetched var {n!r} is written {len(ws)} times (ops "
            f"{[f'{i}:{t}' for i, t in ws[:4]]}); the fetch returns the "
            f"LAST write",
            hint="fetch the intermediate under a distinct variable name "
                 "(assign it before the overwrite) if the earlier value "
                 "was intended"))
    return findings


def _infer_mismatch(block, op):
    """(message, hint) for one op when its declared output var
    contradicts what the op computes — conservative: only fires on
    statically-certain conflicts, never on -1 (batch) dims or
    broadcasting the op's axis rule could legalize."""
    def var(name):
        return block._find_var(name)

    def first(slot_map, slot):
        names = slot_map.get(slot) or ()
        return var(names[0]) if names else None

    x = first(op.inputs, "X")
    out = first(op.outputs, "Out")
    if x is None or out is None:
        return None
    if op.type in _ELEMENTWISE:
        y = first(op.inputs, "Y")
        if y is None:
            return None
        if y.dtype != x.dtype:
            return (f"operand dtypes differ: X {x.name!r} is "
                    f"{x.dtype.name}, Y {y.name!r} is {y.dtype.name}",
                    "insert an explicit cast — implicit promotion "
                    "doubles the wider operand's memory and hides "
                    "precision intent")
        if len(x.shape) == len(y.shape):
            for dx, dy in zip(x.shape, y.shape):
                if (int(dx) > 1 and int(dy) > 1
                        and int(dx) != int(dy)):
                    return (f"operand shapes conflict: X {x.name!r} "
                            f"{list(x.shape)} vs Y {y.name!r} "
                            f"{list(y.shape)} (dim {dx} != {dy}, "
                            f"neither broadcastable)",
                            "fix the producing layer's shape or reshape "
                            "one operand")
        if out.dtype != x.dtype:
            return (f"declared output dtype {out.dtype.name} != operand "
                    f"dtype {x.dtype.name}",
                    "declare the output with the operand dtype or cast "
                    "explicitly")
        return None
    if op.type == "mul":
        y = first(op.inputs, "Y")
        if y is None or not _static(x.shape) or not _static(y.shape):
            return None
        xn = int(op.attrs.get("x_num_col_dims", 1))
        yn = int(op.attrs.get("y_num_col_dims", 1))
        k_x = 1
        for s in x.shape[xn:]:
            k_x *= int(s)
        k_y = 1
        for s in y.shape[:yn]:
            k_y *= int(s)
        if k_x != k_y:
            return (f"matmul inner dims differ: X {x.name!r} "
                    f"{list(x.shape)} flattens to [*, {k_x}], Y "
                    f"{y.name!r} {list(y.shape)} to [{k_y}, *]",
                    "fix the weight shape or the num_col_dims attrs")
        if _static(out.shape):
            expect = tuple(int(s) for s in x.shape[:xn]) + tuple(
                int(s) for s in y.shape[yn:])
            if tuple(int(s) for s in out.shape) != expect:
                return (f"declared output shape {list(out.shape)} != "
                        f"inferred {list(expect)}",
                        "declare the output var with the inferred shape")
        return None
    if op.type == "cast":
        from ..core.dtypes import convert_dtype

        want = convert_dtype(op.attrs.get("out_dtype", "float32"))
        if out.dtype != want:
            return (f"declared output dtype {out.dtype.name} != cast "
                    f"target {want.name}",
                    "declare the output var with the out_dtype attr's "
                    "dtype")
        return None
    if op.type in _UNARY_PRESERVING:
        if out.dtype != x.dtype:
            return (f"declared output dtype {out.dtype.name} != input "
                    f"dtype {x.dtype.name} ({op.type} preserves dtype)",
                    "declare the output with the input dtype")
        if (len(x.shape) == len(out.shape)
                and _static(x.shape) and _static(out.shape)
                and tuple(x.shape) != tuple(out.shape)):
            return (f"declared output shape {list(out.shape)} != input "
                    f"shape {list(x.shape)} ({op.type} preserves shape)",
                    "declare the output with the input shape")
    return None


@register_check("program.shape-dtype", level="program")
def shape_dtype(ctx):
    """Declared shape/dtype consistency over a conservative op subset
    (elementwise family, flattening matmul, cast, shape-preserving
    unaries).  Only statically-certain conflicts fire — -1 dims and
    rank-changing broadcasts are skipped, so a finding here is a real
    bug, not a style note."""
    block = ctx.program.global_block()
    findings = []
    for i, op in enumerate(block.ops):
        m = _infer_mismatch(block, op)
        if m is None:
            continue
        if len(findings) >= MAX_FINDINGS:
            break
        msg, hint = m
        findings.append(ctx.finding(
            "program.shape-dtype", "error", "program",
            _op_loc(block, i, op), msg, hint=hint))
    return findings


@register_check("program.spec-conflict", level="program")
def spec_conflict(ctx):
    """Sharding specs that cannot hold on the declared shapes, flagged
    BEFORE any compile: an explicit ``partition_spec`` whose axis
    product does not divide the static dim it shards, or an
    ``fsdp_param`` tag whose tp x fsdp tuple-composition
    (``fsdp_spec_for``'s rule) is indivisible on the leading dim.  At
    compile time these fall back to replication (recorded by
    ``program.shard-fallback``); this check is the cheaper, earlier
    signal — a capacity config relying on the shard OOMs at startup
    otherwise.  Needs a mesh (``lint(mesh=...)``) — silent without
    one."""
    mesh = ctx.mesh
    if mesh is None:
        return []
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    from ..parallel.mesh import axis_size

    nf = axis_size(mesh, "fsdp")
    block = ctx.program.global_block()
    findings = []

    def axes_of(entry):
        return tuple(a for a in (
            entry if isinstance(entry, tuple) else (entry,))
            if a)

    for name in sorted(block.vars):
        var = block.vars[name]
        shape = tuple(var.shape or ())
        spec = list(getattr(var, "partition_spec", None) or ())
        for d, entry in enumerate(spec):
            if entry is None or d >= len(shape):
                continue
            axes = axes_of(entry)
            denom = 1
            for a in axes:
                denom *= mesh_sizes.get(a, 1)
            dim = int(shape[d]) if shape[d] else 0
            if denom > 1 and dim > 0 and dim % denom:
                findings.append(ctx.finding(
                    "program.spec-conflict", "warning", "program",
                    f"var {name}",
                    f"dim {d} ({dim}) of {name!r} is annotated "
                    f"P over {'x'.join(axes)}={denom} but is not "
                    f"divisible — the spec cannot hold and will "
                    f"fall back to replication at compile",
                    hint="pad the dim to a multiple of the sharding "
                         "axes' product, or drop an axis from the "
                         "composition",
                    data={"var": name, "dim": d, "size": dim,
                          "axes": list(axes), "product": denom}))
        if nf > 1 and getattr(var, "fsdp_param", False) and shape \
                and "fsdp" not in {a for e in spec for a in axes_of(e)}:
            lead = axes_of(spec[0]) if spec else ()
            if "dp" in lead:
                continue  # fsdp_spec_for declines these with a reason
            denom = nf
            for a in lead:
                denom *= mesh_sizes.get(a, 1)
            dim = abs(int(shape[0])) if shape[0] else 0
            if dim and dim % denom:
                findings.append(ctx.finding(
                    "program.spec-conflict", "warning", "program",
                    f"var {name}",
                    f"fsdp composition on {name!r} needs leading dim "
                    f"{dim} divisible by "
                    f"{'x'.join([*lead, 'fsdp'])}={denom} — the "
                    f"tp/fsdp tuple spec cannot hold and the weight "
                    f"will stay {'tp-sharded only' if lead else 'replicated'}",
                    hint="choose an fsdp degree dividing the weight's "
                         "leading dim (or accept the recorded "
                         "replication fallback)",
                    data={"var": name, "size": dim,
                          "axes": [*lead, "fsdp"], "product": denom}))
        if len(findings) >= MAX_FINDINGS:
            break
    return findings


@register_check("program.shard-fallback", level="program")
def shard_fallback(ctx):
    """Sharding fallbacks recorded at spec-resolution time
    (``parallel.api._record_shard_fallback``): a var that COULD have
    sharded over dp (ZeRO-1 accumulators) or fsdp (per-layer weights)
    but replicated instead — indivisible leading dims, rank mismatches.
    Info-level: replication is always correct, but at a capacity config
    it silently forfeits the bytes/device the shard exists to save, so
    each fallback is named here (and counted in
    ``parallel.shard_fallbacks``) instead of vanishing."""
    recs = getattr(ctx.program.global_block(), "_shard_fallbacks",
                   None) or {}
    findings = []
    for (name, axis), reason in sorted(recs.items()):
        if len(findings) >= MAX_FINDINGS:
            break
        findings.append(ctx.finding(
            "program.shard-fallback", "info", "program", f"var {name}",
            f"{axis} shard fell back to replication: {reason}",
            hint="pad/resize the dim to divide the mesh axis (or accept "
                 "the replicated bytes); sharding_report shows the "
                 "per-device cost",
            data={"var": name, "axis": axis, "reason": reason}))
    return findings
