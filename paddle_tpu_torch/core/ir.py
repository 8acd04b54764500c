"""Program transformations: pruning / inference conversion / structural
segment matching (the port's copy of ``paddle_tpu/core/ir.py``; pure
Python, so both packages prune and match the same programs alike).

Reference: ``paddle/framework/prune.{h,cc}`` + ``pybind.cc:289 m.def("prune")``
and ``inference_optimize`` (pybind.cc:299).  Used by save_inference_model to
slice a training program down to the feed->fetch subgraph.

The structural-matching half (``match_op_run`` / ``detect_repeated_run`` /
``find_uniform_groups``) serves the scan-based remat engine: a Program is an
unrolled op list, but a transformer's N blocks are N structurally identical
op runs differing only in variable names.  Matching recovers that repetition
so the reference's Executor can run the repeats as ONE ``lax.scan`` body
with weights stacked along the scan axis.  In the port,
``memory_optimize(policy="full")`` cuts its segments at the boundaries
``detect_repeated_run`` finds (one transformer block each); PyTorch runs
eagerly, so the segments run one after another under
``torch.utils.checkpoint`` and no scan is needed.
"""

import copy


def sub_block_names(program, block_idx, seen=None):
    """``(reads, writes)`` of every op anywhere under a sub-block,
    recursing into nested control-flow ops (while containing scan_block,
    etc.).  The single traversal the pruner and the static-analysis
    engine's program-level checks both rely on — one definition of "what
    a control-flow op touches"."""
    seen = set() if seen is None else seen
    if block_idx in seen:
        return set(), set()
    seen.add(block_idx)
    reads, writes = set(), set()
    for op in program.block(block_idx).ops:
        reads |= set(op.input_names())
        writes |= set(op.output_names())
        nested = op.attrs.get("sub_block")
        if nested is not None:
            r, w = sub_block_names(program, nested, seen)
            reads |= r
            writes |= w
    return reads, writes


def prune_program(program, targets):
    """Return a deep-copied program whose global block keeps only ops needed
    (transitively) to compute ``targets`` (Variables or names)."""
    target_names = {t.name if hasattr(t, "name") else str(t) for t in targets}
    pruned = copy.deepcopy(program)
    block = pruned.global_block()

    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        produced = set(op.output_names())
        if produced & needed:
            kept.append(op)
            needed |= set(op.input_names())
            # control-flow ops pull in their (possibly nested) sub-block reads
            sub_idx = op.attrs.get("sub_block")
            if sub_idx is not None:
                needed |= sub_block_names(pruned, sub_idx)[0]
    kept.reverse()
    block.ops = kept
    block.backward_index = None
    pruned._backward_info = {}

    referenced = set(needed) | target_names
    for blk in pruned.blocks:
        for op in blk.ops:
            referenced |= set(op.input_names()) | set(op.output_names())
    block.vars = type(block.vars)(
        (n, v) for n, v in block.vars.items() if n in referenced
    )
    return pruned


# ---------------------------------------------------------------------------
# Structural matching of repeated op runs (the scan-remat front end)
# ---------------------------------------------------------------------------

def _op_impl_or_none(op_type):
    """The port's own registry entry for ``op_type``, or None."""
    from .registry import get_op_impl

    try:
        return get_op_impl(op_type)
    except KeyError:
        return None


def match_op_run(program, ops_a, ops_b):
    """Structural match of two op runs within one block.

    Returns ``(ext_map, out_map)`` when ``ops_b`` is the same op sequence as
    ``ops_a`` under a consistent variable renaming, else ``None``:

    - ``ext_map``: names read-before-written in A -> the corresponding name
      in B (the run's external inputs: carried activations, per-layer
      parameters, shared constants);
    - ``out_map``: names written by A -> the final corresponding written
      name in B (assignment semantics: last write wins, like the env).

    Bails (``None``) on raw/control-flow ops (sub-blocks are whole-program
    machinery, not repeatable straight-line structure), attr mismatches, or
    static shape/dtype mismatches of paired external inputs (stacking along
    a scan axis needs uniform operands).
    """
    if len(ops_a) != len(ops_b):
        return None
    block = program.global_block()
    ext, ext_rev, cur = {}, {}, {}

    def pair_input(na, nb):
        if na in cur:
            return cur[na] == nb
        if na in ext:
            return ext[na] == nb
        if nb in ext_rev:
            return False  # two canonical inputs collapsing onto one name
        va, vb = block._find_var(na), block._find_var(nb)
        if va is not None and vb is not None:
            if tuple(va.shape) != tuple(vb.shape) or va.dtype != vb.dtype:
                return False
        ext[na] = nb
        ext_rev[nb] = na
        return True

    for oa, ob in zip(ops_a, ops_b):
        if oa.type != ob.type:
            return None
        impl = _op_impl_or_none(oa.type)
        # raw (block-structured control flow) ops: none is ported yet
        if impl is None or getattr(impl, "raw", False):
            return None
        if "sub_block" in oa.attrs or "sub_block" in ob.attrs:
            return None
        if oa.attrs != ob.attrs:
            return None
        if set(oa.inputs) != set(ob.inputs) or set(oa.outputs) != set(ob.outputs):
            return None
        for slot in oa.inputs:
            nas, nbs = oa.inputs[slot], ob.inputs[slot]
            if len(nas) != len(nbs):
                return None
            for na, nb in zip(nas, nbs):
                if not pair_input(na, nb):
                    return None
        for slot in oa.outputs:
            nas, nbs = oa.outputs[slot], ob.outputs[slot]
            if len(nas) != len(nbs):
                return None
            for na, nb in zip(nas, nbs):
                cur[na] = nb
    return ext, cur


def detect_repeated_run(program, start, end, min_period=2, max_prologue=96):
    """Find the dominant periodic tiling of ``block.ops[start:end]``.

    Returns ``(s0, period, count)`` — ``count`` structurally identical
    (``match_op_run``) runs of ``period`` ops beginning at op ``s0`` — or
    ``None`` when nothing repeats at least twice.  Maximizes covered ops
    (``period * count``); the op-TYPE sequence prefilters candidates so the
    expensive structural check only runs on plausible periods.
    """
    ops = program.global_block().ops[start:end]
    n = len(ops)
    types = [op.type for op in ops]
    best = None  # (coverage, s0, period, count)
    # work budget: the (offset x period) scan is O(n^2) slice compares on
    # a repetition-free program — cap total compared elements so a huge
    # irregular net falls through to the caller's sqrt-N path in bounded
    # time instead of stalling memory_optimize for seconds
    budget = 2_000_000
    for off in range(0, min(max_prologue, n)):
        limit = (n - off) // 2
        p = min_period
        while p <= limit and budget > 0:
            budget -= p
            if types[off:off + p] == types[off + p:off + 2 * p]:
                base = ops[off:off + p]
                count = 1
                while off + (count + 1) * p <= n:
                    m = match_op_run(
                        program, base,
                        ops[off + count * p:off + (count + 1) * p])
                    if m is None:
                        break
                    count += 1
                if count >= 2:
                    coverage = p * count
                    if best is None or coverage > best[0]:
                        best = (coverage, start + off, p, count)
                    # a longer period at the same offset cannot beat
                    # full-coverage; keep scanning only if partial
                    if coverage >= n - off:
                        break
            p += 1
        if best is not None and best[0] >= n - off:
            break
        if budget <= 0:
            break
    if best is None:
        return None
    return best[1], best[2], best[3]


def find_uniform_groups(program, segments, min_repeat=2, max_period=24):
    """Group consecutive remat segments into scan-able uniform runs.

    ``segments`` is the transpiler's ``[(start, end, wrapped), ...]`` tiling
    of the forward prefix.  A group is ``segments[i : i + count*period]``
    where each period of ``period`` consecutive segments structurally
    repeats the first (same op structure via ``match_op_run``, same wrap
    flags) — e.g. one transformer layer under the selective policy is a
    ``[wrapped cheap-run, unwrapped kernel, ...]`` period.

    Returns a list of dicts ``{"start", "period", "count", "ext_maps",
    "out_maps"}`` (maps indexed by repeat k; k=0 is the identity over the
    canonical names).  Groups are disjoint, greedy left-to-right.
    """
    block = program.global_block()
    groups = []
    nseg = len(segments)
    i = 0
    while i < nseg:
        best = None  # (coverage_segments, period, count, ext_maps, out_maps)
        for p in range(1, min(max_period, (nseg - i) // 2) + 1):
            # wrap-flag pattern must repeat before paying for matching
            flags0 = [bool(s[2]) if len(s) > 2 else True
                      for s in segments[i:i + p]]
            base_ops = [op for (s, t, *_) in segments[i:i + p]
                        for op in block.ops[s:t]]
            if not base_ops:
                continue
            # identity maps for k=0
            m0 = match_op_run(program, base_ops, base_ops)
            if m0 is None:
                continue
            ext_maps, out_maps = [m0[0]], [m0[1]]
            count = 1
            while i + (count + 1) * p <= nseg:
                nxt = segments[i + count * p:i + (count + 1) * p]
                flags = [bool(s[2]) if len(s) > 2 else True for s in nxt]
                if flags != flags0:
                    break
                nxt_ops = [op for (s, t, *_) in nxt
                           for op in block.ops[s:t]]
                m = match_op_run(program, base_ops, nxt_ops)
                if m is None:
                    break
                ext_maps.append(m[0])
                out_maps.append(m[1])
                count += 1
            if count >= min_repeat:
                coverage = p * count
                if best is None or coverage > best[0]:
                    best = (coverage, p, count, ext_maps, out_maps)
        if best is not None:
            _, p, count, ext_maps, out_maps = best
            groups.append({"start": i, "period": p, "count": count,
                           "ext_maps": ext_maps, "out_maps": out_maps})
            i += p * count
        else:
            i += 1
    return groups
