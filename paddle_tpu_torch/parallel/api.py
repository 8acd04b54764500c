"""Sharding annotations for programs (``paddle_tpu/parallel/api.py``).

The reference keeps ONE program and annotates its variables with
PartitionSpecs; GSPMD partitions the jitted step.  The port keeps the
same annotations and the same rules, spec for spec — ``data_parallel``,
``shard_parameter``, ``shard_fsdp``, ``zero_spec_for``,
``fsdp_spec_for``, ``grad_rs_spec_for`` and their recorded fallbacks —
and its Executor (``core/executor.py``, mesh path) turns the resolved
spec of each variable into what one rank holds: a persistable whose spec
names a mesh axis rests as this rank's block of that dim, a feed is cut
to this rank's rows, and the collectives the step needs are the
Executor's own calls (``parallel/collectives.py``), each recorded in the
step's collective log.

ZeRO-1 optimizer-state sharding rides the same mechanism: optimizer
accumulators (tagged ``zero_param`` by ``Optimizer._add_accumulator``)
resolve to a spec sharding their leading axis over ``dp``, so each rank
keeps its rows of the moments, updates its rows of the parameter, and
all-gathers the updated parameter.  FSDP / ZeRO-3 extends it to the
parameters: ``shard_fsdp`` tags each layer group's per-layer weights (and
the 2-D prologue/epilogue matrices with ``fsdp_axes``), ``fsdp_spec_for``
composes an ``fsdp`` shard onto their leading axis, and the Executor
gathers each weight where a layer reads it, in the forward and again in
the backward.  Every replication fallback (indivisible shapes) is
recorded on the block and counted in ``parallel.shard_fallbacks`` —
never silently.

The kill switches are the reference's: ``PADDLE_TPU_ZERO``,
``PADDLE_TPU_FSDP``, ``PADDLE_TPU_ZERO3_RS`` and
``PADDLE_TPU_COMM_OVERLAP`` (``0`` turns each off).
"""

import os
import re

import numpy as np

from .mesh import axis_size

__all__ = ["compile_shardings", "data_parallel", "shard_parameter",
           "shard_parameters_by_rule", "shard_activation", "replicate", "P",
           "zero_spec_for", "fsdp_spec_for", "grad_rs_spec_for",
           "shard_fsdp", "optimizer_state_report", "sharding_report",
           "scan_groups", "spec_axes", "comm_overlap_flags",
           "enable_comm_overlap"]


class P(tuple):
    """A PartitionSpec: one entry per dim — a mesh axis name, a tuple of
    names (major first), or None.  Equal, entry for entry, to the
    reference's ``jax.sharding.PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


def scan_groups(program, segments):
    """The uniform (scan-able) layer groups among ``segments``: the
    reference's ``_scan_groups_for`` — only groups whose period holds a
    wrapped segment qualify, and ``PADDLE_TPU_SCAN_REMAT=0`` turns the
    engine off (no group)."""
    if os.environ.get("PADDLE_TPU_SCAN_REMAT", "1").lower() in (
            "0", "", "false"):
        return []
    from ..core.ir import find_uniform_groups

    groups = []
    for g in find_uniform_groups(program, segments):
        period = segments[g["start"]:g["start"] + g["period"]]
        if any((s[2] if len(s) > 2 else True) for s in period):
            groups.append(g)
    return groups


def spec_axes(spec):
    """Every mesh axis a PartitionSpec mentions."""
    return _spec_axes(spec or ())


def _zero_enabled():
    """ZeRO-1 accumulator sharding kill switch (``PADDLE_TPU_ZERO=0``):
    with it off every accumulator is replicated exactly as before the
    scaling engine existed — the bit-exactness reference spelling."""
    return os.environ.get("PADDLE_TPU_ZERO", "1").lower() not in (
        "0", "", "false")


def _fsdp_enabled():
    """FSDP parameter-sharding kill switch (``PADDLE_TPU_FSDP=0``): off
    means every parameter keeps its explicit (tp) spec or replicates —
    the bit-exactness reference spelling, exactly like PADDLE_TPU_ZERO."""
    return os.environ.get("PADDLE_TPU_FSDP", "1").lower() not in (
        "0", "", "false")


def _zero3_rs_enabled():
    """ZeRO-3 reduce-scatter gradient kill switch
    (``PADDLE_TPU_ZERO3_RS=0``): off restores the replicated-gradient
    boundary spelling (every fsdp-tagged gradient pinned to its
    parameter's EXPLICIT spec, cross-chip all-reduced at full volume,
    sliced shard-locally by the update math) — the bit-exactness
    reference spelling, exactly like PADDLE_TPU_ZERO /
    PADDLE_TPU_FSDP."""
    return os.environ.get("PADDLE_TPU_ZERO3_RS", "1").lower() not in (
        "0", "", "false")


def _spec_axes(spec):
    """Every mesh axis a PartitionSpec entry list mentions."""
    return {a for e in spec if e
            for a in (e if isinstance(e, tuple) else (e,))}


def _record_shard_fallback(block, var, axis, reason):
    """A var that COULD have sharded over ``axis`` but fell back to its
    inherited spec / replication: recorded once per (var, axis) on the
    block (the ``program.shard-fallback`` analysis check reads it) and
    counted in ``parallel.shard_fallbacks`` — a silent fallback at a
    capacity config is an OOM waiting to happen (the scan-remat
    fallback discipline)."""
    if block is None:
        return
    rec = getattr(block, "_shard_fallbacks", None)
    if rec is None:
        rec = block._shard_fallbacks = {}
    key = (var if isinstance(var, str) else var.name, axis)
    if key in rec:
        return
    rec[key] = reason
    from ..observability import metrics as _obs

    _obs.get_registry().counter(
        "parallel.shard_fallbacks",
        help="vars whose dp/fsdp shard fell back to replication "
             "(indivisible shapes; program.shard-fallback names them)",
    ).inc()


def fsdp_spec_for(var, mesh, block=None):
    """The FSDP/ZeRO-3 PartitionSpec for one tagged parameter, or None.

    Rules (docs/parallel.md):
    * only vars ``shard_fsdp`` tagged (``fsdp_param`` — a scan-group's
      per-layer stacked weights) are candidates, and only on a mesh
      with an ``fsdp`` axis of size > 1;
    * the parameter keeps its existing (tensor-parallel) spec and the
      LEADING non-scan axis additionally shards over ``fsdp`` —
      composing into a tuple entry when tp already shards that axis —
      iff the dim divides the product of all axes sharding it;
    * indivisible shapes fall back to the inherited spec (None here —
      callers then use ``partition_spec`` as before) with the reason
      recorded via ``_record_shard_fallback``;
    * a var tagged with ``fsdp_axes`` (the ``shard_fsdp`` prologue/
      epilogue tagging: embeddings and the LM head) composes EVERY
      listed free mesh axis onto the leading dim — the SpecLayout
      ``P(('fsdp', 'tp'), None)`` spelling, so the two largest single
      tensors shard over the full fsdp x tp extent and gather ONCE per
      step outside the scan.  When the full composition does not
      divide, the plain ``fsdp`` shard is retried before falling back
      to replication;
    * kill switches: ``PADDLE_TPU_FSDP=0`` and the program-level
      ``program._fsdp = False`` (the autotuner's replicate schedule,
      ``memory_optimize(policy="auto")``) both resolve every candidate
      to None — the replicated reference spelling, checked bit-exact.
      The program opt-out rides the BLOCK's program so the Executor's
      scan-body gathers and compile_shardings flip together: a
      replicate winner must measure the true replicated schedule, not
      a sharded-at-rest hybrid with no pin discipline.
    """
    if not _fsdp_enabled():
        return None
    if block is not None and getattr(
            getattr(block, "program", None), "_fsdp", True) is False:
        return None
    nf = axis_size(mesh, "fsdp")
    if nf <= 1 or not getattr(var, "fsdp_param", False):
        return None
    shape = tuple(var.shape or ())
    if not shape:
        _record_shard_fallback(block, var, "fsdp", "scalar shape")
        return None
    base = list(getattr(var, "partition_spec", None) or ())
    if len(base) > len(shape):
        _record_shard_fallback(
            block, var, "fsdp",
            f"spec rank {len(base)} exceeds shape rank {len(shape)}")
        return None
    base += [None] * (len(shape) - len(base))
    if "fsdp" in _spec_axes(base):
        return P(*base)  # already explicitly fsdp-sharded
    entry = base[0]
    cur = (entry if isinstance(entry, tuple) else (entry,)) if entry \
        else ()
    if "dp" in cur:
        _record_shard_fallback(
            block, var, "fsdp", "leading axis already sharded over dp")
        return None
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    used = _spec_axes(base)
    # the composed-axes tagging (fsdp_axes, e.g. ("fsdp", "tp") for the
    # shard_fsdp-tagged embedding/LM head): every listed axis that
    # exists on the mesh with size > 1 and is FREE in the explicit spec
    # joins the leading-dim shard, largest composition first
    want = tuple(getattr(var, "fsdp_axes", None) or ("fsdp",))
    extra = tuple(a for a in want
                  if a != "fsdp" and mesh_sizes.get(a, 0) > 1
                  and a not in used and a not in cur)
    dim = abs(int(shape[0])) if shape[0] else 0
    for add in ((("fsdp",) + extra) if extra else (("fsdp",)),
                ("fsdp",)):
        denom = 1
        for a in (*cur, *add):
            denom *= mesh_sizes.get(a, 1)
        if dim and dim % denom == 0:
            base[0] = (*cur, *add) if (cur or len(add) > 1) else add[0]
            return P(*base)
    denom = nf
    for a in cur:
        denom *= mesh_sizes.get(a, 1)
    _record_shard_fallback(
        block, var, "fsdp",
        f"leading dim {shape[0]} not divisible by "
        f"{'x'.join([*cur, 'fsdp'])}={denom}")
    return None


def zero_spec_for(var, mesh, block=None):
    """The ZeRO-1 PartitionSpec for one optimizer accumulator, or None.

    Rules (docs/parallel.md):
    * only vars tagged ``zero_param`` (per-parameter accumulators) are
      candidates — beta-pow/learning-rate scalars never shard;
    * an explicit ``partition_spec`` always wins (callers check first);
    * the accumulator inherits its parameter's RESOLVED PartitionSpec —
      the fsdp-composed spec when the parameter is FSDP-sharded, else
      its explicit (tp) spec — so a tensor-parallel ``[d, 4d]`` FFN
      weight's moments stay tp-sharded next to it and an FSDP weight's
      moments shard along with it (the ZeRO-3 state discipline); then
      its LEADING axis is sharded over ``dp`` iff that axis is free,
      the dim divides the dp size, and no other axis already uses
      ``dp``;
    * uneven/small shapes (leading dim not divisible — scalars, odd
      embeddings) fall back to the inherited spec, or full replication,
      with the skipped dp shard recorded via ``_record_shard_fallback``
      (the ``program.shard-fallback`` check surfaces it).
    """
    if not _zero_enabled():
        return None
    if mesh is None:
        return None
    ndp = axis_size(mesh, "dp")
    nf = axis_size(mesh, "fsdp")
    pname = getattr(var, "zero_param", None)
    if pname is None or (ndp <= 1 and nf <= 1):
        return None
    shape = tuple(var.shape or ())
    if not shape:
        return None
    base = [None] * len(shape)
    if block is not None:
        pvar = block._find_var(pname)
        pspec = None
        if pvar is not None:
            pspec = fsdp_spec_for(pvar, mesh, block)
            if pspec is None:
                pspec = getattr(pvar, "partition_spec", None)
        if pspec is not None:
            if len(pspec) > len(shape):
                _record_shard_fallback(
                    block, var, "dp",
                    f"parameter spec rank {len(pspec)} exceeds "
                    f"accumulator rank {len(shape)}")
                return None  # shape mismatch: stay replicated
            base[:len(pspec)] = list(pspec)
    used = _spec_axes(base)
    if ndp > 1 and base[0] is None and "dp" not in used and shape[0]:
        if int(shape[0]) % ndp == 0:
            base[0] = "dp"
        else:
            _record_shard_fallback(
                block, var, "dp",
                f"leading dim {shape[0]} not divisible by dp={ndp}")
    if all(e is None for e in base):
        return None
    return P(*base)


def grad_rs_spec_for(var, mesh, block=None):
    """The reduce-scatter boundary spec for one parameter's GRADIENT,
    or None ("reduce-scatter at the boundary, never in-loop").

    The true-ZeRO-3 gradient: an fsdp-tagged parameter's gradient is
    aggregated over dp at the optimizer boundary at the parameter's
    fsdp-composed spec, so each rank receives only its block (the mesh
    path reduces the block over dp and logs it as the reference's
    reduce-scatter over dp and fsdp).  Resolves to None (the
    replicated-gradient spelling) when ``PADDLE_TPU_ZERO3_RS=0``; when
    the mesh has no dp axis of size > 1 (every fsdp rank computes the
    whole gradient of the same rows: there is nothing to reduce); or
    when the parameter is not fsdp-tagged or its shape fell back
    (``fsdp_spec_for`` returns None).  ``zero3_grad_contract``
    (``parallel/contracts.py``) holds the resulting comm shape."""
    if var is None or mesh is None or not _zero3_rs_enabled():
        return None
    if axis_size(mesh, "dp") <= 1:
        return None
    return fsdp_spec_for(var, mesh, block)


def _spec_for(var, mesh, block=None):
    # the fsdp composition subsumes (extends) an explicit tp spec, so it
    # resolves first; a fallback (None) restores the explicit-spec path
    spec = fsdp_spec_for(var, mesh, block)
    if spec is not None:
        return spec
    spec = getattr(var, "partition_spec", None)
    if spec is not None:
        return spec
    spec = zero_spec_for(var, mesh, block)
    if spec is not None:
        return spec
    return P()


def compile_shardings(mesh, program, names):
    """``{name: PartitionSpec}`` for ``names`` of ``program`` under
    ``mesh`` — the reference's ``compile_shardings`` (which builds the
    jit's in/out ``NamedSharding`` trees) without jit: the Executor reads
    each persistable's spec to keep it sharded at rest, and each feed's to
    take this rank's slice of it.  Names the program does not declare
    (``@RNG@``, ``@GRAD_NORM@``) replicate."""
    block = program.global_block()
    out = {}
    for n in names:
        var = block._find_var(n)
        out[n] = _spec_for(var, mesh, block) if var is not None else P()
    return out


def data_parallel(program, mesh_axis="dp", programs=()):
    """Mark every data variable's batch axis as sharded over ``mesh_axis``.

    This single annotation replaces: minibatch scatter
    (MultiGradientMachine TrainerThread / SplitLoDTensorAndMoveTensorToScopes),
    ring gradient aggregation (MultiGradientMachine.h:52-79) and NCCL
    all-reduce ops — the gradient all-reduce materializes automatically in
    the compiled backward because params stay replicated while batches are
    sharded."""
    for prog in (program, *programs):
        for var in prog.global_block().vars.values():
            if var.is_data:
                nd = max(len(var.shape), 1)
                var.partition_spec = P(mesh_axis, *([None] * (nd - 1)))
    return program


def shard_parameter(var, spec):
    """Tensor-parallel annotation for one parameter, e.g.
    shard_parameter(w, P(None, 'tp')) column-shards an [in, out] matrix.
    The mesh path keeps each rank's block and runs the ops that read it
    by their tp rules (``spmd.py``) — the per-layer-device model
    parallelism of ParallelNeuralNetwork.cpp without its pipeline
    threads."""
    var.partition_spec = spec
    return var


def shard_parameters_by_rule(program, rules):
    """rules: list of (name_regex, PartitionSpec) applied in order."""
    for var in program.global_block().vars.values():
        if not var.persistable:
            continue
        for pattern, spec in rules:
            if re.search(pattern, var.name):
                var.partition_spec = spec
                break
    return program


def shard_fsdp(program, programs=()):
    """Tag each scan-group's per-layer (scan-stacked) parameters for
    FSDP sharding (``var.fsdp_param = True``; ``fsdp_spec_for`` resolves
    the tags at compile time, so ``PADDLE_TPU_FSDP=0`` still restores
    the replicated spelling afterwards).

    The tagged set is the reference's: when ``memory_optimize`` has
    marked ``program._remat_segments`` (call it FIRST), the groups come
    from :func:`scan_groups` (the reference's ``_scan_groups_for``, with
    its wrapped-segment filter and the ``PADDLE_TPU_SCAN_REMAT=0`` kill
    switch) — the layer loops of the step, where the mesh path's gathers
    count as in-loop.  Without marked segments the structural matcher
    falls back to a ``detect_repeated_run`` tiling of the forward prefix:
    at-rest sharding, the gathers outside any loop.
    In either case every external input that maps to a DIFFERENT
    Parameter per period is a per-layer weight.  Shared inputs
    (constants used identically every layer) and carried activations
    are left untouched.

    The non-repeated PROLOGUE/EPILOGUE matrices — the embedding tables
    and the LM head, the two largest single tensors in the model — are
    additionally tagged with ``fsdp_axes=('fsdp', 'tp')``:
    ``fsdp_spec_for`` composes every free listed axis onto their
    leading dim (the SpecLayout ``P(('fsdp', 'tp'), None)`` spelling),
    so they rest sharded over the full fsdp x tp extent, their moments
    inherit the composed spec through ``zero_spec_for``, and their
    gathers live OUTSIDE the scan — one gather per step, overlappable
    via PADDLE_TPU_COMM_OVERLAP.  Only 2-D Parameters consumed outside
    every scan group qualify; indivisible shapes fall back to
    replication with the reason recorded (``parallel.shard_fallbacks``
    + the ``program.shard-fallback`` finding), and ``replicate(var)``
    opts a var back out.

    ``programs`` (e.g. the startup program) receive the same tags by
    variable name so their out-shardings create the parameters
    pre-sharded.  Returns the sorted tagged names; an EMPTY return
    (no repeated structure / scan engine off) records a
    program-level ``_record_shard_fallback`` so the no-op is
    observable, never silent."""
    from ..core.ir import detect_repeated_run, find_uniform_groups
    from ..core.program import Parameter

    block = program.global_block()

    def _fallback_empty(reason):
        _record_shard_fallback(block, "<program>", "fsdp", reason)
        return []

    segments = list(getattr(program, "_remat_segments", None) or ())
    if segments:
        groups = scan_groups(program, segments)
        if not groups:
            return _fallback_empty(
                "no scan-able uniform segment group (or "
                "PADDLE_TPU_SCAN_REMAT=0) — parameters stay replicated")
    else:
        bw = block.backward_index
        n_fwd = bw if bw is not None else len(block.ops)
        hit = detect_repeated_run(program, 0, n_fwd)
        if hit is None:
            return _fallback_empty(
                "no repeated layer structure found — parameters stay "
                "replicated")
        s0, p, cnt = hit
        segs = [(s0 + k * p, s0 + (k + 1) * p, True)
                for k in range(cnt)]
        groups = find_uniform_groups(program, segs)
    names = set()
    for g in groups:
        ext_maps, count = g["ext_maps"], g["count"]
        for n in ext_maps[0]:
            vals = [ext_maps[k][n] for k in range(count)]
            if len(set(vals)) <= 1:
                continue  # shared input (or single period)
            vars_ = [block._find_var(v) for v in vals]
            if all(v is not None and isinstance(v, Parameter)
                   for v in vars_):
                names.update(vals)
    if not names:
        return _fallback_empty(
            "repeated structure has no per-layer Parameters — "
            "parameters stay replicated")
    # prologue/epilogue: every 2-D Parameter outside the scan groups
    # (embedding tables, the LM head) shards its leading dim over the
    # composed ('fsdp', 'tp') extent — consumed outside the scan body,
    # so the gather lands outside the loop, once per step
    prologue = set()
    for var in block.vars.values():
        if (isinstance(var, Parameter) and var.name not in names
                and len(var.shape or ()) == 2
                and getattr(var, "fsdp_param", None) is not False):
            prologue.add(var.name)
    for prog in (program, *programs):
        blk = prog.global_block()
        for n in names | prologue:
            v = blk._find_var(n)
            if v is not None:
                v.fsdp_param = True
                if n in prologue:
                    v.fsdp_axes = ("fsdp", "tp")
        # the gather-vs-replicate schedule decision
        # (memory_optimize(policy="auto") -> program._fsdp) must
        # resolve identically for every program touching these vars —
        # a startup that creates them sharded while the opted-out main
        # expects them replicated is a compile-time sharding mismatch
        if hasattr(program, "_fsdp"):
            prog._fsdp = program._fsdp
    return sorted(names | prologue)


def shard_activation(var, spec):
    """Annotate a non-persistable INTERMEDIATE with a PartitionSpec —
    e.g. sequence-sharding a long activation (the reference pins the
    produced value to ``spec``).  The port records the annotation only:
    its mesh path places activations by the tp rules, and sequence
    parallelism is not ported (``ROADMAP.md`` A7).  Parameters take
    ``shard_parameter``; data feeds take ``data_parallel``."""
    if getattr(var, "persistable", False) or getattr(var, "is_data",
                                                     False):
        raise ValueError(
            f"shard_activation({var.name!r}): var is a "
            f"{'persistable' if var.persistable else 'data feed'} — "
            f"use shard_parameter / data_parallel for those")
    var.partition_spec = spec
    return var


def replicate(var):
    var.partition_spec = P()
    var.fsdp_param = False  # opt this var out of shard_fsdp tags too
    return var


def optimizer_state_report(program, mesh):
    """Static accounting of optimizer-state memory under the resolved
    shardings — the figure ZeRO-1 exists to shrink.  Walks every
    optimizer-owned persistable (``optimizer_state`` tag: accumulators,
    beta-pows, the lr var) and returns::

        {"total_bytes":               sum of full (logical) state bytes,
         "per_device_bytes":          sum of each var's shard bytes,
         "replicated_per_device_bytes": total_bytes (the ZeRO-off figure),
         "sharded_vars": n, "replicated_vars": n,
         "vars": {name: {"bytes", "per_device_bytes", "spec"}}}

    Pure metadata — no arrays are touched, so it also works pre-startup
    and is what ``benchmarks/multichip.py`` and the multichip selftest
    gate (``per_device_bytes <= replicated/4`` on the dp=8 mesh).
    ``sharding_report`` is the generalization covering parameter and
    gradient bytes too."""
    return sharding_report(program, mesh)["opt_state"]


def _var_shard_bytes(var, mesh, mesh_sizes, block, spec=None):
    """(full_bytes, per_device_bytes, spec) for one var under its
    resolved PartitionSpec (or an explicit ``spec`` override) — the
    shared accounting of ``sharding_report`` /
    ``optimizer_state_report``."""
    shape = tuple(abs(int(s)) for s in (var.shape or ()))
    numel = int(np.prod(shape)) if shape else 1
    try:
        from ..core.dtypes import torch_dtype

        itemsize = torch_dtype(var.dtype).itemsize
    except (TypeError, KeyError, ValueError):
        itemsize = 4
    nbytes = numel * itemsize
    if spec is None:
        spec = _spec_for(var, mesh, block)
    frac = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple)
                   else (entry,) if entry else ()):
            frac *= mesh_sizes.get(ax, 1)
    return nbytes, nbytes // max(frac, 1), spec


def sharding_report(program, mesh):
    """Static bytes/device accounting under the resolved shardings for
    the THREE per-parameter state classes the memory ceiling is made of:

    * ``params``    — the model weights (FSDP is what shrinks these);
    * ``opt_state`` — optimizer-owned persistables (``optimizer_state``
      tag: accumulators, beta-pows, lr — ZeRO-1/3 territory);
    * ``grads``     — one transient gradient per parameter, accounted at
      the spec the Executor actually pins each gradient to at the
      backward/optimizer boundary.  Under the default reduce-scatter
      spelling (``PADDLE_TPU_ZERO3_RS=1``) an fsdp-tagged parameter's
      gradient resolves through ``grad_rs_spec_for`` to the composed
      fsdp spec — each chip holds only its shard after the boundary
      reduce-scatter; with the kill switch off (or on a shard
      fallback) it is the parameter's EXPLICIT spec, i.e. replicated
      over ``fsdp``.

    Each section carries ``total_bytes`` (the logical, fully-replicated
    figure), ``per_device_bytes`` under the resolved specs,
    ``replicated_per_device_bytes`` (== total: the kill-switch figure),
    ``sharded_vars`` / ``replicated_vars`` counts and a per-var
    ``vars`` dict.  Pure metadata — works pre-startup; gated by the
    multichip selftest (param bytes/device <= replicated/2 on the
    fsdp=4 mesh) and ``benchmarks/multichip.py``."""
    from ..core.program import Parameter

    block = program.global_block()
    mesh_sizes = (dict(zip(mesh.axis_names, mesh.devices.shape))
                  if mesh is not None else {})

    def section():
        return {"total_bytes": 0, "per_device_bytes": 0,
                "sharded_vars": 0, "replicated_vars": 0, "vars": {}}

    out = {"params": section(), "opt_state": section(),
           "grads": section()}
    for var in block.vars.values():
        sections = []
        if isinstance(var, Parameter):
            sections += ["params", "grads"]
        if getattr(var, "optimizer_state", False):
            sections.append("opt_state")
        if not sections:
            continue
        resolved = _var_shard_bytes(var, mesh, mesh_sizes, block)
        for s in sections:
            if s == "grads":
                # the boundary pin's spec: the composed reduce-scatter
                # resolution when ZERO3_RS is on, else explicit (tp)
                # only — mirrors the Executor's pin exactly
                rs = grad_rs_spec_for(var, mesh, block)
                nbytes, per_dev, spec = _var_shard_bytes(
                    var, mesh, mesh_sizes, block,
                    spec=(rs if rs is not None else
                          getattr(var, "partition_spec", None) or P()))
            else:
                nbytes, per_dev, spec = resolved
            sec = out[s]
            sec["total_bytes"] += nbytes
            sec["per_device_bytes"] += per_dev
            sec["sharded_vars" if per_dev < nbytes
                else "replicated_vars"] += 1
            sec["vars"][var.name] = {
                "bytes": nbytes, "per_device_bytes": per_dev,
                "spec": str(spec)}
    for sec in out.values():
        sec["replicated_per_device_bytes"] = sec["total_bytes"]
    out["total_bytes"] = sum(
        out[s]["total_bytes"] for s in ("params", "opt_state", "grads"))
    out["per_device_bytes"] = sum(
        out[s]["per_device_bytes"]
        for s in ("params", "opt_state", "grads"))
    out["replicated_per_device_bytes"] = out["total_bytes"]
    return out


# The reference threads XLA's latency-hiding-scheduler flags into
# XLA_FLAGS so the gradient reduction overlaps the backward.  The port has
# no XLA: its mesh path does the same itself — each boundary bucket's
# all-reduce starts (``async_op=True``) as soon as the backward has
# produced the bucket's gradients, and the step waits on all of them
# before the optimizer ops (``spmd.Spmd.boundary_grads``).  The buckets,
# their f32 sums and their log entries are the synchronous path's, so the
# bits do not move.  torch.distributed starts such a reduction on gloo
# (CPU and CUDA tensors) and on NCCL alike.
_OVERLAP = ("boundary_all_reduce_async",)


def _comm_overlap_enabled():
    """The ``PADDLE_TPU_COMM_OVERLAP`` knob (default on; ``0`` off)."""
    return os.environ.get("PADDLE_TPU_COMM_OVERLAP", "1").lower() not in (
        "0", "", "false")


def comm_overlap_flags(platform):
    """The overlap the mesh path applies on ``platform`` ("gpu" / "cuda"
    / "cpu"), as a tuple of names: ``("boundary_all_reduce_async",)`` on
    each, () on any other (the reference's "tpu" flags have no
    counterpart here)."""
    return _OVERLAP if platform in ("gpu", "cuda", "cpu") else ()


def enable_comm_overlap(platform=None):
    """What the mesh path overlaps, as :func:`comm_overlap_flags` names it
    (idempotent).  Honors ``PADDLE_TPU_COMM_OVERLAP`` (default on; ``0``
    disables, and then returns ()): the knob itself is what the mesh path
    reads at each step, so this call changes nothing and may come at any
    time.  ``platform`` defaults to "gpu" where a card is visible, else
    "cpu"."""
    if not _comm_overlap_enabled():
        return ()
    if platform is None:
        import torch

        platform = "gpu" if torch.cuda.is_available() else "cpu"
    return comm_overlap_flags(platform)
