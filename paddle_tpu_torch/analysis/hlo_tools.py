"""Run-level artifact tools for the static-analysis engine — the port's
counterpart of ``paddle_tpu/analysis/hlo_tools.py``.

The reference reads its run-level figures from the compiled executable:
``memory_analysis()`` (argument, output, temp and alias bytes, the HBM
high-water) and the optimized HLO text (collectives, shapes).  The port
has no executable, so the figures come from the step itself:

* the **memory figure** (:func:`measured_memstats`): on the card, one
  step's ``torch.cuda.max_memory_allocated``; on the CPU and as a
  preflight (:func:`static_memstats`), the analytic
  ``tune.space.estimate_gpt_step_hbm`` of a GPT program
  (:func:`gpt_dims` reads its dimensions off the flash ops), else None;
* the **in-place record** that stands in for donation aliasing: of the
  state the optimizer ops update (``argument_bytes``), how many bytes the
  step wrote in place (``alias_bytes``) rather than into new tensors,
  which would keep two copies of the state alive at the step's peak;
* the collectives: a mesh step's log as a ``CommPlan``
  (``analysis.comm``), the reference's ``hlo_comm_report`` keys coming
  from ``CommPlan.comm_report``;
* :func:`shape_hits` counts a shape among the op records' values, where
  the reference matches its pattern in the HLO text.
"""

__all__ = ["gpt_dims", "static_memstats", "measured_memstats",
           "updated_state", "inplace_record", "kernel_families",
           "shape_hits"]


def gpt_dims(program, batch):
    """The ``estimate_gpt_step_hbm`` arguments of a GPT-family program,
    read off its ops: the flash ops (one a layer: ``n_layer``, ``t``,
    heads), the LM head's or the embedding's vocabulary, the remat policy
    and the accumulation factor; None for a program without flash ops."""
    block = program.global_block()
    flash = [op for op in block.ops
             if op.type in ("flash_attention", "flash_attention_packed")]
    if not flash:
        return None
    op = flash[0]
    q = block._find_var(op.inputs["Q"][0])
    if q is None or len(q.shape) < 3 or int(q.shape[1]) <= 0:
        return None
    if op.type == "flash_attention_packed":
        n_head = int(op.attrs.get("n_head") or 1)
        d_model = int(q.shape[2])
    else:
        n_head, d_model = int(q.shape[2]), int(q.shape[2] * q.shape[3])
    vocab = 0
    for o in block.ops:
        if o.type == "fused_softmax_ce_head":
            vocab = int(block._find_var(o.inputs["W"][0]).shape[-1])
        elif o.type in ("lookup_table", "embedding") and not vocab:
            vocab = int(block._find_var(o.inputs["W"][0]).shape[0])
    b = int(q.shape[0]) if int(q.shape[0]) > 0 else int(batch)
    return {"n_layer": len(flash), "d_model": d_model, "n_head": n_head,
            "vocab": vocab, "seq_len": int(q.shape[1]), "batch": b,
            "policy": getattr(program, "_remat_policy", None) or "none",
            "accum": int(getattr(program, "_grad_accum", 1) or 1),
            "dtype_size": q.dtype.itemsize}


def static_memstats(program, batch):
    """The memory figure without a run: ``estimate_gpt_step_hbm`` of a
    GPT program (``source`` "estimate"), else None (``source`` None)."""
    dims = gpt_dims(program, batch)
    if dims is None:
        return {"hbm_high_water_bytes": None, "source": None}
    from ..tune.space import estimate_gpt_step_hbm

    return {"hbm_high_water_bytes": int(estimate_gpt_step_hbm(**dims)),
            "source": "estimate"}


def updated_state(program):
    """The persistables the optimizer ops (``optimize`` role, or every op
    after the backward marker) write."""
    block = program.global_block()
    bw = block.backward_index
    ops = block.ops[bw:] if bw is not None else [
        op for op in block.ops if getattr(op, "role", "") == "optimize"]
    persist = {v.name for v in program.persistable_vars()}
    return sorted({n for op in ops for n in op.output_names()} & persist)


def inplace_record(before, after):
    """``{"argument_bytes", "alias_bytes"}`` of the updated state: its
    bytes, and how many the step wrote in place (the tensor after the
    step is the one before it).  ``before`` / ``after``: ``{name:
    tensor}``."""
    arg = alias = 0
    for n, t in before.items():
        nbytes = t.numel() * t.element_size()
        arg += nbytes
        u = after.get(n)
        if u is not None and u.data_ptr() == t.data_ptr():
            alias += nbytes
    return {"argument_bytes": int(arg), "alias_bytes": int(alias)}


def measured_memstats(exe, program, scope, feeds, fetch_names, state):
    """One step of ``program`` on the card from ``state``: its
    ``max_memory_allocated`` (``source`` "max_memory_allocated") and the
    in-place record.  A step that runs out of memory reports the card's
    capacity plus one byte (``source`` "oom"), so the preflight fires."""
    import torch

    dev = exe.device
    names = [n for n in updated_state(program) if n in state]
    before = {n: state[n] for n in names}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        exe.run(program, feed=feeds, fetch_list=fetch_names, scope=scope,
                return_numpy=False)
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError:
        total = torch.cuda.get_device_properties(dev).total_memory
        return {"hbm_high_water_bytes": int(total) + 1, "source": "oom",
                "argument_bytes": 0, "alias_bytes": None}
    out = {"hbm_high_water_bytes": int(torch.cuda.max_memory_allocated(dev)),
           "source": "max_memory_allocated"}
    out.update(inplace_record(before, {n: scope.get(n) for n in names}))
    return out


def _expected_family(call):
    """The family a kernel op's static rule gives at its record's dtype
    and widths (``flash_attention.bwd_family``, ``fused_ce.ce_family``,
    on contiguous aligned inputs)."""
    from ..core.dtypes import torch_dtype
    from ..kernels import flash_attention as fa
    from ..kernels import fused_ce as ce

    if call["dtype"] is None or call["d"] is None:
        return "simple"
    dtype = torch_dtype(call["dtype"])
    if call["type"] == "fused_softmax_ce_head":
        return ce.ce_family(dtype, call["d"], call["v"] or 0, ())
    return fa.bwd_family(dtype, call["d"], (), ())


def kernel_families(records, before, after, device):
    """The kernel family each kernel op class of a step ran (the
    Executor's ``last_step_cost["kernel_families"]``), from its op records
    and the family counters before and after it
    (``kernels.family_counts``):
    ``"plain"`` on the CPU, else ``"sm90"``, ``"simple"`` where the op's
    static rule gives simple (its dtype or widths), or ``"simple-forced"``
    where the rule gives sm90 and the step launched the simple family.
    Keys ``flash_attention`` and ``fused_ce``; {} without kernel ops."""
    from .jaxpr_tools import kernel_call

    groups = {"flash_attention": (("flash_attention_fwd",
                                   "flash_attention_bwd",
                                   "flash_attention_split"),
                                  ("flash_attention",
                                   "flash_attention_packed")),
              "fused_ce": (("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"),
                           ("fused_softmax_ce_head",))}
    out = {}
    for cls, (counters, types) in groups.items():
        calls = [kernel_call(r) for r in records if r.type in types]
        if not calls:
            continue
        if device.type == "cpu":
            out[cls] = "plain"
            continue
        delta = {fam: sum(after[c].get(fam, 0) - before[c].get(fam, 0)
                          for c in counters) for fam in ("sm90", "simple")}
        if delta["simple"] > 0:
            rule = {_expected_family(c) for c in calls}
            out[cls] = "simple-forced" if rule == {"sm90"} else "simple"
        elif delta["sm90"] > 0:
            out[cls] = "sm90"
    return out


def shape_hits(records, shape):
    """How many values of the op records have exactly ``shape``."""
    shape = tuple(int(d) for d in shape)
    return sum(1 for r in records for _n, s, _d in r.ins + r.outs
               if s is not None and tuple(s) == shape)
