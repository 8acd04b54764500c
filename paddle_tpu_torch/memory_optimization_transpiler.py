"""Memory optimization transpiler — the port's counterpart of
``paddle_tpu/memory_optimization_transpiler.py``.

Reference: ``python/paddle/v2/fluid/memory_optimization_transpiler.py`` —
``ControlFlowGraph`` runs a liveness analysis and the pass reuses dead
buffers.  The Executor already drops every value after its last reader,
so the half of the pass that matters is the *activation memory of the
backward*: autograd keeps every tensor a backward node saved until its
gradient use.  ``memory_optimize`` marks rematerialization segments on
the forward prefix — the same segments the reference marks on the same
program — and the Executor runs each wrapped segment under
``torch.utils.checkpoint`` so the backward recomputes its activations
instead of keeping them (``core/executor.py``).

Policies: ``selective``, ``compact``, ``full`` and ``offload`` as in the
reference.  ``offload`` is ``selective``'s segmentation with each
transformer block's input streamed to pinned host memory during the
forward and brought back one layer ahead during the backward (the
Executor's ``_Offload``; kill switch ``PADDLE_TPU_OFFLOAD=0``).  ``auto``
applies the tune cache's measured policy (``tune``), ``selective`` on a
miss.

``ControlFlowGraph`` is also exposed directly (defs/uses/live-in/live-out
and a peak-live-bytes estimate) for inspection parity with the reference.
"""

import math

from .core.program import default_main_program

__all__ = ["ControlFlowGraph", "EXPENSIVE_OPS", "MXU_OPS", "memory_optimize",
           "gradient_accumulation", "release_memory"]


class ControlFlowGraph:
    """Liveness over one block's op list (reference :33-120).

    defs[i]/uses[i]: names written/read by op i.  live_in[i]/live_out[i]:
    the classic backward dataflow fixpoint — one reverse sweep, since the
    op list is a straight line (control flow lives in sub-blocks, handled
    by their ops as units)."""

    def __init__(self, program, block_idx=0, ops=None):
        from .core.ir import sub_block_names

        self.program = program
        self.block = program.block(block_idx)
        self.ops = list(self.block.ops) if ops is None else list(ops)
        self.defs = []
        self.uses = []
        for op in self.ops:
            reads = set(op.input_names())
            writes = set(op.output_names())
            sub = op.attrs.get("sub_block")
            if sub is not None:
                sub_reads, sub_writes = sub_block_names(program, sub)
                reads |= sub_reads
                writes |= sub_writes
            self.uses.append(reads)
            self.defs.append(writes)
        self._analyze()

    def _analyze(self):
        n = len(self.ops)
        self.live_in = [set() for _ in range(n)]
        self.live_out = [set() for _ in range(n)]
        live = set()
        for i in range(n - 1, -1, -1):
            self.live_out[i] = set(live)
            live = (live - self.defs[i]) | self.uses[i]
            self.live_in[i] = set(live)

    def live_at_cut(self, i):
        """Names that must cross the boundary *before* op i (defined
        earlier, used at/after i)."""
        if i >= len(self.ops):
            return set()
        return self.live_in[i]

    def _var_bytes(self, name):
        var = self.block._find_var(name)
        if var is None or not var.shape:
            return 0
        numel = 1
        for s in var.shape:
            numel *= abs(int(s)) if s else 1
        return numel * var.dtype.itemsize

    def peak_live_bytes(self):
        """Estimated peak of live (non-persistable) activation bytes —
        the quantity the reference pass minimized by buffer reuse."""
        peak = 0
        for i in range(len(self.ops)):
            total = 0
            for name in self.live_in[i] | self.defs[i]:
                var = self.block._find_var(name)
                if var is not None and not var.persistable:
                    total += self._var_bytes(name)
            peak = max(peak, total)
        return peak


def _cut_cost(graph, i, exclude):
    return sum(
        graph._var_bytes(n)
        for n in graph.live_at_cut(i)
        if n not in exclude
    )


# op types whose forward is too expensive to recompute in the backward:
# every remat policy but "full" keeps them OUTSIDE the checkpointed
# segments, so their autograd residuals (flash attention's q, k, v, o,
# lse; the fused CE head's x, w, y, lse) stay saved and the kernels never
# re-run
EXPENSIVE_OPS = ("flash_attention", "flash_attention_packed",
                 "fused_softmax_ce_head", "scan_block",
                 "nested_rnn", "warpctc")

# matrix-unit ops: the selective policy also keeps these saved and
# recomputes only the cheap elementwise tail (LN, activations, residual
# adds, dropout)
MXU_OPS = ("mul", "matmul", "conv2d", "conv3d", "depthwise_conv2d",
           "conv2d_transpose", "conv3d_transpose")

def memory_optimize(input_program=None, num_segments=None, min_segment=2,
                    level=0, print_log=False, policy="selective",
                    expensive_ops=None):
    """Mark remat segments on the forward prefix of ``input_program`` (in
    place, like the reference).

    ``policy="selective"`` (default): maximal runs of cheap ops (layer
    norm, activations, residual adds, dropout) are wrapped; kernel ops
    (flash attention, the fused CE head) and matrix ops (projections,
    FFN matmuls) stay unwrapped with their outputs and residuals saved.
    The Executor merges each repeated layer's segments into one region
    whose matrix-op outputs alone are saved.

    ``policy="compact"``: only kernel ops stay saved; matmuls are
    recomputed too.

    ``policy="full"``: every segment recomputed (flash attention too),
    cut at the program's repeated structure (one transformer block a
    segment) or, failing that, at sqrt-N liveness-minimal cuts.

    ``policy="offload"``: ``selective``'s segments and saved set, with
    the block inputs (the residual stream entering each repeated layer)
    moved to pinned host memory between the forward and the backward: a
    change of placement only, so losses and gradients are ``selective``'s
    bits.  On CPU tensors the same structure runs with the inputs left
    in place (the reference's ``"save"`` mode); ``PADDLE_TPU_OFFLOAD=0``
    runs plain ``selective``.  ``Executor.last_remat_plan`` records the
    mode that ran.

    ``policy="auto"``: consult the tune cache (``tune.
    program_schedule_config``) for this program's flash workload key and
    apply the measured winner's policy; a miss, or ``PADDLE_TPU_TUNE=0``,
    gives ``selective``.  A tuned ``"none"`` leaves the program unmarked,
    and a tuned ``"fsdp"`` is set as ``program._fsdp``.

    Returns the segment list ``[(start, end, wrapped), ...]`` tiling the
    forward prefix, and stores it as ``program._remat_segments``."""
    program = input_program or default_main_program()
    if policy == "auto":
        from .tune import program_schedule_config

        cfg = program_schedule_config(program) or {}
        policy = cfg.get("policy") or "selective"
        if "fsdp" in cfg:
            program._fsdp = bool(cfg["fsdp"])
        if policy == "none":
            program._offload = False
            program._remat_segments = []
            program._remat_policy = "none"
            return []
    block = program.global_block()
    if policy not in ("selective", "compact", "full", "offload"):
        raise ValueError(
            f"memory_optimize policy must be 'selective', 'compact', "
            f"'full', 'offload' or 'auto', got {policy!r}")
    # the offload flag rides on the program (the Executor reads it); the
    # segmentation below is exactly selective's
    program._offload = policy == "offload"
    program._remat_policy = policy
    if policy == "offload":
        policy = "selective"
    bw = block.backward_index
    n_fwd = bw if bw is not None else len(block.ops)
    if n_fwd < 2 * min_segment:
        program._remat_segments = []
        return []

    if expensive_ops is None:
        expensive_ops = EXPENSIVE_OPS
        if policy == "selective":
            expensive_ops = EXPENSIVE_OPS + MXU_OPS
    expensive_at = [
        i for i in range(n_fwd) if block.ops[i].type in expensive_ops
    ]
    if policy in ("selective", "compact") and expensive_at:
        segments = []
        pos = 0
        for i in expensive_at:
            if i > pos:
                segments.append((pos, i, True))
            segments.append((i, i + 1, False))
            pos = i + 1
        if pos < n_fwd:
            segments.append((pos, n_fwd, True))
        # wrapping a tiny tail saves nothing and costs a checkpoint
        segments = [
            (s, t, wrap and (t - s) >= min_segment)
            for s, t, wrap in segments
        ]
        # merge adjacent unwrapped segments (runs of saved ops) so the
        # executor sees few, large segments instead of op-sized slivers
        merged = []
        for seg in segments:
            if (merged and not seg[2] and not merged[-1][2]
                    and merged[-1][1] == seg[0]):
                merged[-1] = (merged[-1][0], seg[1], False)
            else:
                merged.append(seg)
        segments = [tuple(s) for s in merged]
        program._remat_segments = segments
        program._bump_version()
        if print_log:
            n_wrap = sum(1 for _, _, w in segments if w)
            print(f"memory_optimize[{policy}]: {len(segments)} segments, "
                  f"{n_wrap} wrapped, expensive at {expensive_at}")
        return segments

    # "full": cut at the boundaries of the program's repeated structure
    # (one transformer block a segment); liveness-minimal sqrt-N cuts are
    # the fallback for programs with no repetition
    from .core.ir import detect_repeated_run

    rep = detect_repeated_run(program, 0, n_fwd)
    if rep is not None and num_segments is None:
        s0, p, count = rep
        segments = []
        if s0 > 0:
            segments.append((0, s0, s0 >= min_segment))
        segments += [(s0 + i * p, s0 + (i + 1) * p, True)
                     for i in range(count)]
        tail = s0 + count * p
        if tail < n_fwd:
            segments.append((tail, n_fwd, (n_fwd - tail) >= min_segment))
        program._remat_segments = segments
        program._bump_version()
        if print_log:
            print(f"memory_optimize[full]: {count} uniform segments of "
                  f"{p} ops at {s0} (+prologue/epilogue)")
        return segments

    graph = ControlFlowGraph(program, 0, block.ops[:n_fwd])
    k = num_segments or max(2, int(math.isqrt(n_fwd)))
    # parameters/data cross every cut anyway — exclude them from cut cost
    always_live = {
        v.name for v in block.vars.values() if v.persistable or v.is_data
    }
    # candidate cut positions ranked by bytes that would have to be saved
    candidates = sorted(
        range(min_segment, n_fwd - min_segment + 1),
        key=lambda i: _cut_cost(graph, i, always_live),
    )
    cuts = []
    for i in candidates:
        if len(cuts) >= k - 1:
            break
        if all(abs(i - c) >= min_segment for c in cuts):
            cuts.append(i)
    cuts = sorted(cuts)
    bounds = [0] + cuts + [n_fwd]
    segments = [
        (bounds[j], bounds[j + 1], True) for j in range(len(bounds) - 1)
        if bounds[j + 1] > bounds[j]
    ]
    program._remat_segments = segments
    program._bump_version()
    if print_log:
        print(f"memory_optimize: {len(segments)} remat segments {segments}, "
              f"peak live ~{graph.peak_live_bytes() / 1e6:.1f} MB")
    return segments


def gradient_accumulation(input_program=None, micro_steps=1):
    """Split every training step into ``micro_steps`` microbatches: the
    feed batch is sliced along its leading axis, forward and backward run
    per microbatch, gradients accumulate in float32, and the optimizer
    applies ONCE with the mean gradient — activation memory scales with
    the microbatch.  Mean-of-microbatch-averages equals the big-batch
    average-loss gradient when microbatches carry equal loss weight.

    Composes with ``memory_optimize``: segments apply inside each
    microbatch.  Feed leading dims must divide by ``micro_steps``."""
    program = input_program or default_main_program()
    micro_steps = int(micro_steps)
    if micro_steps < 1:
        raise ValueError(f"micro_steps must be >= 1, got {micro_steps}")
    program._grad_accum = micro_steps
    program._bump_version()
    return program


def release_memory(input_program=None):
    """Reference API parity (a no-op: the Executor frees each value after
    its last reader; remat via ``memory_optimize`` is the active knob)."""
    return input_program
