"""Executor — runs a Program on torch tensors (the port's counterpart of
``paddle_tpu/core/executor.py``, single device, no remat, no gradient
accumulation).

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
scope's ``@RNG@`` entry: read before the step, written back after.

Memory: the environment drops a value right after its last reader (the
autograd graph keeps what the backward needs), and an op that takes
``_live`` skips outputs nothing reads — eager execution has no compiler
to remove them.
"""

import numpy as np
import torch

from .dtypes import torch_dtype
from .place import resolve_device
from .program import GRAD_SUFFIX, Parameter, default_main_program
from .registry import get_op_impl
from .scope import (GRAD_NORM_VAR, RNG_VAR, global_scope, tensor_from_numpy,
                    tensor_to_numpy)

__all__ = ["Executor", "LoweringCtx", "run_block_ops"]


class LoweringCtx:
    """What op implementations may ask of the run: the device tensors are
    made on, and the step's random generator."""

    def __init__(self, device, gen):
        self.device = device
        self.gen = gen


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
    read)."""

    def __init__(self, ops, keep):
        last = {}
        for i, op in enumerate(ops):
            for n in op.input_names() + op.output_names():
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
            read_later.update(ops[i].input_names())


def run_block_ops(ctx, block, ops, env, inside_grad_prefix=False, plan=None,
                  first=0):
    """Evaluate ``ops`` (``block.ops[first:first + len(ops)]`` of ``plan``)
    over the name -> tensor environment ``env``."""
    for i, op in enumerate(ops, start=first):
        impl = get_op_impl(op.type)
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
        try:
            outs = impl.call(ins, attrs, ctx,
                             live=None if plan is None else plan.live[i])
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


class Executor:
    """``Executor(place)`` — ``place`` is ``CUDAPlace()``, ``CPUPlace()``, a
    device string, or None for the card.  With no place and no usable
    card it raises; the CPU must be asked for.  On the card the flash-
    attention kernels are built here, outside any timed step."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache = {}
        if self.device.type == "cuda":
            if self.device.index is None:  # "cuda" -> the current card
                self.device = torch.device(
                    "cuda", torch.cuda.current_device())
            from ..kernels import flash_attention as _fa

            _fa.build()

    # ------------------------------------------------------------------
    def _prepare(self, program, feed, fetch_list, scope):
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
            # a tensor already on the device makes no host round trip
            feeds[n] = val.to(device=self.device, dtype=dtype)
        state_names = tuple(sorted(
            v.name for v in program.persistable_vars()
            if scope.find_var(v.name) is not None))
        state = {n: scope.get(n) for n in state_names}
        for n, t in state.items():
            if t.device != self.device:
                raise ValueError(
                    f"scope variable {n!r} lies on {t.device}, this "
                    f"Executor runs on {self.device}")
        return program, scope, feeds, fetch_names, state_names, state

    def lower(self, program, fetch_names, state_names):
        """Build ``step(state, feeds, gen) -> (new_state, fetches,
        grad_norm)`` for a program — the eager counterpart of the JAX
        Executor's ``lower``.  The liveness plans are computed here, once
        per (program version, fetches, state)."""
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
        plan = _Plan(ops, keep)
        device = self.device

        def step(state, feeds, gen):
            ctx = LoweringCtx(device, gen)
            env = dict(state)
            env.update(feeds)
            grad_norm = None
            if bw is None or info is None:
                with torch.no_grad():
                    run_block_ops(ctx, block, ops, env, plan=plan)
            else:
                param_names = [n for n in info["params"] if n in env]
                params = [env[n] for n in param_names]
                for p in params:
                    p.requires_grad_(True)
                try:
                    with torch.enable_grad():
                        run_block_ops(ctx, block, ops[:bw], env,
                                      inside_grad_prefix=True, plan=plan)
                        loss = env[info["loss"]]
                        grads = torch.autograd.grad(
                            loss.sum(), params, allow_unused=True)
                finally:
                    for p in params:
                        p.requires_grad_(False)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
                with torch.no_grad():
                    # the step's global gradient norm: one f32 sum of
                    # squares per parameter and one sqrt, a pure extra
                    # output that nothing in the update reads
                    grad_norm = (torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g.float())
                         for g in grads])) if grads else
                        torch.zeros((), device=device))
                    for n, g in zip(param_names, grads):
                        env[n + GRAD_SUFFIX] = g
                    env[info["loss"]] = loss.detach()
                    del loss, grads
                    run_block_ops(ctx, block, ops[bw:], env, plan=plan,
                                  first=bw)
            new_state = {n: env[n] for n in persist_out}
            fetches = [env[n].detach() for n in fetch_names]
            return new_state, fetches, grad_norm

        return step

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program, scope, feeds, fetch_names, state_names, state = (
            self._prepare(program, feed, fetch_list, scope))
        key = (program._serial, program._version, tuple(fetch_names),
               state_names)
        step = self._cache.get(key)
        if step is None:
            _check_fetches(program, fetch_names)
            step = self._cache[key] = self.lower(
                program, fetch_names, state_names)
        gen = torch.Generator(device=self.device)
        gen.set_state(scope.get(RNG_VAR))
        new_state, fetches, grad_norm = step(state, feeds, gen)
        scope.update(new_state)
        scope.set(RNG_VAR, gen.get_state())
        if grad_norm is not None:
            scope.set(GRAD_NORM_VAR, grad_norm)
        if return_numpy:
            return [tensor_to_numpy(f) for f in fetches]
        return fetches
