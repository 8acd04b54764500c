"""Whole-model gradient check — the ``--job=checkgrad`` trainer mode (the
port's counterpart of ``paddle_tpu/checkgrad.py``).

Reference: ``paddle/trainer/TrainerMain.cpp:54`` dispatches
``--job=checkgrad`` to ``Trainer.cpp:303 checkGradient``: perturb each
parameter, re-run the whole forward, and compare finite differences
against the analytic gradients.  This exercises the COMPLETE step — op
composition, the Executor's remat segments, custom autograd Functions and
dtype casts — under one check.

Analytic gradients come from the Executor's autograd backward (fetched as
``<param>@GRAD`` from an optimizer-stripped copy of the program, so
checking never mutates training state); numeric ones are central
differences through the same step with the scope's ``@RNG@`` state
pinned (the same dropout masks on every evaluation).  On the card the
check runs with TF32 off, so the step's f32 products are f32."""

import contextlib
import copy

import numpy as np
import torch

from .core.program import GRAD_SUFFIX, default_main_program
from .core.scope import RNG_VAR, global_scope, tensor_to_numpy

__all__ = ["check_gradients"]


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def check_gradients(feed, loss, program=None, scope=None, executor=None,
                    params=None, epsilon=1e-2, rel_tol=3e-2,
                    max_elements_per_param=6, seed=0, verbose=False):
    """Finite-difference check of every trainable parameter's gradient
    through the whole step.

    feed      one batch ({name: array}).
    loss      the scalar cost Variable (or its name).
    params    parameter-name subset (default: all differentiated).
    epsilon   central-difference step; f32 loss precision is ~1e-7
              relative, so keep eps >= 1e-2 unless the program runs f64.
    rel_tol   max allowed ``|num - ana| / max(1, |num| + |ana|)``.
    max_elements_per_param  sampled elements per parameter (deterministic
              from ``seed``).

    Returns ``(ok, report)`` where report maps param name ->
    ``{"max_rel_err": float, "checked": n}``."""
    from .core.executor import Executor

    program = program or default_main_program()
    scope = scope or global_scope()
    exe = executor or Executor()
    loss_name = loss if isinstance(loss, str) else loss.name

    # forward+backward-only copy: the gradients stay fetchable, and
    # nothing that mutates training state (optimizer updates, beta-pow
    # and LR accumulators, metric counters) survives
    prog = copy.deepcopy(program)
    block = prog.global_block()
    bw = block.backward_index
    if bw is None:
        raise ValueError("check_gradients needs a program with backward "
                         "(call optimizer.minimize first)")
    block.ops = block.ops[:bw]

    info = prog._backward_info.get(0) or {}
    diff_params = list(info.get("params", ()))
    names = params or diff_params or [
        p.name for p in prog.all_parameters() if p.trainable]
    not_diff = [n for n in names if diff_params and n not in diff_params]
    if not_diff:
        raise ValueError(
            f"params excluded from backward (no @GRAD): {not_diff}")
    missing = [n for n in names if scope.find_var(n) is None]
    if missing:
        raise ValueError(f"params not initialized in scope: {missing}")

    scope.ensure_rng(prog.random_seed, exe.device)
    rng_state = scope.get(RNG_VAR).clone()

    def run(fetch):
        # pin the RNG so every evaluation sees identical dropout masks
        scope.set(RNG_VAR, rng_state.clone())
        return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)

    rng = np.random.default_rng(seed)
    loss_var = block.var(loss_name)
    report = {}
    ok = True
    with _no_tf32():
        vals = run([loss_var] + [block.var(n + GRAD_SUFFIX) for n in names])
        analytic = {n: np.asarray(g, np.float64)
                    for n, g in zip(names, vals[1:])}
        for n in names:
            live = scope.get(n)
            orig = live.clone()
            flat = tensor_to_numpy(live).astype(np.float64).reshape(-1)
            k = min(max_elements_per_param, flat.size)
            idx = rng.choice(flat.size, size=k, replace=False)
            worst = 0.0
            try:
                for i in idx:
                    ana = float(analytic[n].reshape(-1)[i])
                    # two step sizes: the larger beats f32 roundoff, the
                    # smaller avoids crossing relu/maxpool kinks; score
                    # the better one
                    rel, num = np.inf, 0.0
                    for eps in (epsilon, epsilon / 8):
                        ls = {}
                        for sgn in (1.0, -1.0):
                            pert = flat.copy()
                            pert[i] += sgn * eps
                            live.copy_(torch.from_numpy(
                                pert.reshape(tuple(live.shape))))
                            ls[sgn] = float(np.asarray(
                                run([loss_var])[0]).ravel()[0])
                        num_e = (ls[1.0] - ls[-1.0]) / (2 * eps)
                        rel_e = abs(num_e - ana) / max(
                            1.0, abs(num_e) + abs(ana))
                        if rel_e < rel:
                            rel, num = rel_e, num_e
                    worst = max(worst, rel)
                    if verbose:
                        print(f"  {n}[{i}]: numeric={num:.6f} "
                              f"analytic={ana:.6f} rel={rel:.2e}")
            finally:
                # an aborted evaluation must never leave a perturbed
                # parameter in the live scope
                live.copy_(orig)
            report[n] = {"max_rel_err": worst, "checked": int(k)}
            if worst > rel_tol:
                ok = False
                if verbose:
                    print(f"FAIL {n}: max rel err {worst:.3e} > {rel_tol}")
    scope.set(RNG_VAR, rng_state)
    return ok, report
