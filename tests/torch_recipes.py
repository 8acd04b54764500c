"""Shared pieces of the training-recipe parity tests
(``test_torch_optimizers.py``, ``test_torch_clip_regularizer.py``,
``test_torch_lr_decay.py``, ``test_torch_offload.py``).

The model is the 2-layer, d_model 64, f32 GPT of
``transformer.build`` with dropout 0; its own ``Adam`` is swapped for a
recipe (``optimizer_of``), so both packages build the same forward and
the recipe's ops come after it exactly as a user's script appends them.
The reference's post-startup persistables go into the port through
``load_numpy_state``; the same seeded feeds go through both.  Labels
fill every position: a token seen only at a masked label has an
embedding row whose gradient is roundoff, which an adaptive optimizer
turns into steps of either sign."""

import contextlib
import types

import numpy as np
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt

VOCAB, T, BATCH = 61, 16, 4
CFG = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=64, max_len=T,
           dropout_rate=0.0, dtype="float32", fused_head=False)
# ORACLE_TOL f32 (paddle_tpu/kernels/xla_ref.py): forward and gradients
FWD_TOL, GRAD_TOL = 2e-4, 1e-3


@contextlib.contextmanager
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def optimizer_of(pkg, make):
    """``pkg.models.transformer.build`` with ``make()`` as its optimizer
    (called where build constructs its Adam, inside the program guard, so
    a learning-rate schedule built there lands in the program)."""
    mod = pkg.models.transformer
    orig = mod.opt
    mod.opt = types.SimpleNamespace(Adam=lambda learning_rate: make(pkg))
    try:
        yield
    finally:
        mod.opt = orig


def build(pkg, make, post=None, **over):
    """(main, startup, model) of the recipe GPT in ``pkg``; ``post(pkg,
    main)`` edits the program after it is built (a remat policy, an error
    clip)."""
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with optimizer_of(pkg, make), pkg.program_guard(main, startup):
        model = pkg.models.transformer.build(**dict(CFG, **over))
    if post is not None:
        post(pkg, main)
    return main, startup, model


def feeds(seed, steps, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, VOCAB, (batch, T)).astype(np.int64),
             "labels": rng.integers(0, VOCAB, (batch, T)).astype(np.int64)}
            for _ in range(steps)]


def ref_start(make, post=None, **over):
    """The reference's program, executor, scope after startup, and the
    persistables as numpy arrays."""
    main, startup, model = build(pt, make, post, **over)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    init = {v.name: np.asarray(scope.get(v.name))
            for v in main.persistable_vars()
            if scope.find_var(v.name) is not None}
    return main, model, exe, scope, init


def port_start(make, init, post=None, **over):
    main, startup, model = build(tpt, make, post, **over)
    scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    return main, model, tpt.Executor(tpt.CPUPlace()), scope


def run(pkg, exe, main, model, scope, batches, extra=()):
    """Each step's fetched loss and ``extra`` values, as f32 numpy."""
    out = []
    fetch = [model["avg_cost"]] + list(extra)
    for feed in batches:
        vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        out.append([np.asarray(v, np.float32) for v in vals])
    return out


def state(scope, names):
    """``{name: f32 numpy}`` of either package's scope."""
    return {n: np.asarray(scope.numpy(n) if isinstance(
        scope.get(n), torch.Tensor) else scope.get(n), np.float32)
        for n in names}


def rel(a, b):
    """max |a - b| / max |b| (0 when both are 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / scale) if scale else float(
        np.max(np.abs(a)))


def recipe_parity(make, steps=3, seed=0, ckdir=None, post=None, extra=(),
                  **over):
    """``steps`` steps of the recipe ``make`` in both packages from one
    state: ``{"ref", "got"}`` losses, ``{"ref_extra", "got_extra"}`` the
    values of the names ``extra(main)`` each step, and
    ``{"ref_state", "got_state"}`` every persistable after them.  With ``ckdir`` the reference saves its
    persistables there (its ``io``) before the last step, and
    ``"resumed"`` holds a fresh port scope loaded from them after its last
    step: the loss, the state and the accumulators' dtypes."""
    with no_tf32():
        jmain, jmodel, jexe, jscope, init = ref_start(make, post, **over)
        tmain, tmodel, texe, tscope = port_start(make, init, post, **over)
        jx, tx = (list(extra(jmain)), list(extra(tmain))) if extra else (
            [], [])
        batches = feeds(seed, steps)
        ref = run(pt, jexe, jmain, jmodel, jscope, batches[:-1], jx)
        if ckdir:
            with pt.core.scope.scope_guard(jscope):
                pt.io.save_persistables(jexe, ckdir, jmain)
        ref += run(pt, jexe, jmain, jmodel, jscope, batches[-1:], jx)
        got = run(tpt, texe, tmain, tmodel, tscope, batches, tx)
        out = {"ref": [float(r[0].ravel()[0]) for r in ref],
               "got": [float(g[0].ravel()[0]) for g in got],
               "ref_extra": [r[1:] for r in ref],
               "got_extra": [g[1:] for g in got],
               "init": init, "port": (tmain, tmodel, texe, tscope),
               "ref_state": state(jscope, init),
               "got_state": state(tscope, init)}
        if ckdir:
            scope = tpt.Scope()
            with tpt.scope_guard(scope):
                tpt.io.load_persistables(texe, ckdir, tmain)
            loss = run(tpt, texe, tmain, tmodel, scope, batches[-1:])
            out["resumed"] = {
                "loss": float(loss[0][0].ravel()[0]),
                "state": state(scope, init),
                "accumulators": {v.name: scope.get(v.name).dtype
                                 for v in tmain.persistable_vars()
                                 if getattr(v, "zero_param", None)}}
    return out
