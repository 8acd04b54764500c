"""The port's memory engine (``memory_optimization_transpiler.py``,
``core/ir.py`` and the Executor's remat segments) against the JAX
package's, on the CPU.

* The same 2-layer GPT built in both packages gets the same
  ``_remat_segments`` from ``selective``, ``compact`` and ``full``; the
  same liveness and ``peak_live_bytes``; the same ``detect_repeated_run``,
  ``find_uniform_groups`` and ``prune_program`` results.
* Three f32 Adam steps under each policy equal the port without remat
  exactly (the checkpointed segments recompute the same arithmetic), and
  the JAX package under the same policy within ``ORACLE_TOL`` (loss 2e-4,
  step-1 gradients 1e-3 of the largest entry of each parameter).
* With ``dropout_rate=0.1`` remat still equals no remat exactly: a
  wrapped segment's recompute draws the forward's dropout mask.
* ``offload`` and ``auto`` raise with the ROADMAP item that brings them.
* The bytes of forward activations alive when the backward starts order
  the policies as the reference's saved sets do: ``compact`` below
  ``selective`` below no remat.
"""

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu import memory_optimization_transpiler as jmo
from paddle_tpu.core import ir as jir
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import memory_optimization_transpiler as tmo
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import transformer as ttr


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """The reference reads tuned attention and serving geometry from its
    tune cache (``PADDLE_TPU_TUNE_CACHE``, else ``~/.cache/paddle_tpu``);
    the port reads none.  A cache path in a fresh directory holds no
    entry, so both packages build with their defaults whatever cache the
    host has."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


VOCAB, T, BATCH, STEPS = 61, 16, 4, 3
POLICIES = ("selective", "compact", "full")


def _cfg(dropout=0.0, fused_head=True, d_model=32):
    return dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=d_model,
                max_len=T, dropout_rate=dropout, dtype="float32",
                fused_head=fused_head, learning_rate=2e-3)


def _build(pkg, model, cfg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        out = model.build(**cfg)
    return main, startup, out


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        start = rng.integers(0, VOCAB, (BATCH, 1))
        toks = (start + np.arange(T)[None, :]) % VOCAB
        labels = np.concatenate(
            [toks[:, 1:], -np.ones((BATCH, 1), np.int64)], axis=1)
        out.append({"tokens": toks.astype(np.int64),
                    "labels": labels.astype(np.int64)})
    return out


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused_head", "unfused_head"])
def programs(request):
    cfg = _cfg(fused_head=request.param)
    return _build(pt, jtr, cfg)[0], _build(tpt, ttr, cfg)[0]


@pytest.mark.parametrize("policy", POLICIES)
def test_same_segments_as_the_reference(programs, policy):
    jmain, tmain = programs
    want = jmo.memory_optimize(jmain, policy=policy)
    got = tpt.memory_optimize(tmain, policy=policy)
    assert got == want and tmain._remat_segments == jmain._remat_segments
    assert len(got) > 1 and any(w for _, _, w in got)
    if policy != "full":
        # the kernel ops stay unwrapped, their residuals saved
        ops = tmain.global_block().ops
        for s, t, wrap in got:
            if wrap:
                assert not any(op.type in tmo.EXPENSIVE_OPS
                               for op in ops[s:t])


def test_liveness_and_peak_bytes_match(programs):
    jmain, tmain = programs
    jg, tg = jmo.ControlFlowGraph(jmain), tmo.ControlFlowGraph(tmain)
    assert tg.defs == jg.defs and tg.uses == jg.uses
    assert tg.live_in == jg.live_in and tg.live_out == jg.live_out
    assert tg.peak_live_bytes() == jg.peak_live_bytes() > 0
    for i in (0, 5, len(tg.ops) // 2, len(tg.ops)):
        assert tg.live_at_cut(i) == jg.live_at_cut(i)


def test_structural_matching_matches(programs):
    jmain, tmain = programs
    bw = tmain.global_block().backward_index
    rep = tir.detect_repeated_run(tmain, 0, bw)
    assert rep == jir.detect_repeated_run(jmain, 0, bw)
    s0, period, count = rep
    assert count == 2                      # one run a transformer block
    segs = tmo.memory_optimize(tmain, policy="selective")
    jmo.memory_optimize(jmain, policy="selective")
    want = jir.find_uniform_groups(jmain, jmain._remat_segments)
    got = tir.find_uniform_groups(tmain, segs)
    assert got == want and got and got[0]["count"] == 2
    ops = tmain.global_block().ops
    assert tir.match_op_run(tmain, ops[s0:s0 + period],
                            ops[s0 + period:s0 + 2 * period]) == \
        jir.match_op_run(jmain, jmain.global_block().ops[s0:s0 + period],
                         jmain.global_block().ops[s0 + period:
                                                  s0 + 2 * period])


def test_prune_matches_and_no_longer_raises(programs):
    jmain, tmain = programs
    ops = tmain.global_block().ops
    target = next(n for op in ops if op.type == "layer_norm"
                  for n in op.outputs["Y"])
    got = tmain.prune([target])
    want = jir.prune_program(jmain, [target])
    sig = lambda p: [(op.type, op.inputs, op.outputs)  # noqa: E731
                     for op in p.global_block().ops]
    assert sig(got) == sig(want) and 0 < len(sig(got)) < len(ops)
    assert list(got.global_block().vars) == list(want.global_block().vars)
    assert got.global_block().backward_index is None
    assert got._serial != tmain._serial
    assert len(tmain.global_block().ops) == len(ops)   # the original stays


def _train(pkg, model, cfg, policy, batches, init=None, accum=1):
    """Losses, step-1 gradients and final parameters of STEPS Adam steps;
    the port's run starts from ``init`` (the reference's startup state)."""
    main, startup, out = _build(pkg, model, cfg)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    if accum > 1:
        pkg.gradient_accumulation(main, accum)
    params = [p.name for p in main.all_parameters()]
    fetch = [out["avg_cost"].name] + [p + "@GRAD" for p in params]
    if pkg is pt:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        init = {v.name: np.asarray(scope.get(v.name))
                for v in main.persistable_vars()}
    else:
        scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
        exe = tpt.Executor(tpt.CPUPlace())
    losses, grads = [], None
    for i, feed in enumerate(batches):
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(outs[0], np.float32).ravel()[0]))
        if i == 0:
            grads = {p: np.asarray(g, np.float32)
                     for p, g in zip(params, outs[1:])}
    final = {p: np.asarray(scope.get(p), np.float32) for p in params}
    return {"loss": losses, "grads": grads, "params": final, "init": init,
            "grad_norm": float(np.asarray(scope.get("@GRAD_NORM@")))}


@pytest.fixture(scope="module")
def reference_runs():
    batches = _batches(3)
    runs = {pol: _train(pt, jtr, _cfg(), pol, batches)
            for pol in (None,) + POLICIES}
    return batches, runs


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_training_equals_no_remat_and_the_reference(policy,
                                                          reference_runs):
    batches, ref = reference_runs
    init = ref[None]["init"]
    plain = _train(tpt, ttr, _cfg(), None, batches, init)
    got = _train(tpt, ttr, _cfg(), policy, batches, init)
    assert got["loss"] == plain["loss"]
    for p in got["params"]:
        assert np.array_equal(got["params"][p], plain["params"][p]), p
        assert np.array_equal(got["grads"][p], plain["grads"][p]), p
    want = ref[policy]
    fwd_tol = tfa.oracle_tol(torch.float32, "fwd")
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) <= fwd_tol * abs(b), (got["loss"], want["loss"])
    grad_tol = tfa.oracle_tol(torch.float32, "grad")
    biggest = max(np.abs(g).max() for g in want["grads"].values())
    for p, g in got["grads"].items():
        scale = (biggest if "_att_k.b" in p
                 else max(np.abs(want["grads"][p]).max(), 1e-30))
        assert np.abs(g - want["grads"][p]).max() <= grad_tol * scale, p


def test_remat_recomputes_only_what_the_policy_wraps(monkeypatch,
                                                    reference_runs):
    """selective and compact never re-run the flash forward (its
    residuals stay saved); full re-runs it once a layer in the backward."""
    cfg = _cfg()
    batches = _batches(4)[:1]
    calls = []
    real = tfa.flash_fwd
    monkeypatch.setattr(tfa, "flash_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    init = reference_runs[1][None]["init"]
    counts = {}
    for policy in (None,) + POLICIES:
        calls.clear()
        _train(tpt, ttr, cfg, policy, batches, init)
        counts[policy] = len(calls)
    assert counts == {None: 2, "selective": 2, "compact": 2, "full": 4}


def test_remat_with_dropout_equals_no_remat(reference_runs):
    """The generator trap: torch.utils.checkpoint restores only the
    global RNG; the port restores the step's generator before each
    recompute, so the masks, the loss, every gradient and the @RNG@ state
    after the step are those of the run without remat."""
    cfg = _cfg(dropout=0.1)
    batches = _batches(5)
    init = reference_runs[1][None]["init"]

    def run(policy):
        main, startup, out = _build(tpt, ttr, cfg)
        if policy:
            tpt.memory_optimize(main, policy=policy)
        exe = tpt.Executor(tpt.CPUPlace())
        scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
        params = [p.name for p in main.all_parameters()]
        outs = [exe.run(main, feed=f, fetch_list=[out["avg_cost"].name]
                        + [p + "@GRAD" for p in params], scope=scope)
                for f in batches]
        return outs, scope.get("@RNG@").clone(), {
            p: scope.numpy(p) for p in params}

    base = run(None)
    for policy in POLICIES:
        got = run(policy)
        for step_a, step_b in zip(got[0], base[0]):
            for a, b in zip(step_a, step_b):
                assert np.array_equal(a, b), policy
        assert torch.equal(got[1], base[1]), policy
        for p in base[2]:
            assert np.array_equal(got[2][p], base[2][p]), (policy, p)
    assert base[0][0][0] != base[0][1][0]      # dropout did draw


@pytest.mark.parametrize("policy", ["offload", "auto"])
def test_unported_policies_raise_with_their_roadmap_item(policy):
    """``auto`` raises, naming its ROADMAP.md item (A5, the tune cache).
    ``offload`` raised until the port brought it: it now marks the
    program and cuts selective's segments (tests/test_torch_offload.py)."""
    main = _build(tpt, ttr, _cfg())[0]
    if policy == "auto":
        with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
            tpt.memory_optimize(main, policy=policy)
    else:
        segs = tpt.memory_optimize(main, policy=policy)
        assert main._offload and segs == tpt.memory_optimize(
            _build(tpt, ttr, _cfg())[0], policy="selective")
    with pytest.raises(ValueError):
        tpt.memory_optimize(main, policy="everything")
    assert tpt.release_memory(main) is main


class _OpOutputs(TorchDispatchMode):
    """Records a weak reference to the storage of every tensor an ATen
    call returns while it is active."""

    def __init__(self):
        super().__init__()
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.storages[st.data_ptr()] = (StorageWeakRef(st),
                                                st.nbytes())
        return out

    def live_bytes(self):
        return sum(n for ref, n in self.storages.values()
                   if not ref.expired())


def _bytes_held_for_the_backward(policy, init):
    """Bytes of every forward activation still alive when the backward
    starts: what autograd saved, what checkpointed regions keep as inputs
    and what selective checkpointing cached (parameters and feeds are no
    op's output and do not count)."""
    main, _, out = _build(tpt, ttr, _cfg(d_model=64))
    if policy:
        tpt.memory_optimize(main, policy=policy)
    scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    held = []
    real_grad = torch.autograd.grad

    def grad(*a, **kw):
        held.append(rec.live_bytes())
        return real_grad(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd, "grad", grad)
        with _OpOutputs() as rec:
            loss, = tpt.Executor(tpt.CPUPlace()).run(
                main, feed=_batches(6)[0], fetch_list=[out["avg_cost"]],
                scope=scope)
    assert len(held) == 1 and np.isfinite(loss).all()
    return held[0]


def test_selective_saves_fewer_bytes_than_no_remat_and_compact_fewer_still():
    """The reference's ordering of the policies' saved sets
    (``docs/memory.md``): ``selective`` keeps the matrix and kernel ops'
    outputs and recomputes the rest, ``compact`` keeps only the kernels'."""
    main, startup, _ = _build(pt, jtr, _cfg(d_model=64))
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    init = {v.name: np.asarray(scope.get(v.name))
            for v in main.persistable_vars()}
    held = {policy: _bytes_held_for_the_backward(policy, init)
            for policy in (None, "selective", "compact")}
    assert held["compact"] < held["selective"] < held[None], held
