"""Five Adam steps of the 2-layer GPT through the port's Executor against
the same steps through the JAX package's, on the CPU.

Both packages build ``transformer.build(n_layer=2, vocab 61, max_len=16,
dropout_rate=0)``, with the unfused and (f32) the fused cross-entropy
head; the reference's post-startup
persistables (weights, Adam moments, beta powers, learning rate) are
imported with ``load_numpy_state``, never redrawn; the same five seeded
batches go through both.  Compared: the loss of every step, ``@GRAD`` of
every parameter at step 1, and every parameter and moment after step 5.

The reference's attention and fused head run their Pallas kernels in
interpret mode; the port's run the plain versions (CPU tensors).  Tolerances met:

* f32 (d_model 32 with the 4-D attention op, d_model 128 with the packed
  op): loss within 1e-5 relative, gradients within 1e-4 of the largest
  gradient entry of that parameter (ORACLE_TOL's grad bound is 1e-3),
  moments after five steps within 1e-4 and parameters within 1e-3 of the
  tensor's largest magnitude (Adam divides by ``sqrt(m2) + eps``, so an
  entry whose gradient nearly cancels moves by ``lr`` times a ratio of
  two roundoff-sized numbers);
  The key-projection biases (``block*_att_k.b``) are held apart: softmax
  is invariant to a shift of every key, so their gradient is zero
  analytically and roundoff (1e-9) in both packages, which Adam's
  ``g / (|g| + eps)`` turns into updates of either sign.  Both sides must
  show that zero; their values after five steps are not compared.
* bf16: loss within 2e-2 relative (bf16 rounds at other places in the two
  frameworks); parameters move and stay finite.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
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


VOCAB, T, BATCH, STEPS = 61, 16, 4, 5


def _cfg(d_model, dtype, fused_head=False):
    return dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=d_model,
                max_len=T, dropout_rate=0.0, dtype=dtype,
                fused_head=fused_head, learning_rate=2e-3)


def _batches(seed):
    """next = tok + 1 (mod vocab); the last label of each row, and one
    whole tail, are padding (-1) so the loss mask is exercised."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        start = rng.integers(0, VOCAB, (BATCH, 1))
        toks = (start + np.arange(T)[None, :]) % VOCAB
        labels = np.concatenate(
            [toks[:, 1:], -np.ones((BATCH, 1), np.int64)], axis=1)
        labels[0, T // 2:] = -1
        out.append({"tokens": toks.astype(np.int64),
                    "labels": labels.astype(np.int64)})
    return out


def _build(pkg, model, cfg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = model.build(**cfg)
    return main, startup, out


def _run_both(d_model, dtype, seed, fused_head=False):
    """(reference record, port record): losses, step-1 grads, final
    state.  One compiled reference program serves all five steps (the
    fetch list is the same every step)."""
    cfg = _cfg(d_model, dtype, fused_head)
    batches = _batches(seed)

    jmain, jstart, jout = _build(pt, jtr, cfg)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jmain.persistable_vars()]
    init = {n: np.asarray(jscope.get(n)) for n in names}
    params = [p.name for p in jmain.all_parameters()]
    fetch = [jout["avg_cost"].name] + [p + "@GRAD" for p in params]

    ref = {"loss": [], "grads": None}
    for i, feed in enumerate(batches):
        outs = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        ref["loss"].append(float(np.asarray(outs[0], np.float32).ravel()[0]))
        if i == 0:
            ref["grads"] = {p: np.asarray(g, np.float32)
                            for p, g in zip(params, outs[1:])}
    ref["state"] = {n: np.asarray(jscope.get(n)).astype(np.float32)
                    for n in names}

    tmain, _, tout = _build(tpt, ttr, cfg)
    scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    exe = tpt.Executor(tpt.CPUPlace())
    got = {"loss": [], "grads": None, "grad_norm": []}
    ptr_before = {n: scope.get(n).data_ptr() for n in names}
    for i, feed in enumerate(batches):
        outs = exe.run(tmain, feed=feed, fetch_list=fetch, scope=scope)
        got["loss"].append(float(outs[0].ravel()[0]))
        got["grad_norm"].append(float(scope.get("@GRAD_NORM@")))
        if i == 0:
            got["grads"] = dict(zip(params, outs[1:]))
    got["state"] = {n: scope.numpy(n) for n in names}
    got["in_place"] = all(
        scope.get(n).data_ptr() == ptr_before[n] for n in names
        if not n.startswith("beta"))
    return ref, got, init, params


def _is_key_bias(name):
    return "_att_k.b" in name


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module",
                params=[(32, False), (128, False), (32, True), (128, True)],
                ids=["d32_4d", "d128_packed", "d32_4d_fused_head",
                     "d128_packed_fused_head"])
def f32_run(request):
    d_model, fused_head = request.param
    return _run_both(d_model, "float32", seed=d_model, fused_head=fused_head)


def test_f32_loss_every_step(f32_run):
    ref, got, _, _ = f32_run
    assert len(got["loss"]) == STEPS
    for r, g in zip(ref["loss"], got["loss"]):
        assert abs(g - r) <= 1e-5 * abs(r), (ref["loss"], got["loss"])
    assert got["loss"][-1] < got["loss"][0]          # it trains


def test_f32_step1_gradients_of_every_parameter(f32_run):
    ref, got, _, params = f32_run
    assert set(got["grads"]) == set(params)
    biggest = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for p in params:
        assert got["grads"][p].shape == ref["grads"][p].shape, p
        if _is_key_bias(p):
            assert np.abs(got["grads"][p]).max() <= 1e-6 * biggest, p
            assert np.abs(ref["grads"][p]).max() <= 1e-6 * biggest, p
            continue
        assert _rel(got["grads"][p], ref["grads"][p]) <= 1e-4, p
    total = np.sqrt(sum(float(np.sum(np.square(g)))
                        for g in ref["grads"].values()))
    assert got["grad_norm"][0] == pytest.approx(total, rel=1e-4)


def test_f32_parameters_and_moments_after_five_steps(f32_run):
    ref, got, init, params = f32_run
    assert set(got["state"]) == set(ref["state"])
    for n, want in ref["state"].items():
        assert got["state"][n].shape == want.shape, n
        if _is_key_bias(n):
            continue
        tol = 1e-3 if n in params else 1e-4
        assert _rel(got["state"][n], want) <= tol, n
    for p in params:                                  # and they did move
        assert not np.array_equal(got["state"][p], init[p]), p
    assert got["state"]["beta1_pow_acc_0"][0] == pytest.approx(0.9 ** STEPS)
    assert got["state"]["beta2_pow_acc_0"][0] == pytest.approx(0.999 ** STEPS)


def test_f32_updates_are_in_place(f32_run):
    """Parameters and moments keep their storage from step to step (the
    port's spelling of buffer donation)."""
    assert f32_run[1]["in_place"]


def test_bf16_loss_trajectory():
    ref, got, init, params = _run_both(32, "bfloat16", seed=7)
    for r, g in zip(ref["loss"], got["loss"]):
        assert abs(g - r) <= 2e-2 * abs(r), (ref["loss"], got["loss"])
    for p in params:
        assert np.isfinite(got["state"][p]).all(), p
    moved = [p for p in params
             if not np.array_equal(got["state"][p],
                                   np.asarray(init[p], np.float32))]
    assert len(moved) == len(params)


def test_executor_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.Executor(tpt.CUDAPlace(0))
    assert tpt.Executor(tpt.CPUPlace()).device.type == "cpu"
    assert tpt.Executor("cpu").device.type == "cpu"


def test_run_without_backward_and_fetch_errors():
    """A forward-only clone runs under no_grad and leaves the state alone;
    a fetch that is not in the program fails with the program's size."""
    tmain, tstart, tout = _build(tpt, ttr, _cfg(32, "float32"))
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(tstart, scope=scope)
    test_prog = tmain.clone(for_test=True)
    feed = _batches(0)[0]
    before = scope.get("lm_head.w").clone()
    a, = exe.run(test_prog, feed=feed, fetch_list=[tout["avg_cost"].name],
                 scope=scope)
    b, = exe.run(test_prog, feed=feed, fetch_list=[tout["avg_cost"].name],
                 scope=scope, return_numpy=False)
    assert isinstance(b, torch.Tensor) and not b.requires_grad
    assert a[0] == b.item() and a[0] == pytest.approx(np.log(VOCAB), rel=0.1)
    assert torch.equal(scope.get("lm_head.w"), before)
    with pytest.raises(ValueError, match="not found in the program"):
        exe.run(tmain, feed=feed, fetch_list=["no_such_var"], scope=scope)


def test_dropout_draws_from_the_scope_rng_state():
    """With dropout on, two steps from one RNG state give the same loss;
    the state advances from step to step."""
    cfg = dict(_cfg(32, "float32"), dropout_rate=0.3, learning_rate=0.0)
    tmain, tstart, tout = _build(tpt, ttr, cfg)
    exe = tpt.Executor(tpt.CPUPlace())
    feed = _batches(1)[0]
    losses, states = [], []
    for _ in range(2):
        scope = tpt.Scope()
        exe.run(tstart, scope=scope)
        states.append(scope.get("@RNG@").clone())
        one, = exe.run(tmain, feed=feed, fetch_list=[tout["avg_cost"].name],
                       scope=scope)
        two, = exe.run(tmain, feed=feed, fetch_list=[tout["avg_cost"].name],
                       scope=scope)
        assert not torch.equal(scope.get("@RNG@"), states[-1])
        losses.append((one[0], two[0]))
    assert torch.equal(states[0], states[1])
    assert losses[0] == losses[1]
    assert losses[0][0] != losses[0][1]
