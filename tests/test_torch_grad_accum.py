"""Gradient accumulation in the port's Executor: the same math as the big
batch, another schedule — the contract of ``tests/test_grad_accum.py``,
here on the 2-layer GPT (f32, CPU).

* Two microbatches of an 8-row batch equal one 8-row step: losses within
  2e-5 relative, parameters after three Adam steps within 2e-4 relative
  of the largest entry (the key biases aside: their gradient is zero
  analytically, see ``test_torch_training.py``), the batch-shaped fetch
  concatenated back, the batch-sum fetch added, ``@GRAD_NORM@`` the mean gradient's norm.  Every
  row carries the same number of labelled tokens, so the microbatch
  losses weigh equally.
* The same run through the JAX package's accumulation agrees within
  ``ORACLE_TOL`` (loss 2e-4, step-1 gradients 1e-3).
* A batch that does not divide raises; so does a fetch that mixes a
  batch sum with a constant.
* Accumulation composes with ``selective`` remat: the two together equal
  accumulation alone exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import transformer as ttr
from torch_ref_gauges import restore_reference_gauges  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """The reference reads tuned attention and serving geometry from its
    tune cache (``PADDLE_TPU_TUNE_CACHE``, else ``~/.cache/paddle_tpu``);
    the port reads its own (``~/.cache/paddle_tpu_torch``) under the same
    variable.  A cache path in a fresh directory holds no entry, so both
    packages build with their defaults whatever cache the host has."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


VOCAB, T, BATCH, STEPS = 61, 16, 8, 3
CFG = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, max_len=T,
           dropout_rate=0.0, dtype="float32", fused_head=True,
           learning_rate=2e-3)
BATCH_SUM = "reduce_sum_0.tmp_0"       # sum over the batch of masked losses


def _build(pkg, model):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup):
        out = model.build(**CFG)
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


def _train(pkg, model, accum, init=None, policy=None, extra=()):
    main, startup, out = _build(pkg, model)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    if accum > 1:
        pkg.gradient_accumulation(main, accum)
    params = [p.name for p in main.all_parameters()]
    fetch = ([out["avg_cost"].name] + list(extra)
             + [p + "@GRAD" for p in params])
    if pkg is pt:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        init = {v.name: np.asarray(scope.get(v.name))
                for v in main.persistable_vars()}
    else:
        scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
        exe = tpt.Executor(tpt.CPUPlace())
    rec = {"loss": [], "extra": [], "grad_norm": []}
    for i, feed in enumerate(_batches(0)):
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        rec["loss"].append(float(np.asarray(outs[0], np.float32).ravel()[0]))
        rec["extra"].append([np.asarray(x) for x in outs[1:1 + len(extra)]])
        rec["grad_norm"].append(float(np.asarray(scope.get("@GRAD_NORM@"))))
        if i == 0:
            rec["grads"] = {p: np.asarray(g, np.float32)
                            for p, g in zip(params, outs[1 + len(extra):])}
    rec["params"] = {p: np.asarray(scope.get(p), np.float32) for p in params}
    rec["init"] = init
    return rec


@pytest.fixture(scope="module")
def runs():
    ref = _train(pt, jtr, 2)
    init = ref["init"]
    extra = ("tokens", BATCH_SUM)
    return {"jax_accum": ref,
            "big": _train(tpt, ttr, 1, init, extra=extra),
            "accum": _train(tpt, ttr, 2, init, extra=extra)}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_accum_matches_the_big_batch(runs):
    big, acc = runs["big"], runs["accum"]
    np.testing.assert_allclose(acc["loss"], big["loss"], rtol=2e-5)
    np.testing.assert_allclose(acc["grad_norm"], big["grad_norm"],
                               rtol=1e-4)
    for p, want in big["params"].items():
        if "_att_k.b" in p:
            # zero gradient analytically, roundoff in practice, which
            # Adam turns into steps of either sign (test_torch_training)
            continue
        assert _rel(acc["params"][p], want) <= 2e-4, p
    for (toks_a, sum_a), (toks_b, sum_b), feed in zip(
            acc["extra"], big["extra"], _batches(0)):
        assert np.array_equal(toks_a, feed["tokens"])   # concatenated
        assert np.array_equal(toks_b, feed["tokens"])
        np.testing.assert_allclose(sum_a, sum_b, rtol=2e-5)   # added
    assert acc["loss"][-1] < acc["loss"][0]


def test_accum_matches_the_reference_accumulation(runs):
    got, want = runs["accum"], runs["jax_accum"]
    fwd_tol = tfa.oracle_tol(torch.float32, "fwd")
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) <= fwd_tol * abs(b), (got["loss"], want["loss"])
    biggest = max(np.abs(g).max() for g in want["grads"].values())
    for p, g in got["grads"].items():
        scale = (biggest if "_att_k.b" in p
                 else max(np.abs(want["grads"][p]).max(), 1e-30))
        assert np.abs(g - want["grads"][p]).max() <= 1e-3 * scale, p
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)


def test_accum_composes_with_selective_remat(runs):
    init = runs["big"]["init"]
    plain = runs["accum"]
    both = _train(tpt, ttr, 2, init, policy="selective",
                  extra=("tokens", BATCH_SUM))
    assert both["loss"] == plain["loss"]
    for p, want in plain["params"].items():
        assert np.array_equal(both["params"][p], want), p


def test_indivisible_batch_and_mixed_fetch_raise(runs):
    init = runs["big"]["init"]
    main, _, out = _build(tpt, ttr)
    tpt.gradient_accumulation(main, 3)
    scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    exe = tpt.Executor(tpt.CPUPlace())
    with pytest.raises(ValueError, match="not divisible"):
        exe.run(main, feed=_batches(0)[0], fetch_list=[out["avg_cost"]],
                scope=scope)
    with pytest.raises(ValueError, match="micro_steps must be >= 1"):
        tpt.gradient_accumulation(main, 0)
    tpt.gradient_accumulation(main, 2)
    # the token count plus its epsilon: a batch sum mixed with a constant
    mixed = next(op.outputs["Out"][0] for op in main.global_block().ops
                 if op.type == "elementwise_add"
                 and op.inputs["X"] == ["reduce_sum_1.tmp_0"])
    with pytest.raises(ValueError, match="mixes batch-sum"):
        exe.run(main, feed=_batches(0)[0], fetch_list=[mixed], scope=scope)
