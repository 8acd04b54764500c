"""The port's optimizers against the JAX package's, on the CPU.

* Each optimizer class the port added (SGD, Adagrad, Adamax,
  DecayedAdagrad, Adadelta, RMSProp with momentum, Ftrl with l1 and l2)
  and Momentum with Nesterov: the same persistables by name, shape and
  dtype, then 3 steps of the 2-layer f32 GPT (``torch_recipes``) from one
  state; losses within ORACLE_TOL f32's forward bound (2e-4 relative),
  every parameter and accumulator within its gradient bound (1e-3 of the
  tensor's largest magnitude).  The key-projection biases and their
  accumulators are left out: their gradient is zero analytically and
  roundoff in both packages.  Adamax runs with epsilon 1e-5: at its
  default 1e-8 an entry whose first gradient is roundoff-sized takes a
  step of +-lr of either sign in either package (as Adam's do).
* Each update op the port added, on random arrays in f32 and in bf16
  (bf16 parameter and gradient, f32 state), against the reference op:
  f32 outputs within 2e-4, a bf16 parameter within 2e-2 (one bf16 ulp
  where the two f32 results straddle a rounding boundary).
* ``ModelAverage`` against the reference's: the averages after 3 steps,
  the evaluation loss under ``apply()``, and every parameter restored bit
  for bit (the same tensor) afterwards.
* A JAX-written Adagrad and Ftrl checkpoint (f32) loads into the port
  and continues within tolerance.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op_impl as ref_op
from paddle_tpu_torch.core.registry import get_op_impl as port_op

import torch_recipes as R

OPTIMIZERS = {
    "sgd": lambda o: o.SGD(learning_rate=5e-2),
    "momentum_nesterov": lambda o: o.Momentum(learning_rate=2e-2,
                                              momentum=0.9,
                                              use_nesterov=True),
    "adagrad": lambda o: o.Adagrad(learning_rate=3e-3),
    "adamax": lambda o: o.Adamax(learning_rate=5e-3, epsilon=1e-5),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(learning_rate=2e-3),
    "adadelta": lambda o: o.Adadelta(learning_rate=1.0, rho=0.9),
    "rmsprop": lambda o: o.RMSProp(learning_rate=1e-3, momentum=0.9),
    "ftrl": lambda o: o.Ftrl(learning_rate=1e-2, l1=1e-3, l2=1e-3),
}


def _maker(name):
    return lambda pkg: OPTIMIZERS[name](pkg.optimizer)


def _skipped(name):
    return "_att_k.b" in name


CHECKPOINTED = ("adagrad", "ftrl")


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """``name`` -> the 3-step run of that optimizer in both packages from
    one state (``recipe_parity``); for ``CHECKPOINTED`` ones also the
    reference's persistables saved after step 2 and the port continuing
    from them."""
    cache = {}

    def get(name):
        if name not in cache:
            ckdir = (str(tmp_path_factory.mktemp(name))
                     if name in CHECKPOINTED else None)
            cache[name] = R.recipe_parity(_maker(name), ckdir=ckdir)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name, parity):
    make = _maker(name)
    jmain, _, _ = R.build(pt, make)
    tmain, _, _ = R.build(tpt, make)
    jvars = {v.name: (tuple(v.shape), v.dtype.name)
             for v in jmain.persistable_vars()}
    tvars = {v.name: (tuple(v.shape), v.dtype.name)
             for v in tmain.persistable_vars()}
    assert tvars == jvars
    r = parity(name)
    for a, b in zip(r["got"], r["ref"]):
        assert abs(a - b) <= R.FWD_TOL * abs(b)
    assert r["ref"][-1] < r["ref"][0]           # the recipe trains
    for n, want in r["ref_state"].items():
        if not _skipped(n):
            assert R.rel(r["got_state"][n], want) <= R.GRAD_TOL, n


@pytest.mark.parametrize("name", CHECKPOINTED)
def test_jax_checkpoint_resumes_in_the_port(name, parity):
    """The reference's persistables after step 2, saved by its ``io``, load
    into the port by name (the accumulators ``<param>_moment``,
    ``_squared``, ``_linear`` included, f32) and step 3 continues there
    within tolerance of the reference's step 3."""
    r = parity(name)
    resumed = r["resumed"]
    accs = resumed["accumulators"]
    assert accs and all(d == torch.float32 for d in accs.values())
    assert abs(resumed["loss"] - r["ref"][2]) <= R.FWD_TOL * abs(r["ref"][2])
    for n, want in r["ref_state"].items():
        if not _skipped(n):
            assert R.rel(resumed["state"][n], want) <= R.GRAD_TOL, n


# op name -> (extra state slots with their value kind, attrs)
OPS = {
    "sgd": ({}, {}),
    "adagrad": ({"Moment": "pos"}, {"epsilon": 1e-6}),
    "adamax": ({"Moment": "any", "InfNorm": "pos", "Beta1Pow": "pow"},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adadelta": ({"AvgSquaredGrad": "pos", "AvgSquaredUpdate": "pos"},
                 {"rho": 0.95, "epsilon": 1e-6}),
    "decayed_adagrad": ({"Moment": "pos"}, {"decay": 0.95, "epsilon": 1e-6}),
    "rmsprop": ({"MeanSquare": "pos", "Moment": "any"},
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9}),
    "ftrl": ({"SquaredAccumulator": "pos", "LinearAccumulator": "any"},
             {"l1": 1e-2, "l2": 1e-2, "lr_power": -0.5}),
    "proximal_gd": ({}, {"l1": 1e-2, "l2": 1e-2}),
    "proximal_adagrad": ({"Moment": "pos"}, {"l1": 1e-2, "l2": 1e-2}),
}
NO_LR = {"adadelta"}
# each output slot -> the input slot it writes in place
OUT_OF = {"ParamOut": "Param", "MomentOut": "Moment",
          "InfNormOut": "InfNorm", "AvgSquaredGradOut": "AvgSquaredGrad",
          "AvgSquaredUpdateOut": "AvgSquaredUpdate",
          "MeanSquareOut": "MeanSquare",
          "SquaredAccumOut": "SquaredAccumulator",
          "LinearAccumOut": "LinearAccumulator"}


def _op_inputs(name, seed):
    rng = np.random.default_rng(seed)
    shape = (7, 33)
    vals = {"Param": rng.standard_normal(shape).astype(np.float32),
            "Grad": rng.standard_normal(shape).astype(np.float32)}
    for slot, kind in OPS[name][0].items():
        if kind == "pow":
            vals[slot] = np.asarray([0.9 ** 3], np.float32)
        elif kind == "pos":
            vals[slot] = rng.uniform(0.1, 2.0, shape).astype(np.float32)
        else:
            vals[slot] = rng.standard_normal(shape).astype(np.float32)
    if name not in NO_LR:
        vals["LearningRate"] = np.asarray([0.05], np.float32)
    return vals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_reference(name, dtype):
    import jax.numpy as jnp

    vals = _op_inputs(name, 3)
    attrs = OPS[name][1]
    low = {"Param", "Grad"} if dtype == "bfloat16" else set()
    jin = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in low else v.dtype)
           for k, v in vals.items()}
    tin = {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k in low else torch.float32)
        for k, v in vals.items()}
    ptr = {k: t.data_ptr() for k, t in tin.items()}
    want = ref_op(name).fn(**jin, **attrs)
    got = port_op(name).fn(**tin, **attrs)
    assert "ParamOut" in got
    for slot, t in got.items():
        w = np.asarray(jnp.asarray(want[slot]).astype(jnp.float32))
        src = OUT_OF[slot]
        # written back in place, in the input's dtype
        assert t.data_ptr() == ptr[src] and t.dtype == tin[src].dtype
        tol = 2e-2 if t.dtype == torch.bfloat16 else R.FWD_TOL
        assert R.rel(t.float().numpy(), w) <= tol, slot


@pytest.fixture(scope="module")
def model_average():
    """Adam with ``ModelAverage(0.9)`` in both packages: 3 steps from one
    state, then one evaluation batch under ``apply()``."""
    make = lambda pkg: pkg.optimizer.Adam(learning_rate=1e-2)  # noqa: E731
    batches = R.feeds(11, 3)
    held_out = R.feeds(12, 1)[0]
    out = {}
    with R.no_tf32():
        jmain, jstart, jmodel = R.build(pt, make)
        jma = pt.optimizer.ModelAverage(0.9, main_program=jmain,
                                        startup_program=jstart)
        jscope = pt.Scope()
        jexe = pt.Executor(pt.CPUPlace())
        jexe.run(jstart, scope=jscope)
        init = {v.name: np.asarray(jscope.get(v.name))
                for v in jmain.persistable_vars()}
        R.run(pt, jexe, jmain, jmodel, jscope, batches)
        jtest = jmain.clone(for_test=True)
        with jma.apply(scope=jscope):
            out["ref_eval"] = float(np.asarray(jexe.run(
                jtest, feed=held_out, fetch_list=[jmodel["avg_cost"]],
                scope=jscope)[0]).ravel()[0])
        out["ref_ema"] = {e: np.asarray(jscope.get(e), np.float32)
                          for _, e in jma.pairs}

        tmain, tstart, tmodel = R.build(tpt, make)
        with tpt.scope_guard(tpt.Scope()):
            tma = tpt.optimizer.ModelAverage(0.9, main_program=tmain,
                                             startup_program=tstart)
        tscope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
        texe = tpt.Executor(tpt.CPUPlace())
        R.run(tpt, texe, tmain, tmodel, tscope, batches)
        before = {p: tscope.get(p) for p, _ in tma.pairs}
        copies = {p: t.clone() for p, t in before.items()}
        ema_before = {e: tscope.get(e).clone() for _, e in tma.pairs}
        ttest = tmain.clone(for_test=True)
        with tma.apply(scope=tscope):
            inside = {p: tscope.get(p) for p, _ in tma.pairs}
            out["port_eval"] = float(texe.run(
                ttest, feed=held_out, fetch_list=[tmodel["avg_cost"]],
                scope=tscope)[0].ravel()[0])
    out.update(port_ema={e: tscope.numpy(e) for _, e in tma.pairs},
               before=before, copies=copies, inside=inside,
               ema_before=ema_before, scope=tscope, pairs=tma.pairs,
               test_ops={op.type for op in ttest.global_block().ops},
               test_roles={op.role for op in ttest.global_block().ops})
    return out


def test_model_average_matches_reference(model_average):
    m = model_average
    assert set(m["port_ema"]) == set(m["ref_ema"])
    for e, want in m["ref_ema"].items():
        if not _skipped(e):
            assert R.rel(m["port_ema"][e], want) <= R.GRAD_TOL, e
    assert abs(m["port_eval"] - m["ref_eval"]) <= R.FWD_TOL * abs(
        m["ref_eval"])
    # the evaluation program runs no optimizer op and no average update
    assert "adam" not in m["test_ops"]
    assert m["test_roles"] == {"forward"}


def test_model_average_apply_restores_bit_for_bit(model_average):
    m = model_average
    scope = m["scope"]
    for p, e in m["pairs"]:
        assert scope.get(p) is m["before"][p]
        assert torch.equal(scope.get(p), m["copies"][p])
        assert torch.equal(scope.get(e), m["ema_before"][e])
        # inside the context the parameter was a copy of its average,
        # never the average's own tensor
        assert m["inside"][p].data_ptr() != scope.get(e).data_ptr()
        assert torch.equal(m["inside"][p], scope.get(e))


def test_model_average_needs_minimize_first():
    pt_main = tpt.Program()
    with pytest.raises(RuntimeError, match="AFTER"):
        tpt.optimizer.ModelAverage(0.9, main_program=pt_main,
                                   startup_program=tpt.Program())
