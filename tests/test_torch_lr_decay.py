"""The port's learning-rate schedules against the JAX package's, on the
CPU.

One program of the 2-layer f32 GPT (``torch_recipes``) carries all four
schedules, ``exponential_decay``, ``natural_exp_decay`` and
``inverse_time_decay`` with staircase off and on and
``polynomial_decay`` at powers 1 and 2, and trains with SGD on one of
them.  Over 5 steps from one state each schedule's fetched rate matches
the reference's within ORACLE_TOL f32 (2e-4) and its closed form at
``step = 1, 2, ...`` (the counter advances before the rate is read);
the step counters (the reference's ``<schedule>_<n>.step`` names) equal
the steps taken.

The counter advances once a training step: under
``gradient_accumulation(2)`` (the port keeps a schedule's state at the
step's value for every microbatch; the reference's accumulation advances
it once per microbatch, ROADMAP.md C) and under every remat policy (a
recompute does not advance it), the rates are the plain run's bits.
``clone(for_test=True)`` drops the ``increment``, and a checkpoint of
the reference carries the counters into the port.
"""

import math
import re

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt

import torch_recipes as R

STEPS, LR0 = 5, 0.05
SCHEDULES = {
    "exponential": ("exponential_decay", dict(decay_steps=2, decay_rate=0.5),
                    lambda k: LR0 * 0.5 ** (k / 2)),
    "exponential_stair": ("exponential_decay",
                          dict(decay_steps=2, decay_rate=0.5, staircase=True),
                          lambda k: LR0 * 0.5 ** math.floor(k / 2)),
    "natural_exp": ("natural_exp_decay", dict(decay_steps=2, decay_rate=0.3),
                    lambda k: LR0 * math.exp(-0.3 * k / 2)),
    "natural_exp_stair": ("natural_exp_decay",
                          dict(decay_steps=2, decay_rate=0.3, staircase=True),
                          lambda k: LR0 * math.exp(-0.3 * math.floor(k / 2))),
    "inverse_time": ("inverse_time_decay", dict(decay_steps=2, decay_rate=0.5),
                     lambda k: LR0 / (1 + 0.5 * k / 2)),
    "inverse_time_stair": ("inverse_time_decay",
                           dict(decay_steps=2, decay_rate=0.5,
                                staircase=True),
                           lambda k: LR0 / (1 + math.floor(0.5 * k / 2))),
    "polynomial": ("polynomial_decay",
                   dict(decay_steps=4, end_learning_rate=0.005),
                   lambda k: (LR0 - 0.005) * (1 - min(k, 4) / 4) + 0.005),
    "polynomial_pow2": ("polynomial_decay",
                        dict(decay_steps=4, end_learning_rate=0.005,
                             power=2.0),
                        lambda k: (LR0 - 0.005) * (1 - min(k, 4) / 4) ** 2
                        + 0.005),
}
NAMES = sorted(SCHEDULES)
TRAINS_ON = "polynomial"


def _make(pkg):
    """Every schedule in ``NAMES`` order; SGD on ``TRAINS_ON``'s rate."""
    lrs = {}
    for name in NAMES:
        fn, kw, _ = SCHEDULES[name]
        lrs[name] = getattr(pkg.learning_rate_decay, fn)(LR0, **kw)
    return pkg.optimizer.SGD(learning_rate=lrs[TRAINS_ON])


def _lr_fetches(main):
    """Each schedule's rate: the last var its chain writes (the helper
    names the chain's vars ``<schedule>_<n>.tmp_<k>``), in the order the
    program builds them (``NAMES``)."""
    block = main.global_block()
    last = {}
    for op in block.ops[:block.backward_index]:
        for n in op.output_names():
            m = re.match(r"(\w+_decay_\d+)\.tmp", n)
            if m:
                last[m.group(1)] = n
    return list(last.values())


def _counters(main):
    return sorted(v.name for v in main.persistable_vars()
                  if v.name.endswith(".step"))


def _port_run(init, post=None, steps=STEPS, batches=None):
    main, model, exe, scope = R.port_start(_make, init, post)
    fetch = _lr_fetches(main)
    out = R.run(tpt, exe, main, model, scope,
                batches or R.feeds(0, steps), fetch)
    return main, model, exe, scope, out


@pytest.fixture(scope="module")
def schedules(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("lr_ck"))
    with R.no_tf32():
        jmain, jmodel, jexe, jscope, init = R.ref_start(_make)
        jfetch = _lr_fetches(jmain)
        batches = R.feeds(0, STEPS)
        ref = R.run(pt, jexe, jmain, jmodel, jscope, batches[:2], jfetch)
        with pt.core.scope.scope_guard(jscope):
            pt.io.save_persistables(jexe, ck, jmain)
        ref += R.run(pt, jexe, jmain, jmodel, jscope, batches[2:], jfetch)
        port = _port_run(init)
    return {"ref": ref, "ref_counters": {n: float(np.asarray(jscope.get(n))[0])
                                         for n in _counters(jmain)},
            "jfetch": jfetch, "init": init, "port": port, "ck": ck,
            "batches": batches}


def _rates(out, i):
    """Schedule ``i``'s rate at each step of a run."""
    return [float(step[1 + i][0]) for step in out]


@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_reference(name, schedules):
    i = NAMES.index(name)
    main, _, _, scope, out = schedules["port"]
    assert _lr_fetches(main) == schedules["jfetch"]
    got, want = _rates(out, i), _rates(schedules["ref"], i)
    closed = [SCHEDULES[name][2](k) for k in range(1, STEPS + 1)]
    for g, w, c in zip(got, want, closed):
        assert abs(g - w) <= R.FWD_TOL * abs(w)
        assert abs(g - c) <= 1e-6 * abs(c)
    counter = _counters(main)[i]
    assert counter == sorted(schedules["ref_counters"])[i]
    assert float(scope.get(counter)[0]) == STEPS
    if name == TRAINS_ON:
        for a, b in zip(out, schedules["ref"]):
            assert abs(float(a[0][0]) - float(b[0][0])) <= R.FWD_TOL * abs(
                float(b[0][0]))


def _accum(pkg, main):
    pkg.gradient_accumulation(main, 2)


def _remat(policy):
    return lambda pkg, main: pkg.memory_optimize(main, policy=policy)


@pytest.mark.parametrize("variant", ["accum2", "full", "selective",
                                     "compact", "offload", "accum2_full"])
def test_counter_advances_once_a_step(variant, schedules):
    post = {"accum2": _accum, "full": _remat("full"),
            "selective": _remat("selective"), "compact": _remat("compact"),
            "offload": _remat("offload"),
            "accum2_full": lambda pkg, m: (_remat("full")(pkg, m),
                                           _accum(pkg, m))}[variant]
    main, _, _, scope, out = _port_run(schedules["init"], post)
    plain = schedules["port"][4]
    for i in range(len(NAMES)):
        assert _rates(out, i) == _rates(plain, i)
    for n in _counters(main):
        assert float(scope.get(n)[0]) == STEPS
    for a, b in zip(out, plain):
        assert abs(float(a[0][0]) - float(b[0][0])) <= R.FWD_TOL * abs(
            float(b[0][0]))


def test_clone_for_test_leaves_the_counter(schedules):
    main, model, exe, scope, _ = schedules["port"]
    test = main.clone(for_test=True)
    assert "increment" not in {op.type for op in test.global_block().ops}
    before = {n: scope.get(n).clone() for n in _counters(main)}
    for _ in range(2):
        exe.run(test, feed=schedules["batches"][0],
                fetch_list=[model["avg_cost"]], scope=scope)
    for n, v in before.items():
        assert float(scope.get(n)[0]) == float(v[0]) == STEPS


def test_counter_crosses_a_reference_checkpoint(schedules):
    """The reference's persistables after 2 steps load into the port by
    name; its 3 more steps read the rates the reference read."""
    main, model, exe, _, _ = schedules["port"]
    scope = tpt.Scope()
    with tpt.scope_guard(scope):
        tpt.io.load_persistables(exe, schedules["ck"], main)
    for n in _counters(main):
        assert float(scope.get(n)[0]) == 2.0
    out = R.run(tpt, exe, main, model, scope, schedules["batches"][2:],
                _lr_fetches(main))
    for i in range(len(NAMES)):
        for g, w in zip(_rates(out, i), _rates(schedules["ref"][2:], i)):
            assert abs(g - w) <= R.FWD_TOL * abs(w)
