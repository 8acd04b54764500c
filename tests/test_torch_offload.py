"""The memory engine's ``offload`` policy in the port, on the CPU.

``memory_optimize(policy="offload")`` segments exactly as ``selective``
and marks the program; the Executor then moves each layer's block input
(what a repeat of the layer group reads from the one before: the
residual stream and its first layer norm) out of the
device between the forward and the backward.  On CPU tensors the same
structure runs with the inputs kept in place (mode ``"save"``, as the
reference runs on a backend without pinned host memory), so everything
here holds the offload path to ``selective``'s bits: losses, every
gradient at step 1 and every parameter after 3 Adam steps of the
2-layer GPT (``torch_recipes``), with the fused and the unfused head and
under ``gradient_accumulation(2)``.  ``Executor.last_remat_plan``
records the mode and the block inputs the hooks caught (each repeat's
carry once a forward); ``PADDLE_TPU_OFFLOAD=0`` runs plain ``selective`` (mode
``"off"``); the reference's own ``offload`` program gives the port's
losses within ORACLE_TOL f32.  On the card the mode is ``"host"``
(``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt

import torch_recipes as R

STEPS = 3


def _adam(pkg):
    return pkg.optimizer.Adam(learning_rate=1e-2)


def _policy(policy, accum=1):
    def post(pkg, main):
        pkg.memory_optimize(main, policy=policy)
        if accum > 1:
            pkg.gradient_accumulation(main, accum)
    return post


@pytest.fixture(scope="module")
def init():
    return R.ref_start(_adam)[4]


def _port(init, policy, accum=1, **over):
    """3 steps of ``policy``: losses, step-1 gradients, parameters after,
    and the executor's plan after each step."""
    main, model, exe, scope = R.port_start(_adam, init,
                                           _policy(policy, accum), **over)
    params = [p.name for p in main.all_parameters()]
    grads, losses, plans = None, [], []
    for i, feed in enumerate(R.feeds(4, STEPS)):
        outs = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                       fetch_list=[model["avg_cost"]]
                       + [p + "@GRAD" for p in params])
        losses.append(outs[0])
        if i == 0:
            grads = outs[1:]
        plans.append(exe.last_remat_plan)
    return {"losses": losses, "grads": grads, "plans": plans,
            "params": {p: scope.get(p) for p in params}}


def _bit_equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
    assert all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))
    assert all(torch.equal(a["params"][n], b["params"][n])
               for n in a["params"])


@pytest.mark.parametrize("case", ["unfused", "fused", "accum2"])
def test_offload_bit_equal_to_selective(case, init):
    over = {"fused_head": True} if case == "fused" else {}
    accum = 2 if case == "accum2" else 1
    if over:
        init = R.ref_start(_adam, **over)[4]
    sel = _port(init, "selective", accum, **over)
    off = _port(init, "offload", accum, **over)
    _bit_equal(off, sel)
    for plan in off["plans"]:
        assert plan["policy"] == "offload" and plan["offload"] == "save"
        # every repeat's carry, each caught by the hooks once a forward
        (group,) = plan["groups"]
        assert plan["offloaded"] == len(group["carry"]) * group[
            "count"] * accum
        assert plan["offloaded_bytes"] == 0          # nothing left the CPU
    assert sel["plans"][0]["offload"] == "off"
    assert sel["plans"][0]["offloaded"] == 0


def test_plan_names_the_layer_group(init):
    """The uniform group is the 2 layers; its period starts after block
    0's first layer norm, so a repeat carries two ``[b, t, d]`` values
    from the one before: the residual stream and its layer norm."""
    off = _port(init, "offload")
    plan = off["plans"][-1]
    (group,) = plan["groups"]
    assert group["count"] == R.CFG["n_layer"]
    assert sorted(group["carry"]) == ["block0_ln1.tmp_0", "cast_1.tmp_0"]
    assert plan["offloaded"] == 2 * R.CFG["n_layer"]


@pytest.mark.parametrize("value", ["0", "false"])
def test_kill_switch_runs_selective(value, init, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_OFFLOAD", value)
    killed = _port(init, "offload")
    monkeypatch.delenv("PADDLE_TPU_OFFLOAD")
    sel = _port(init, "selective")
    _bit_equal(killed, sel)
    assert all(p["offload"] == "off" and p["offloaded"] == 0
               for p in killed["plans"])


def test_offload_segments_as_selective():
    segs = {}
    for policy in ("selective", "offload"):
        main, _, _ = R.build(tpt, _adam)
        segs[policy] = tpt.memory_optimize(main, policy=policy)
        assert main._offload == (policy == "offload")
        assert main._remat_policy == policy
    assert segs["offload"] == segs["selective"] and segs["offload"]


def test_auto_raises_naming_the_tune_cache():
    main, _, _ = R.build(tpt, _adam)
    with pytest.raises(NotImplementedError, match="A5"):
        tpt.memory_optimize(main, policy="auto")


def test_offload_matches_the_reference_offload(init):
    """The reference's ``offload`` program (its scan engine) against the
    port's: the same layer group and carry, and 3 losses."""
    with R.no_tf32():
        jmain, jmodel, jexe, jscope, _ = R.ref_start(
            _adam, _policy("offload"))
        ref = R.run(pt, jexe, jmain, jmodel, jscope, R.feeds(4, STEPS))
    port = _port(init, "offload")
    (jgroup,) = jexe.last_remat_plan
    (tgroup,) = port["plans"][-1]["groups"]
    assert jgroup["offload"] != "off"
    assert {k: jgroup[k] for k in tgroup} == tgroup
    for a, b in zip(port["losses"], ref):
        assert abs(float(a[0]) - float(b[0][0])) <= R.FWD_TOL * abs(
            float(b[0][0]))
