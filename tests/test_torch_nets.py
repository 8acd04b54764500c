"""``nets.glu``, the composed path of ``nets.scaled_dot_product_attention``
(``use_fused=False``, and with attention dropout) and
``nets.dot_product_attention`` in the port against ``paddle_tpu.nets``
on the CPU (the reference's ``tests/test_nets.py`` checks the last
against numpy).

Each net sits between fc projections (the parameters) and a mean
square loss under SGD.  Both packages build the same program; from the
reference's startup state, one step's output of the net within
ORACLE_TOL f32's forward bound (2e-4 of the largest) and every
parameter's gradient within the gradient bound (1e-3 of the largest).
The key projection's bias has a zero gradient analytically (it shifts
every logit of a row alike, which the softmax ignores): both sides hold
it to roundoff, under 1e-5 of the step's largest gradient.  With
dropout the two packages draw different masks, so that case holds the
programs and the shapes only.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3
B, TQ, TK, D = 3, 5, 7, 8


def _net(pkg, name):
    """The program around net ``name``: ``(main, startup, out, loss)``."""
    layers, nets = pkg.layers, pkg.nets
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        q_in = layers.data("q", shape=[TQ, D])
        kv_in = layers.data("kv", shape=[TK, D])
        if name == "glu":
            h = layers.fc(q_in, 2 * D, num_flatten_dims=2)
            out = nets.glu(h, dim=-1)
        else:
            q = layers.fc(q_in, D, num_flatten_dims=2)
            k = layers.fc(kv_in, D, num_flatten_dims=2)
            v = layers.fc(kv_in, D, num_flatten_dims=2)
            if name == "dot_product_attention":
                out = nets.dot_product_attention(q, k, v)
            else:
                out = nets.scaled_dot_product_attention(
                    q, k, v, num_heads=2, use_fused=False,
                    dropout_rate=0.3 if name.endswith("dropout") else 0.0)
        loss = layers.mean(layers.square(out))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, out, loss


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, v.lod_level)
                 for v in program.list_vars()]
    return ops, variables


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


NETS = ["glu", "scaled_dot_product_attention",
        "scaled_dot_product_attention_dropout", "dot_product_attention"]


@pytest.mark.parametrize("name", NETS)
def test_net_matches_the_reference(name):
    jmain, jstart, jout, jloss = _net(pt, name)
    tmain, tstart, tout, tloss = _net(tpt, name)
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(jstart, scope=scope)
    init = {v.name: np.asarray(scope.get(v.name))
            for v in jmain.persistable_vars()
            if scope.find_var(v.name) is not None}
    rng = np.random.default_rng(sum(map(ord, name)))
    feed = {"q": rng.normal(size=(B, TQ, D)).astype(np.float32),
            "kv": rng.normal(size=(B, TK, D)).astype(np.float32)}
    params = [p.name for p in jmain.all_parameters()]
    fetch = [jout.name] + [p + "@GRAD" for p in params]
    want = exe.run(jmain, feed=feed, fetch_list=fetch, scope=scope)
    got = tpt.Executor(tpt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch,
        scope=tpt.load_numpy_state(tpt.Scope(), init, device="cpu"))
    assert np.asarray(got[0]).shape == np.asarray(want[0]).shape == (
        B, TQ, D)
    if name.endswith("dropout"):
        assert np.isfinite(np.asarray(got[0])).all()
        return
    assert _rel(got[0], want[0]) <= FWD_TOL
    top = max(np.abs(np.asarray(w)).max() for w in want[1:])
    dead = "fc_1.b" if name != "glu" else None     # the key bias
    for p, g, w in zip(params, got[1:], want[1:]):
        if p == dead:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * top, p
            continue
        assert _rel(g, w) <= GRAD_TOL, (p, _rel(g, w))


def test_composed_attention_agrees_with_the_fused_path():
    """Without dropout the composed and the flash paths compute the same
    attention (the port's CPU flash op is its plain version)."""
    outs = []
    for fused in (True, False):
        tpt.core.unique_name.reset()
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup):
            q = tpt.layers.data("q", shape=[TQ, D])
            kv = tpt.layers.data("kv", shape=[TK, D])
            out = tpt.nets.scaled_dot_product_attention(
                q, kv, kv, num_heads=2, use_fused=fused)
        rng = np.random.default_rng(4)
        feed = {"q": rng.normal(size=(B, TQ, D)).astype(np.float32),
                "kv": rng.normal(size=(B, TK, D)).astype(np.float32)}
        exe = tpt.Executor(tpt.CPUPlace())
        scope = tpt.Scope()
        exe.run(startup, scope=scope)
        outs.append(exe.run(main, feed=feed, fetch_list=[out],
                            scope=scope)[0])
    assert _rel(outs[1], outs[0]) <= FWD_TOL
