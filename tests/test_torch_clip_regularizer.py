"""The port's gradient clips, error clips and regularizers against the
JAX package's, on the CPU.

Four recipes of the 2-layer f32 GPT (``torch_recipes``) take 3 steps in
both packages from one state: losses within ORACLE_TOL f32's forward
bound (2e-4 relative), the fetched gradients (after every clip and
regularizer op) and every persistable after the steps within its
gradient bound (1e-3 of the tensor's largest magnitude), the
key-projection biases aside (their gradient is roundoff):

* ``value_l1``: ``GradientClipByValue`` on every parameter, the
  optimizer's ``L1Decay``, and ``L2Decay`` of the block-1 parameters'
  own (a parameter's regularizer wins);
* ``norm_l2``: ``GradientClipByNorm`` on every parameter, the
  optimizer's ``L2Decay``, and ``L1Decay`` on block 0's own;
* ``global``: ``GradientClipByGlobalNorm`` and ``L2Decay`` (the clip
  factor fetched each step, and below 1);
* ``error_clip``: after ``memory_optimize("selective")``, an
  ``ErrorClipByValue`` on each block's GELU output (one symmetric, one
  with its own ``min``), which must keep ``backward_index`` and the remat
  segments on the same ops.

Besides: clipping runs before regularization (the fetched gradient is
``clip(g) + coeff * p``), ``ParamAttr`` carries a parameter's clip and
regularizer into its ops, and each op these append (``sum``, ``sign``,
``clip``, ``clip_by_norm``, ``squared_l2_norm``, ``error_clip``) against
the reference op in f32 and bf16.
"""

import re

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op_impl as ref_op
from paddle_tpu_torch.core.registry import get_op_impl as port_op

import torch_recipes as R
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

CLIP_VALUE, L1, L2, LR = 2e-3, 1e-2, 5e-2, 0.5


def _params(pkg, prefix=""):
    return [p for p in pkg.default_main_program().all_parameters()
            if p.name.startswith(prefix)]


def _value_l1(pkg):
    for p in _params(pkg):
        p.gradient_clip_attr = pkg.clip.GradientClipByValue(CLIP_VALUE)
    for p in _params(pkg, "block1_"):
        p.regularizer = pkg.regularizer.L2Decay(L2)
    return pkg.optimizer.SGD(learning_rate=LR,
                             regularization=pkg.regularizer.L1Decay(L1))


def _norm_l2(pkg):
    for p in _params(pkg):
        p.gradient_clip_attr = pkg.clip.GradientClipByNorm(0.05)
    for p in _params(pkg, "block0_"):
        p.regularizer = pkg.regularizer.L1Decay(L1)
    return pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  regularization=pkg.regularizer.L2Decay(L2))


def _global(pkg):
    return pkg.optimizer.SGD(
        learning_rate=LR, regularization=pkg.regularizer.L2Decay(L2),
        global_clip=pkg.clip.GradientClipByGlobalNorm(0.1))


def _error_clips(pkg, main):
    """``selective`` remat, then an error clip at each block's GELU
    output: the program's markers shift with the inserted ops."""
    pkg.memory_optimize(main, policy="selective")
    block = main.global_block()
    gelus = [op.outputs["Out"][0] for op in block.ops[:block.backward_index]
             if op.type == "gelu"]
    attrs = [pkg.clip.ErrorClipByValue(1e-5),
             pkg.clip.ErrorClipByValue(2e-5, min=-1e-6)]
    for name, attr in zip(gelus, attrs):
        pkg.clip.error_clip_callback(block.var(name), attr)


RECIPES = {
    "value_l1": dict(make=_value_l1),
    "norm_l2": dict(make=_norm_l2),
    "global": dict(make=_global),
    "error_clip": dict(make=lambda pkg: pkg.optimizer.SGD(learning_rate=LR),
                       post=_error_clips),
}
WATCHED = ("block0_ffn1.w", "block1_att_q.w", "tok_emb.w", "lm_head.w")


def _fetches(main):
    """Watched gradients, and the global clip's factor where there is
    one."""
    names = [p + "@GRAD" for p in WATCHED]
    return names + sorted(n for n in main.global_block().vars
                          if re.search(r"\.factor(_\d+)?$", n))


@pytest.fixture(scope="module")
def recipes():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = R.recipe_parity(extra=_fetches, **RECIPES[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_matches_reference(name, recipes):
    r = recipes(name)
    for a, b in zip(r["got"], r["ref"]):
        assert abs(a - b) <= R.FWD_TOL * abs(b)
    for got, want in zip(r["got_extra"], r["ref_extra"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert R.rel(g, w) <= R.GRAD_TOL
    for n, want in r["ref_state"].items():
        if "_att_k.b" not in n:
            assert R.rel(r["got_state"][n], want) <= R.GRAD_TOL, n


def test_global_clip_factor(recipes):
    """The factor ``clip / max(norm, clip)`` is fetched each step (a
    ``[1]`` value in the gradients' dtype) and clips: below 1."""
    r = recipes("global")
    factors = [step[-1] for step in r["got_extra"]]
    assert all(f.shape == (1,) and 0 < float(f[0]) < 1 for f in factors)
    main = r["port"][0]
    types = [op.type for op in main.global_block().ops]
    n = len(main.all_parameters())
    assert types.count("squared_l2_norm") == n
    assert types.count("elementwise_mul") >= n


def test_error_clip_keeps_markers_and_clips(recipes):
    r = recipes("error_clip")
    main = r["port"][0]
    block = main.global_block()
    types = [op.type for op in block.ops]
    assert types.count("error_clip") == 2
    assert max(i for i, t in enumerate(types) if t == "error_clip") \
        < block.backward_index
    assert types[block.backward_index - 1] != "error_clip"
    segs = main._remat_segments
    assert segs[-1][1] == block.backward_index
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    # the clipped errors change the gradients of everything before them
    main, model, exe, scope = R.port_start(RECIPES["error_clip"]["make"],
                                           r["init"])
    name = WATCHED[0] + "@GRAD"
    g_plain = R.run(tpt, exe, main, model, scope, R.feeds(0, 1), [name])
    g_clip = r["got_extra"][0][0]                  # the same batch
    assert R.rel(g_clip, g_plain[0][1]) > 1e-2


def test_clip_runs_before_regularization(recipes):
    """``value_l1``'s fetched gradient of a block-1 parameter is
    ``clip(g) + L2 * p``, not ``clip(g + L2 * p)``: the clip's output is
    within ``CLIP_VALUE``, the regularized one leaves it."""
    r = recipes("value_l1")
    main, model, exe, _ = r["port"]
    name = "block1_att_q.w"
    block = main.global_block()
    ops = block.ops[block.backward_index:]
    clip_at = max(i for i, op in enumerate(ops) if op.type == "clip")
    assert all(i > clip_at for i, op in enumerate(ops)
               if op.type in ("sign", "sum"))
    scope = tpt.load_numpy_state(tpt.Scope(), r["init"], device="cpu")
    p0 = scope.get(name).clone()
    batch = R.feeds(0, 1)
    raw_main, _, raw_model = R.build(tpt, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.0))
    raw_scope = tpt.load_numpy_state(tpt.Scope(), r["init"], device="cpu")
    raw = R.run(tpt, exe, raw_main, raw_model, raw_scope, batch,
                [name + "@GRAD"])[0][1]
    got = R.run(tpt, exe, main, model, scope, batch, [name + "@GRAD"])[0][1]
    want = np.clip(raw, -CLIP_VALUE, CLIP_VALUE) + L2 * p0.numpy()
    assert R.rel(got, want) <= R.FWD_TOL
    assert np.abs(got).max() > CLIP_VALUE


def test_param_attr_carries_clip_and_regularizer():
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[6], dtype="float32")
        h = tpt.layers.fc(x, 5, param_attr=tpt.ParamAttr(
            regularizer=tpt.regularizer.L1Decay(0.1),
            gradient_clip=tpt.clip.GradientClipByValue(0.01)))
        y = tpt.layers.fc(h, 3, param_attr=tpt.ParamAttr(
            gradient_clip=tpt.clip.GradientClipByNorm(0.5)))
        cost = tpt.layers.mean(y)
        tpt.optimizer.SGD(learning_rate=0.1,
                          regularization=tpt.regularizer.L2Decay(0.2)
                          ).minimize(cost)
    ps = {p.name: p for p in main.all_parameters()}
    w0 = next(p for n, p in ps.items() if n.endswith(".w") and p.shape[0] == 6)
    assert isinstance(w0.regularizer, tpt.regularizer.L1Decay)
    assert isinstance(w0.gradient_clip_attr, tpt.clip.GradientClipByValue)
    block = main.global_block()
    tail = block.ops[block.backward_index:]
    types = [op.type for op in tail]
    assert types.count("clip") == 1 and types.count("clip_by_norm") == 1
    assert types.count("sign") == 1                  # w0's own L1
    assert types.count("scale") == len(ps)           # L1's and 3 L2s
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.get(w0.name).clone()
    exe.run(main, feed={"x": np.ones((4, 6), np.float32)}, scope=scope)
    step = before - scope.get(w0.name)
    # |g| <= 0.01 after the clip, then + 0.1 * sign(w): one SGD step
    assert float(step.abs().max()) <= 0.1 * (0.01 + 0.1) + 1e-7


def _op_case(name, dtype, rng):
    x = rng.standard_normal((5, 17)).astype(np.float32)
    if name == "sum":
        xs = [rng.standard_normal((1,)).astype(np.float32) for _ in range(9)]
        return {"X": xs}, {}
    if name == "clip":
        return {"X": x}, {"min": -0.3, "max": 0.5}
    if name == "clip_by_norm":
        return {"X": x}, {"max_norm": 1.0}
    if name == "clip_by_norm_short":
        return {"X": x * 1e-2}, {"max_norm": 5.0}
    return {"X": x}, {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sum", "sign", "clip", "clip_by_norm",
                                  "clip_by_norm_short", "squared_l2_norm"])
def test_op_matches_reference(name, dtype):
    import jax.numpy as jnp

    ins, attrs = _op_case(name, dtype, np.random.default_rng(5))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)

    def j(v):
        return [jnp.asarray(a).astype(jd) for a in v] if isinstance(
            v, list) else jnp.asarray(v).astype(jd)

    def t(v):
        return [torch.from_numpy(a).to(td) for a in v] if isinstance(
            v, list) else torch.from_numpy(v).to(td)

    op = name.replace("_short", "")
    want = ref_op(op).fn(**{k: j(v) for k, v in ins.items()}, **attrs)["Out"]
    got = port_op(op).fn(**{k: t(v) for k, v in ins.items()}, **attrs)["Out"]
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    tol = 2e-2 if dtype == "bfloat16" else R.FWD_TOL
    assert R.rel(got.float().numpy(),
                 np.asarray(want.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("bounds", [{"max": 0.2}, {"max": 0.3, "min": -0.05}])
def test_error_clip_op_gradient_matches_reference(bounds):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    ct = rng.standard_normal((4, 9)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: ref_op("error_clip").fn(X=a, **bounds)[
        "Out"], jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = port_op("error_clip").fn(X=xt, **bounds)["Out"]
    assert torch.equal(yt.detach(), xt.detach())
    yt.backward(torch.from_numpy(ct))
    assert np.array_equal(xt.grad.numpy(), want)
