"""The port's ResNet slice against the JAX package's, on the CPU.

* Every op ``models.resnet.build`` emits, one at a time, on the same
  seeded numpy inputs as the JAX op function: ``conv2d`` (stride,
  padding, dilation, groups), ``pool2d`` (max, average exclusive and not,
  global, ``ceil_mode``), ``batch_norm`` (forward, backward and running
  statistics, training and ``is_test``), ``relu``, ``softmax``,
  ``cross_entropy`` (hard and soft labels), ``mean``, ``top_k`` (ties),
  ``accuracy``, ``momentum`` (with and without Nesterov) and
  ``gaussian_random``.  f32 within ORACLE_TOL's f32 bounds (2e-4 of the
  output's largest magnitude forward, 1e-3 for gradients).
* ``resnet.build`` gives the same main and startup programs in both
  packages, for the CIFAR net and ResNet-50.
* Training, with the reference's startup state imported through
  ``load_numpy_state`` (BN running statistics and Momentum velocities
  included), at lr 1e-3 (at the default 0.1 ``cross_entropy``'s 1e-20
  clamp makes neither package's gradient meaningful):
  - ``resnet_cifar10`` depth 8 at 16x16, f32, three Momentum steps:
    loss, accuracy, step-1 gradients, and parameters, velocities and BN
    running statistics after the third step, all within ORACLE_TOL;
  - ``build(depth=50, class_dim=10, image_shape=(3, 32, 32))``, f32, one
    step.  ResNet-50 at random init is chaotic in f32: a one-ulp change
    of every weight moves the reference's own loss by 6.5e-4 and its
    step-1 gradients by up to 31% of a parameter's largest entry.  So the
    reference runs twice, from its state and from every weight moved one
    ulp up, and each quantity is held to ORACLE_TOL or to twice that
    one-ulp spread of the reference, whichever is larger.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu.models import resnet as jrn
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from paddle_tpu_torch.models import resnet as trn
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    same = got == want                  # equal infinities count as equal
    diff = np.where(same, 0.0, np.abs(got - np.where(same, 0.0, want)))
    finite = np.abs(want[np.isfinite(want)])
    return float(diff.max() / max(float(finite.max(initial=0.0)), 1e-30))


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- ops, one at a time -------------------------------------------------------

@pytest.mark.parametrize("attrs,cin,k", [
    (dict(strides=[1, 1], paddings=[0, 0]), 4, 1),
    (dict(strides=[2, 2], paddings=[3, 3]), 3, 7),
    (dict(strides=[1, 2], paddings=[1, 0], dilations=[2, 1]), 4, 3),
    (dict(strides=[1, 1], paddings=[1, 1], groups=2), 4, 3),
], ids=["1x1", "7x7_s2_p3", "dilated_mixed", "groups2"])
def test_conv2d_op(attrs, cin, k):
    rng = _rng(1)
    x = rng.standard_normal((2, cin, 9, 10)).astype(np.float32)
    w = rng.standard_normal((6, cin // attrs.get("groups", 1), k, k)
                            ).astype(np.float32)
    want = jax_op("conv2d").fn(Input=jnp.asarray(x), Filter=jnp.asarray(w),
                               **attrs)["Output"]
    got = torch_op("conv2d").fn(Input=torch.tensor(x), Filter=torch.tensor(w),
                                **attrs)["Output"]
    assert got.dtype == torch.float32
    assert _rel(got, want) <= FWD_TOL


def test_conv2d_casts_the_filter_to_the_input_dtype():
    rng = _rng(2)
    x = torch.tensor(rng.standard_normal((1, 2, 5, 5)), dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((3, 2, 3, 3)), dtype=torch.float32)
    out = torch_op("conv2d").fn(Input=x, Filter=w, paddings=[1, 1])["Output"]
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 5, 5)


POOLS = {
    "max_3x3_s2_p1": dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                          pooling_type="max"),
    "max_ceil": dict(ksize=[3, 3], strides=[2, 2], paddings=[0, 0],
                     pooling_type="max", ceil_mode=True),
    "max_ceil_padded": dict(ksize=[2, 2], strides=[2, 2], paddings=[1, 1],
                            pooling_type="max", ceil_mode=True),
    "avg_exclusive": dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                          pooling_type="avg"),
    "avg_inclusive": dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                          pooling_type="avg", exclusive=False),
    "avg_ceil_exclusive": dict(ksize=[3, 3], strides=[2, 2],
                               paddings=[1, 1], pooling_type="avg",
                               ceil_mode=True),
    "avg_ceil_inclusive": dict(ksize=[2, 2], strides=[3, 3],
                               paddings=[0, 0], pooling_type="avg",
                               ceil_mode=True, exclusive=False),
    "avg_global": dict(pooling_type="avg", global_pooling=True),
    "max_global": dict(pooling_type="max", global_pooling=True),
}


@pytest.mark.parametrize("name", list(POOLS))
def test_pool2d_op_forward_and_gradient(name):
    attrs = POOLS[name]
    x = _rng(3).standard_normal((2, 3, 8, 9)).astype(np.float32)
    dy_shape = np.asarray(jax_op("pool2d").fn(X=jnp.asarray(x), **attrs)
                          ["Out"]).shape
    dy = _rng(4).standard_normal(dy_shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_op("pool2d").fn(X=a, **attrs)["Out"],
                        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = torch_op("pool2d").fn(X=xt, **attrs)["Out"]
    assert _rel(got, want) <= FWD_TOL
    got.backward(torch.tensor(dy))
    assert _rel(xt.grad, vjp(jnp.asarray(dy))[0]) <= GRAD_TOL


def _bn_inputs(seed, shape=(4, 5, 6, 7)):
    rng = _rng(seed)
    c = shape[1]
    return dict(
        X=(rng.standard_normal(shape) * 3 + 2).astype(np.float32),
        Scale=(1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        Bias=(0.3 * rng.standard_normal(c)).astype(np.float32),
        Mean=(0.5 * rng.standard_normal(c)).astype(np.float32),
        Variance=(1 + rng.random(c)).astype(np.float32))


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "is_test"])
def test_batch_norm_op_forward_backward_and_running_statistics(is_test):
    ins = _bn_inputs(5)
    attrs = dict(momentum=0.9, epsilon=1e-5, is_test=is_test)
    dy = _rng(6).standard_normal(ins["X"].shape).astype(np.float32)
    fixed = {k: jnp.asarray(ins[k]) for k in ("Mean", "Variance")}

    def jfn(x, s, b):
        return jax_op("batch_norm").fn(X=x, Scale=s, Bias=b, **fixed,
                                       **attrs)

    want = jfn(*(jnp.asarray(ins[k]) for k in ("X", "Scale", "Bias")))
    _, vjp = jax.vjp(lambda x, s, b: jfn(x, s, b)["Y"],
                     *(jnp.asarray(ins[k]) for k in ("X", "Scale", "Bias")))
    want_grads = vjp(jnp.asarray(dy))

    leaves = {k: torch.tensor(ins[k], requires_grad=k in ("X", "Scale",
                                                           "Bias"))
              for k in ins}
    got = torch_op("batch_norm").fn(**leaves, **attrs)
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedMean",
                 "SavedVariance"):
        assert _rel(got[slot], want[slot]) <= FWD_TOL, slot
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert not got[slot].requires_grad, slot
    if is_test:
        assert got["MeanOut"] is leaves["Mean"]
    else:
        # the running statistics are new tensors: the inputs stay as they
        # were, so a recompute cannot blend twice
        assert np.array_equal(leaves["Mean"].detach().numpy(), ins["Mean"])
    got["Y"].backward(torch.tensor(dy))
    for k, g in zip(("X", "Scale", "Bias"), want_grads):
        assert _rel(leaves[k].grad, g) <= GRAD_TOL, k


def test_batch_norm_saves_the_references_residuals():
    """The backward keeps ``(X, Scale, mean, inv)`` — nothing of the size
    of X but X itself."""
    ins = _bn_inputs(7, (2, 3, 4, 4))
    saved = []
    leaves = {k: torch.tensor(v, requires_grad=k in ("X", "Scale", "Bias"))
              for k, v in ins.items()}
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        torch_op("batch_norm").fn(**leaves)
    assert sorted(saved) == sorted([(2, 3, 4, 4), (3,), (3,), (3,)])


@pytest.mark.parametrize("op", ["relu", "softmax"])
def test_activation_ops(op):
    x = _rng(8).standard_normal((4, 11)).astype(np.float32)
    x[0, :3] = 0.0
    dy = _rng(9).standard_normal((4, 11)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_op(op).fn(X=a)["Out"], jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = torch_op(op).fn(X=xt)["Out"]
    assert _rel(got, want) <= FWD_TOL
    got.backward(torch.tensor(dy))
    assert _rel(xt.grad, vjp(jnp.asarray(dy))[0]) <= GRAD_TOL


@pytest.mark.parametrize("soft_label", [False, True], ids=["hard", "soft"])
def test_cross_entropy_op(soft_label):
    rng = _rng(10)
    p = np.array(jax.nn.softmax(rng.standard_normal((6, 7)) * 3, -1),
                 np.float32)
    p[0, 2] = 0.0                               # the 1e-20 clamp
    if soft_label:
        label = rng.random((6, 7)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
        label_t = torch.tensor(label)
    else:
        label = rng.integers(0, 7, (6, 1)).astype(np.int64)
        label[0, 0] = 2
        label_t = torch.tensor(label)
    want, vjp = jax.vjp(
        lambda a: jax_op("cross_entropy").fn(
            X=a, Label=jnp.asarray(label), soft_label=soft_label)["Y"],
        jnp.asarray(p))
    pt_ = torch.tensor(p, requires_grad=True)
    got = torch_op("cross_entropy").fn(X=pt_, Label=label_t,
                                       soft_label=soft_label)["Y"]
    assert got.shape == (6, 1)
    assert _rel(got, want) <= FWD_TOL
    dy = np.ones((6, 1), np.float32)
    got.backward(torch.tensor(dy))
    assert _rel(pt_.grad, vjp(jnp.asarray(dy))[0]) <= GRAD_TOL


def test_mean_op():
    x = _rng(11).standard_normal((3, 4, 5)).astype(np.float32)
    want = jax_op("mean").fn(X=jnp.asarray(x))["Out"]
    got = torch_op("mean").fn(X=torch.tensor(x))["Out"]
    assert got.shape == (1,) and _rel(got, want) <= FWD_TOL


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[0.5, 0.9, 0.9, 0.1, 0.9, 0.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [0.2, 0.7, 0.2, 0.7, 0.7, 0.1]], np.float32)
    for k in (1, 3, 6):
        want = jax_op("top_k").fn(X=jnp.asarray(x), k=k)
        got = torch_op("top_k").fn(X=torch.tensor(x), k=k)
        assert got["Indices"].dtype == torch.int32
        assert np.array_equal(got["Indices"].numpy(),
                              np.asarray(want["Indices"])), k
        assert np.array_equal(got["Out"].numpy(), np.asarray(want["Out"]))
    bf = torch.tensor(x).to(torch.bfloat16)
    want = jax_op("top_k").fn(X=jnp.asarray(x, jnp.bfloat16), k=4)
    got = torch_op("top_k").fn(X=bf, k=4)
    assert np.array_equal(got["Indices"].numpy(), np.asarray(want["Indices"]))


def test_accuracy_op():
    rng = _rng(12)
    idx = rng.integers(0, 5, (8, 2)).astype(np.int32)
    label = rng.integers(0, 5, (8, 1)).astype(np.int64)
    label[0, 0] = idx[0, 1]
    want = jax_op("accuracy").fn(Out=None, Indices=jnp.asarray(idx),
                                 Label=jnp.asarray(label))
    got = torch_op("accuracy").fn(Out=None, Indices=torch.tensor(idx),
                                  Label=torch.tensor(label))
    for slot in ("Accuracy", "Correct", "Total"):
        assert got[slot].shape == (1,), slot
        assert np.array_equal(got[slot].numpy(), np.asarray(want[slot])), slot
    assert got["Correct"].dtype == torch.int32
    assert got["Accuracy"].dtype == torch.float32


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["momentum", "nesterov"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_momentum_op_updates_in_place(nesterov, dtype):
    rng = _rng(13)
    p = rng.standard_normal((5, 3)).astype(np.float32)
    g = rng.standard_normal((5, 3)).astype(np.float32)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    lr = np.array([0.05], np.float32)
    jd = jnp.dtype(dtype)
    want = jax_op("momentum").fn(
        Param=jnp.asarray(p, jd), Grad=jnp.asarray(g, jd),
        Velocity=jnp.asarray(v), LearningRate=jnp.asarray(lr), mu=0.9,
        use_nesterov=nesterov)
    tp = torch.tensor(np.asarray(jnp.asarray(p, jd).astype(jnp.float32))
                      ).to(getattr(torch, dtype))
    tg = torch.tensor(np.asarray(jnp.asarray(g, jd).astype(jnp.float32))
                      ).to(getattr(torch, dtype))
    tv = torch.tensor(v)
    ptr = tp.data_ptr(), tv.data_ptr()
    with torch.no_grad():
        got = torch_op("momentum").fn(Param=tp, Grad=tg, Velocity=tv,
                                      LearningRate=torch.tensor(lr),
                                      mu=0.9, use_nesterov=nesterov)
    assert got["ParamOut"] is tp and got["VelocityOut"] is tv
    assert (tp.data_ptr(), tv.data_ptr()) == ptr
    assert tp.dtype == getattr(torch, dtype) and tv.dtype == torch.float32
    tol = FWD_TOL if dtype == "float32" else 2e-2
    assert _rel(tp.float(), want["ParamOut"]) <= tol
    assert _rel(tv, want["VelocityOut"]) <= FWD_TOL


def test_gaussian_random_op():
    ctx = tpt.core.executor.LoweringCtx(torch.device("cpu"),
                                        torch.Generator())
    out = torch_op("gaussian_random").fn(
        shape=[200, 300], dtype="bfloat16", mean=0.5, std=2.0, seed=3,
        _ctx=ctx)["Out"]
    again = torch_op("gaussian_random").fn(
        shape=[200, 300], dtype="bfloat16", mean=0.5, std=2.0, seed=3,
        _ctx=ctx)["Out"]
    assert out.dtype == torch.bfloat16 and out.shape == (200, 300)
    assert torch.equal(out, again)              # seeded by its attr
    f = out.float()
    assert abs(f.mean().item() - 0.5) < 0.05
    assert abs(f.std().item() - 2.0) < 0.05


# -- programs -----------------------------------------------------------------

def _build(pkg, model, cfg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = model.build(**cfg)
    return main, startup, out


def _describe(program):
    ops = [(op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.is_data, type(v).__name__)
                 for v in program.list_vars()]
    return ops, variables


CIFAR = dict(depth=8, class_dim=10, image_shape=(3, 16, 16),
             dtype="float32", learning_rate=1e-3)
R50 = dict(depth=50, class_dim=10, image_shape=(3, 32, 32),
           dtype="float32", learning_rate=1e-3)


@pytest.mark.parametrize("cfg", [
    CIFAR, R50, dict(R50, dtype="bfloat16", is_test=True),
    dict(CIFAR, dtype="bfloat16")],
    ids=["cifar8", "resnet50", "resnet50_bf16_is_test", "cifar8_bf16"])
def test_build_gives_the_same_programs(cfg):
    jmain, jstart, _ = _build(pt, jrn, cfg)
    tmain, tstart, _ = _build(tpt, trn, cfg)
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    for prog in (tmain, tstart):
        for op in prog.global_block().ops:
            torch_op(op.type)                   # every op is registered
    types = {op.type for op in tmain.global_block().ops}
    assert {"conv2d", "batch_norm", "pool2d", "relu", "softmax",
            "cross_entropy", "mean", "top_k", "accuracy"} <= types
    assert ("momentum" in types) == (not cfg.get("is_test", False))
    assert {op.type for op in tstart.global_block().ops} <= {
        "fill_constant", "gaussian_random", "uniform_random"}


# -- training -----------------------------------------------------------------

def _feeds(seed, n, batch, hw):
    rng = _rng(seed)
    return [{"img": rng.standard_normal((batch, 3, hw, hw)
                                        ).astype(np.float32),
             "label": rng.integers(0, 10, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _reference(cfg, feeds, bumps=(0,)):
    """The JAX package's runs from its own startup state: losses,
    accuracies, step-1 gradients and the persistables after the last
    step.  One compiled program serves every run; a run of ``bumps`` other
    than 0 starts with every trainable weight moved one ulp up (1) or
    down (-1)."""
    main, startup, out = _build(pt, jrn, cfg)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.persistable_vars()]
    params = [p.name for p in main.all_parameters()]
    init = {n: np.asarray(scope.get(n)) for n in names}
    fetch = [out["avg_cost"].name, out["accuracy"].name] + [
        p + "@GRAD" for p in params]
    runs = []
    for bump in bumps:
        start = {n: (np.nextafter(v, bump * np.inf) if bump and n in params
                     else v) for n, v in init.items()}
        scope = pt.Scope()
        for n, v in start.items():
            scope.set(n, jnp.asarray(v))
        rec = {"loss": [], "acc": [], "grads": None, "init": start,
               "params": params, "fetch": fetch}
        for i, feed in enumerate(feeds):
            outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            rec["loss"].append(float(np.asarray(outs[0]).ravel()[0]))
            rec["acc"].append(float(np.asarray(outs[1]).ravel()[0]))
            if i == 0:
                rec["grads"] = {p: np.asarray(g, np.float32)
                                for p, g in zip(params, outs[2:])}
        rec["state"] = {n: np.asarray(scope.get(n), np.float32)
                        for n in names}
        runs.append(rec)
    return runs


def _port(cfg, feeds, init, fetch):
    main, _, _ = _build(tpt, trn, cfg)
    scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    ptrs = {n: scope.get(n).data_ptr() for n in init}
    exe = tpt.Executor(tpt.CPUPlace())
    params = [p.name for p in main.all_parameters()]
    rec = {"loss": [], "acc": [], "grads": None}
    for i, feed in enumerate(feeds):
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        rec["loss"].append(float(outs[0].ravel()[0]))
        rec["acc"].append(float(outs[1].ravel()[0]))
        if i == 0:
            rec["grads"] = dict(zip(params, outs[2:]))
    rec["state"] = {n: scope.numpy(n) for n in init}
    rec["init"] = init
    rec["ptrs_kept"] = {n: scope.get(n).data_ptr() == ptrs[n] for n in init}
    return rec


@pytest.fixture(scope="module")
def cifar_run():
    feeds = _feeds(21, 3, 4, 16)
    ref, = _reference(CIFAR, feeds)
    return ref, _port(CIFAR, feeds, ref["init"], ref["fetch"])


def test_cifar_three_momentum_steps_match_the_reference(cifar_run):
    ref, got = cifar_run
    for a, b in zip(got["loss"], ref["loss"]):
        assert abs(a - b) <= FWD_TOL * abs(b), (got["loss"], ref["loss"])
    assert got["acc"] == ref["acc"]
    for p, g in ref["grads"].items():
        assert _rel(got["grads"][p], g) <= GRAD_TOL, p
    kinds = set()
    for n, want in ref["state"].items():
        tol = FWD_TOL if n.endswith((".mean", ".variance")) else GRAD_TOL
        assert _rel(got["state"][n], want) <= tol, n
        kinds.add(n.rsplit(".", 1)[-1].rsplit("_", 1)[-1])
    assert {"w", "scale", "offset", "mean", "variance", "velocity"} <= kinds
    assert got["loss"][0] != got["loss"][-1]


def test_cifar_state_updates_in_place_and_statistics_move(cifar_run):
    ref, got = cifar_run
    init = ref["init"]
    velocities = [n for n in init if n.endswith("_velocity")]
    stats = [n for n in init if n.endswith((".mean", ".variance"))]
    assert velocities and stats
    for n in ref["params"] + velocities:
        assert got["ptrs_kept"][n], n           # momentum writes in place
    for n in ref["params"] + velocities + stats:
        assert not np.array_equal(got["state"][n], init[n]), n


def _flat(d, names):
    return np.concatenate([np.asarray(d[n], np.float32).ravel()
                           for n in names])


def test_resnet50_one_step_matches_the_reference_within_its_own_spread():
    """ResNet-50 at random init in f32 amplifies a one-ulp change of its
    weights into a 1-4% change of its gradient vector, and of single
    parameters' gradients by up to 31%.  The comparison is therefore of
    the whole step, against the spread of the reference's own runs from
    its state moved one ulp up and down: the loss, the gradient vector
    (relative L2 error and cosine), the update of every parameter and
    velocity (relative L2) and every BN running statistic are each held to
    ORACLE_TOL or to twice that spread, whichever is larger."""
    feeds = _feeds(22, 1, 4, 32)
    ref, up, down = _reference(R50, feeds, bumps=(0, 1, -1))
    got = _port(R50, feeds, ref["init"], ref["fetch"])
    params = ref["params"]

    def spread(fn):
        return max(fn(up), fn(down))

    loss = ref["loss"][0]
    own = spread(lambda r: abs(r["loss"][0] - loss))
    assert abs(got["loss"][0] - loss) <= max(FWD_TOL * abs(loss), 2 * own)
    assert got["acc"] == ref["acc"]

    g_ref = _flat(ref["grads"], params)

    def l2(rec):
        return float(np.linalg.norm(_flat(rec["grads"], params) - g_ref)
                     / np.linalg.norm(g_ref))

    assert l2(got) <= max(GRAD_TOL, 2 * spread(l2)), (l2(got), spread(l2))
    g_got = _flat(got["grads"], params)
    cos = float(g_got @ g_ref / np.linalg.norm(g_got) / np.linalg.norm(g_ref))
    assert cos >= 0.999, cos

    velocities = [p + "_velocity" for p in params]
    for rec in (ref, got):                      # v = 0.9 * 0 + g: the grads
        assert np.array_equal(_flat(rec["state"], velocities),
                              _flat(rec["grads"], params))
    d_ref = _flat(ref["state"], params) - _flat(ref["init"], params)

    def upd(rec):                               # each from its own start
        d = _flat(rec["state"], params) - _flat(rec["init"], params)
        return float(np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref))

    assert upd(got) <= max(GRAD_TOL, 2 * spread(upd)), (upd(got),
                                                        spread(upd))
    for n in ref["state"]:
        if not n.endswith((".mean", ".variance")):
            continue
        want = ref["state"][n]
        scale = float(np.abs(want).max())
        own = spread(lambda r: float(np.abs(r["state"][n] - want).max()))
        d = float(np.abs(got["state"][n] - want).max())
        assert d <= max(FWD_TOL * scale, 2 * own), (n, d / scale, own / scale)


def test_load_numpy_state_carries_statistics_and_velocities():
    main, startup, _ = _build(pt, jrn, CIFAR)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    arrays = {v.name: np.asarray(scope.get(v.name))
              for v in main.persistable_vars()}
    arrays = {n: (a + 0.25 if n.endswith((".mean", "_velocity")) else a)
              for n, a in arrays.items()}
    tscope = tpt.load_numpy_state(tpt.Scope(), arrays, device="cpu")
    tmain = _build(tpt, trn, CIFAR)[0]
    for v in tmain.persistable_vars():
        t = tscope.get(v.name)
        assert t.dtype == torch.float32 and tuple(t.shape) == tuple(v.shape)
        assert np.array_equal(t.numpy(), arrays[v.name]), v.name
    assert any(n.endswith("_velocity") for n in arrays)
    assert any(n.endswith(".variance") for n in arrays)
