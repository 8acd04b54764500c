"""The port's program stack (Program -> layers -> ops) against the JAX
package's, on the CPU.

* ``transformer.build`` called with the same arguments in both packages
  gives the same programs: op types in order, op slots with variable
  names, attrs, and every variable's name, shape, dtype and role — for
  the 4-D attention op (d_head 16) and the packed one (d_head 64, paired
  heads), with the unfused and the fused cross-entropy head, main and
  startup program alike.
* The reference's post-startup persistables go through
  ``load_numpy_state`` and come back bit for bit.
* Each op lowering the training path reaches that does real arithmetic
  (``layer_norm``, ``gelu``, ``softmax_with_cross_entropy``,
  ``fused_softmax_ce_head``, ``lookup_table``, ``adam``, ``mul``, the elementwise broadcast rule)
  matches the JAX op function on seeded inputs: f32 within 1e-5 of the
  output's largest magnitude (different summation order only), bf16
  within 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from paddle_tpu_torch.core.scope import tensor_from_numpy, tensor_to_numpy
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


CONFIGS = {
    "d32_h2_4d": dict(vocab_size=61, n_layer=2, n_head=2, d_model=32,
                      max_len=16, dropout_rate=0.0, dtype="float32",
                      fused_head=False),
    "d128_h2_packed": dict(vocab_size=61, n_layer=2, n_head=2, d_model=128,
                           max_len=16, dropout_rate=0.0, dtype="float32",
                           fused_head=False),
    "d32_bf16_dropout": dict(vocab_size=61, n_layer=1, n_head=2, d_model=32,
                             max_len=16, dropout_rate=0.1,
                             dtype="bfloat16"),
    "d32_h2_4d_fused_head": dict(vocab_size=61, n_layer=2, n_head=2,
                                 d_model=32, max_len=16, dropout_rate=0.0,
                                 dtype="float32", fused_head=True),
    "d128_packed_bf16_fused_head": dict(vocab_size=61, n_layer=1, n_head=1,
                                        d_model=128, max_len=16,
                                        dropout_rate=0.0, dtype="bfloat16",
                                        fused_head=True),
}


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
                  v.stop_gradient, v.is_data, type(v).__name__,
                  getattr(v, "trainable", None))
                 for v in program.list_vars()]
    return ops, variables


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_build_gives_the_same_program(config, which):
    cfg = CONFIGS[config]
    jmain, jstart, jout = _build(pt, jtr, cfg)
    tmain, tstart, tout = _build(tpt, ttr, cfg)
    jprog, tprog = (jmain, tmain) if which == "main" else (jstart, tstart)
    jops, jvars = _describe(jprog)
    tops, tvars = _describe(tprog)
    assert [o[0] for o in tops] == [o[0] for o in jops]
    for t, j in zip(tops, jops):
        assert t == j
    assert tvars == jvars
    assert (tprog.global_block().backward_index
            == jprog.global_block().backward_index)
    assert tprog._backward_info == jprog._backward_info
    assert tout["avg_cost"].name == jout["avg_cost"].name
    assert [v.name for v in tout["feed"]] == [v.name for v in jout["feed"]]
    if which == "main":
        attn = {"d32_h2_4d": "flash_attention",
                "d128_h2_packed": "flash_attention_packed",
                "d32_bf16_dropout": "flash_attention",
                "d32_h2_4d_fused_head": "flash_attention",
                "d128_packed_bf16_fused_head": "flash_attention_packed",
                }[config]
        types = [o[0] for o in tops]
        assert attn in types
        fused = cfg.get("fused_head", False)
        assert ("fused_softmax_ce_head" in types) == fused
        assert ("softmax_with_cross_entropy" in types) == (not fused)
        assert (tout["logits"] is None) == fused


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_state_crosses_by_name(dtype):
    """Everything ``persistable_vars()`` names after the reference's
    startup run — weights, moments, beta pows, learning rate — lands in
    the port's scope under the same name, shape and dtype, bit for bit."""
    cfg = dict(CONFIGS["d32_h2_4d"], dtype=dtype)
    jmain, jstart, _ = _build(pt, jtr, cfg)
    jscope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.get(v.name))
             for v in jmain.persistable_vars()}
    assert {"tok_emb.w", "pos_emb.w.w", "lm_head.w", "block0_att_q.w",
            "tok_emb.w_moment1", "learning_rate_0", "beta1_pow_acc_0",
            "beta2_pow_acc_0"} <= set(state)
    tmain, _, _ = _build(tpt, ttr, cfg)
    scope = tpt.load_numpy_state(tpt.Scope(), state, device="cpu")
    for v in tmain.persistable_vars():
        t = scope.get(v.name)
        assert tuple(t.shape) == tuple(v.shape), v.name
        assert str(t.dtype).replace("torch.", "") == v.dtype.name, v.name
        want = state[v.name]
        if want.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  want.view(np.int16)), v.name
        else:
            assert np.array_equal(t.numpy(), want), v.name
    assert scope.get("block1_ffn1.w").dtype == getattr(torch, dtype)
    assert scope.get("tok_emb.w").dtype == torch.float32
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (a card is present)")
        tpt.load_numpy_state(tpt.Scope(), state)


def test_startup_program_fills_the_scope():
    """The port's own startup run: constants exact, uniform draws inside
    their Xavier bounds and different from tensor to tensor."""
    tmain, tstart, _ = _build(tpt, ttr, CONFIGS["d128_h2_packed"])
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(tstart, scope=scope)
    for v in tmain.persistable_vars():
        t = scope.get(v.name)
        assert tuple(t.shape) == tuple(v.shape), v.name
    assert torch.equal(scope.get("block0_ln1.scale"), torch.ones(128))
    assert torch.equal(scope.get("block0_att_q.b"), torch.zeros(128))
    assert scope.get("learning_rate_0").item() == pytest.approx(1e-3)
    wq, wk = scope.get("block0_att_q.w"), scope.get("block0_att_k.w")
    bound = (6.0 / 256) ** 0.5
    assert wq.abs().max() <= bound and wq.std() > 0.3 * bound
    assert not torch.equal(wq, wk)
    assert scope.get("tok_emb.w").abs().max() <= 0.05
    # seeded: a second startup run draws the same values
    again = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(tstart, scope=again)
    assert torch.equal(again.get("block0_att_q.w"), wq)


# -- per-op parity ------------------------------------------------------------

def _t(a, dtype="float32"):
    return tensor_from_numpy(np.asarray(jnp.asarray(a, jnp.dtype(dtype))))


def _close(got, want, tol):
    got = tensor_to_numpy(got).astype(np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_op(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    s = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = jax_op("layer_norm").fn(
        X=jnp.asarray(x, jd), Scale=jnp.asarray(s, jd),
        Bias=jnp.asarray(b, jd), begin_norm_axis=2, epsilon=1e-5)
    got = torch_op("layer_norm").fn(
        X=_t(x, dtype), Scale=_t(s, dtype), Bias=_t(b, dtype),
        begin_norm_axis=2, epsilon=1e-5)
    assert got["Y"].dtype == getattr(torch, dtype)
    for slot in ("Y", "Mean", "Variance"):
        _close(got[slot], want[slot], TOL[dtype])
    only_y = torch_op("layer_norm").fn(
        X=_t(x, dtype), Scale=_t(s, dtype), Bias=_t(b, dtype),
        begin_norm_axis=2, _live={"Y"})
    assert set(only_y) == {"Y"} and torch.equal(only_y["Y"], got["Y"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_op_is_the_exact_erf_form(dtype):
    x = np.linspace(-6, 6, 97, dtype=np.float32).reshape(1, 97)
    want = jax_op("gelu").fn(X=jnp.asarray(x, jnp.dtype(dtype)))
    got = torch_op("gelu").fn(X=_t(x, dtype))
    _close(got["Out"], want["Out"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_with_cross_entropy_op(dtype):
    rng = np.random.default_rng(1)
    logits = (4 * rng.standard_normal((12, 61))).astype(np.float32)
    label = rng.integers(0, 61, (12, 1)).astype(np.int32)
    want = jax_op("softmax_with_cross_entropy").fn(
        Logits=jnp.asarray(logits, jnp.dtype(dtype)), Label=jnp.asarray(label))
    got = torch_op("softmax_with_cross_entropy").fn(
        Logits=_t(logits, dtype), Label=torch.from_numpy(label))
    assert got["Loss"].shape == (12, 1)
    _close(got["Loss"], want["Loss"], TOL[dtype])
    _close(got["Softmax"], want["Softmax"], TOL[dtype])
    lean = torch_op("softmax_with_cross_entropy").fn(
        Logits=_t(logits, dtype), Label=torch.from_numpy(label),
        _live={"Loss"})
    assert set(lean) == {"Loss"}


@pytest.mark.parametrize("label_shape", ["flat", "trailing_1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_softmax_ce_head_op(dtype, label_shape):
    """The op on the JAX package's Pallas kernels (interpreted, small
    blocks) and on the port's plain versions: Loss [..., 1] f32, the
    label squeezed when it carries a trailing 1; labels -1 and V give
    lse, as on the TPU."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) / 4).astype(np.float32)
    label = rng.integers(0, 40, (2, 6)).astype(np.int64)
    label[0, 1], label[1, 5] = -1, 40
    if label_shape == "trailing_1":
        label = label[..., None]
    jd = jnp.dtype(dtype)
    attrs = dict(block_n=4, block_v=8, block_v_fwd=20)
    want = jax_op("fused_softmax_ce_head").fn(
        X=jnp.asarray(x, jd), W=jnp.asarray(w, jd), Label=jnp.asarray(label),
        **attrs)
    got = torch_op("fused_softmax_ce_head").fn(
        X=_t(x, dtype), W=_t(w, dtype), Label=torch.from_numpy(label),
        backend="", **attrs)
    assert got["Loss"].shape == (2, 6, 1)
    assert got["Loss"].dtype == torch.float32
    _close(got["Loss"], want["Loss"], 2e-4 if dtype == "float32" else 2e-2)


def test_lookup_table_op():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((61, 8)).astype(np.float32)
    ids = rng.integers(0, 61, (3, 7)).astype(np.int32)
    for shape in ((3, 7), (3, 7, 1)):
        for pad in (-1, int(ids[0, 0])):
            want = jax_op("lookup_table").fn(
                W=jnp.asarray(w), Ids=jnp.asarray(ids.reshape(shape)),
                padding_idx=pad)
            got = torch_op("lookup_table").fn(
                W=torch.from_numpy(w),
                Ids=torch.from_numpy(ids.reshape(shape)), padding_idx=pad)
            assert np.array_equal(got["Out"].numpy(), np.asarray(want["Out"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_op_updates_in_place(dtype):
    rng = np.random.default_rng(3)
    p = rng.standard_normal((16, 8)).astype(np.float32)
    g = rng.standard_normal((16, 8)).astype(np.float32)
    m1 = (0.1 * rng.standard_normal((16, 8))).astype(np.float32)
    m2 = (0.1 * rng.random((16, 8))).astype(np.float32)
    lr, b1p, b2p = (np.array([v], np.float32) for v in (1e-2, 0.81, 0.998))
    jd = jnp.dtype(dtype)
    want = jax_op("adam").fn(
        Param=jnp.asarray(p, jd), Grad=jnp.asarray(g, jd),
        Moment1=jnp.asarray(m1), Moment2=jnp.asarray(m2),
        LearningRate=jnp.asarray(lr), Beta1Pow=jnp.asarray(b1p),
        Beta2Pow=jnp.asarray(b2p))
    tp, tm1, tm2 = _t(p, dtype), torch.from_numpy(m1.copy()), \
        torch.from_numpy(m2.copy())
    got = torch_op("adam").fn(
        Param=tp, Grad=_t(g, dtype), Moment1=tm1, Moment2=tm2,
        LearningRate=torch.from_numpy(lr), Beta1Pow=torch.from_numpy(b1p),
        Beta2Pow=torch.from_numpy(b2p))
    assert got["ParamOut"] is tp and got["Moment1Out"] is tm1 \
        and got["Moment2Out"] is tm2
    _close(tp, want["ParamOut"], TOL[dtype])
    _close(tm1, want["Moment1Out"], 1e-6)
    _close(tm2, want["Moment2Out"], 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mul_op_flattens_like_the_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = jax_op("mul").fn(X=jnp.asarray(x, jd), Y=jnp.asarray(w, jd),
                            x_num_col_dims=2, y_num_col_dims=1)
    got = torch_op("mul").fn(X=_t(x, dtype), Y=_t(w, dtype),
                             x_num_col_dims=2, y_num_col_dims=1)
    assert got["Out"].shape == (2, 5, 48)
    _close(got["Out"], want["Out"], TOL[dtype])


@pytest.mark.parametrize("op,xs,ys,axis", [
    ("elementwise_add", (2, 5, 8), (8,), 2),
    ("elementwise_add", (2, 5, 8), (5, 8), -1),
    ("elementwise_mul", (10, 1), (10, 1), -1),
    ("elementwise_div", (), (1,), -1),
    ("elementwise_max", (2, 5), (1,), -1),
    ("elementwise_sub", (2, 5, 8), (5,), 1),
])
def test_elementwise_broadcast_rule(op, xs, ys, axis):
    rng = np.random.default_rng(5)
    x = (1 + rng.random(xs)).astype(np.float32)
    y = (1 + rng.random(ys)).astype(np.float32)
    want = jax_op(op).fn(X=jnp.asarray(x), Y=jnp.asarray(y), axis=axis)
    got = torch_op(op).fn(X=torch.tensor(x), Y=torch.tensor(y), axis=axis)
    assert got["Out"].shape == np.asarray(want["Out"]).shape
    assert np.array_equal(got["Out"].numpy(), np.asarray(want["Out"]))


def test_every_op_of_the_training_program_is_registered():
    tmain, tstart, _ = _build(tpt, ttr, CONFIGS["d32_bf16_dropout"])
    for prog in (tmain, tstart):
        for op in prog.global_block().ops:
            torch_op(op.type)
    assert {op.type for op in tstart.global_block().ops} == {
        "fill_constant", "uniform_random"}


@pytest.mark.parametrize("attrs", [
    dict(reduce_all=True), dict(reduce_all=True, keep_dim=True),
    dict(dim=1), dict(dim=[0, 2], keep_dim=True), dict(dim=-1),
], ids=["all", "all_keep", "dim1", "dims02_keep", "last"])
def test_reduce_sum_op(attrs):
    x = np.random.default_rng(6).standard_normal((3, 4, 5)).astype(np.float32)
    want = np.asarray(jax_op("reduce_sum").fn(X=jnp.asarray(x), **attrs)["Out"])
    got = torch_op("reduce_sum").fn(X=torch.from_numpy(x), **attrs)["Out"]
    assert got.shape == want.shape
    _close(got, want, 1e-6)


@pytest.mark.parametrize("attrs", [
    dict(scale=0.9), dict(scale=-1.0, bias=2.5),
    dict(scale=3.0, bias=1.0, bias_after_scale=False)],
    ids=["scale", "scale_bias", "bias_first"])
def test_scale_and_cast_ops(attrs):
    x = np.random.default_rng(7).standard_normal((2, 6)).astype(np.float32)
    want = jax_op("scale").fn(X=jnp.asarray(x), **attrs)["Out"]
    got = torch_op("scale").fn(X=torch.from_numpy(x), **attrs)["Out"]
    _close(got, want, 1e-7)
    for out_dtype, tdt in (("bfloat16", torch.bfloat16),
                           ("int64", torch.int32), ("float32", torch.float32)):
        jc = jax_op("cast").fn(X=jnp.asarray(x), out_dtype=out_dtype)["Out"]
        tc = torch_op("cast").fn(X=torch.from_numpy(x),
                                 out_dtype=out_dtype)["Out"]
        assert tc.dtype == tdt and str(jc.dtype) == str(tdt).replace(
            "torch.", "")
        _close(tc, np.asarray(jc, np.float32), 0.0)
