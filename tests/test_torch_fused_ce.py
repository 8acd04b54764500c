"""The port's fused softmax-cross-entropy head
(paddle_tpu_torch/kernels/fused_ce.py) against the JAX package's Pallas
kernels (``paddle_tpu.ops.pallas_ce``) run in interpret mode on the CPU.

The same seeded numpy inputs go through
``pallas_ce.fused_softmax_ce_head(..., backend="pallas_tpu",
interpret=True)`` with explicit small blocks (so the kernels walk a grid
of row and vocab tiles, not one degenerate tile) and through the port's
plain PyTorch versions, which the CPU path uses and the CUDA kernels are
held against on the card.  Every case carries labels -1 and V (out of
range: the loss is lse and no onehot term enters the gradient).  Compared:
the loss, ``lse`` (through ``_ce_fwd``), and ``dx``, ``dW`` from one
random loss cotangent.

Tolerance: ``ORACLE_TOL`` (max |a - b| / max |b|) — f32 fwd 2e-4 / grad
1e-3, bf16 fwd 2e-2 / grad 5e-2: the tiled online softmax reassociates
the f32 sums, and in bf16 ``ds`` is rounded to bf16 on both sides from
scores that differ in their last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import pallas_ce as jce
from paddle_tpu_torch.core.scope import tensor_from_numpy
from paddle_tpu_torch.kernels import fused_ce as tce
from paddle_tpu_torch.models import transformer as ttr

# name -> (leading dims, d, V, (block_n, block_v, block_v_fwd)); neither
# case divides the CUDA tiles (64 rows, 64 or 32 vocab columns)
CASES = {"flat": ((60,), 32, 250, (20, 50, 125)),
         "batch_time": ((3, 20), 24, 200, (12, 40, 100))}


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _inputs(lead, d, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (d,)).astype(np.float32)
    w = (2 * rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, v, lead).astype(np.int64)
    flat = y.reshape(-1)
    flat[1], flat[4], flat[-1] = -1, v, -1
    g = rng.standard_normal(lead).astype(np.float32)
    return x, w, y, g


@pytest.fixture(scope="module", params=[(c, dt) for c in CASES
                                        for dt in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    """(case, dtype, reference record, port record) from one set of
    inputs: the interpreted Pallas kernels by ``jax.vjp``, the port by
    autograd."""
    case, dtype = request.param
    lead, d, v, (bn, bv, bvf) = CASES[case]
    x, w, y, g = _inputs(lead, d, v, seed=d + v)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)

    def f(a, b):
        return jce.fused_softmax_ce_head(
            a, b, jnp.asarray(y), block_n=bn, block_v=bv, block_v_fwd=bvf,
            backend="pallas_tpu", interpret=True)
    jloss, vjp = jax.vjp(f, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    n = int(np.prod(lead))
    _, jlse = jce._ce_fwd(jx.reshape(n, d), jw,
                          jnp.asarray(y.reshape(n), jnp.int32), bn, bvf, True)
    ref = {"loss": jloss, "lse": jlse, "dx": jdx, "dw": jdw}

    tx = tensor_from_numpy(np.asarray(jx)).requires_grad_()
    tw = tensor_from_numpy(np.asarray(jw)).requires_grad_()
    tl = tce.fused_softmax_ce_head(tx, tw, torch.from_numpy(y), block_n=bn,
                                   block_v=bv, block_v_fwd=bvf)
    tl.backward(torch.from_numpy(g))
    _, tlse = tce.fused_ce_ref(tx.detach().reshape(n, d), tw.detach(),
                               torch.from_numpy(y.reshape(n)))
    got = {"loss": tl, "lse": tlse, "dx": tx.grad, "dw": tw.grad}
    return case, dtype, ref, got


def test_loss_and_lse_match_the_pallas_forward(both):
    case, dtype, ref, got = both
    assert got["loss"].dtype == torch.float32
    assert tuple(got["loss"].shape) == CASES[case][0]
    tol = tce.oracle_tol(dtype, "fwd")
    assert _rel(_np(got["loss"]), ref["loss"]) <= tol
    assert _rel(_np(got["lse"]), ref["lse"]) <= tol


def test_dx_and_dw_match_jax_grad(both):
    _, dtype, ref, got = both
    tol = tce.oracle_tol(dtype, "grad")
    for name in ("dx", "dw"):
        assert got[name].dtype == getattr(torch, dtype), name
        assert tuple(got[name].shape) == tuple(ref[name].shape), name
        assert _rel(_np(got[name]), ref[name]) <= tol, name


def test_out_of_range_labels_give_lse_and_no_onehot():
    x, w, y, g = (torch.from_numpy(a) for a in _inputs((12,), 8, 40, seed=2))
    loss, lse = tce.fused_ce_ref(x, w, y)
    for i in (1, 4, 11):                                  # labels -1, V, -1
        assert loss[i] == lse[i]
    s = x @ w
    assert torch.allclose(lse, torch.logsumexp(s, -1), rtol=1e-6)
    keep = (y >= 0) & (y < 40)
    want = torch.logsumexp(s, -1) - s.gather(1, y.clamp(0, 39)[:, None])[:, 0]
    assert torch.allclose(loss[keep], want[keep], rtol=1e-6)
    dx, dw = tce.fused_ce_bwd_ref(x, w, y, lse, g)
    p = torch.softmax(s, -1)
    assert torch.allclose(dx[1], g[1] * p[1] @ w.T, rtol=1e-5, atol=1e-6)


def test_residual_contract_and_one_backward_call_each(monkeypatch):
    """Forward saves (x, w, y, lse) and nothing [N, V]; the backward is one
    dx and one dW call and never re-runs the forward."""
    assert tce.FUSED_CE_RESIDUALS == ("x", "w", "y", "lse")
    x, w, y, g = (torch.from_numpy(a) for a in _inputs((16,), 8, 40, seed=3))
    x.requires_grad_(), w.requires_grad_()
    calls = {"fwd": 0, "dx": 0, "dw": 0}
    for name, real in (("fwd", tce.ce_fwd), ("dx", tce.ce_dx),
                       ("dw", tce.ce_dw)):
        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(tce, "ce_" + name, counted)
    loss = tce.FusedCEFunction.apply(x, w, y.to(torch.int32))
    saved = loss.grad_fn.saved_tensors
    assert len(saved) == len(tce.FUSED_CE_RESIDUALS)
    assert saved[0].data_ptr() == x.data_ptr()
    assert saved[1].data_ptr() == w.data_ptr()
    assert saved[2].dtype == torch.int32 and saved[2].shape == (16,)
    assert saved[3].shape == (16,) and saved[3].dtype == torch.float32
    loss.backward(g)
    assert calls == {"fwd": 1, "dx": 1, "dw": 1}
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_cpu_launch_counters_stay_at_zero():
    """A wrapper adds to its count where it launches its kernel, and
    nowhere else: CPU tensors take the plain version and count nothing."""
    x, w, y, g = (torch.from_numpy(a) for a in _inputs((10,), 8, 30, seed=4))
    y = y.to(torch.int32)
    before = (tce.ce_fwd.launches, tce.ce_dx.launches, tce.ce_dw.launches)
    _, lse = tce.ce_fwd(x, w, y)
    tce.ce_dx(x, w, y, lse, g)
    tce.ce_dw(x, w, y, lse, g)
    assert (tce.ce_fwd.launches, tce.ce_dx.launches,
            tce.ce_dw.launches) == before


def test_gradcheck_of_the_plain_path_in_f64():
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((6, 5)), dtype=torch.float64,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((5, 7)), dtype=torch.float64,
                     requires_grad=True)
    y = torch.tensor([0, 6, -1, 3, 7, 2])
    assert torch.autograd.gradcheck(
        lambda a, b: tce.fused_softmax_ce_head(a, b, y), (x, w), eps=1e-6,
        atol=1e-6)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x, w, y, g = (torch.from_numpy(a) for a in _inputs((10,), 8, 30, seed=6))
    with pytest.raises(ValueError):
        tce.ce_fwd(x, w[:4], y)                       # d mismatch
    with pytest.raises(ValueError):
        tce.ce_fwd(x, w, y[:5])                       # N mismatch
    with pytest.raises(ValueError):
        tce.ce_fwd(x[None], w, y)                     # not [N, d]
    with pytest.raises(TypeError):
        tce.ce_fwd(x, w.double(), y)                  # mixed dtypes
    with pytest.raises(TypeError):
        tce.ce_fwd(x, w, y.float())                   # float labels
    _, lse = tce.ce_fwd(x, w, y)
    with pytest.raises(ValueError):
        tce.ce_dx(x, w, y, lse[:3], g)                # lse not [N]
    with pytest.raises(ValueError):
        tce.ce_dw(x, w, y, lse, g[:3])                # g not [N]


def test_fused_head_model_serves_through_generate():
    """A fused-head model's weights (``extract_params``) carry the names
    and shapes of the unfused model's, ``lm_head.w [d, V]`` included, and
    the port's ``generate`` serves them token for token as the JAX
    package's does."""
    cfg = dict(vocab_size=50, n_layer=2, n_head=2, d_model=32, max_len=24,
               dropout_rate=0.0, dtype="float32")
    names = {}
    for fused in (True, False):
        tpt.core.unique_name.reset()
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup):
            model = ttr.build(fused_head=fused, **cfg)
        names[fused] = {p.name: tuple(p.shape) for p in main.all_parameters()}
        if fused:
            assert model["logits"] is None
            scope = tpt.Scope()
            tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
            params = ttr.extract_params(scope, program=main)
    assert names[True] == names[False]
    assert params["lm_head.w"].shape == (32, 50)
    prompt = np.array([[3, 1, 4, 1, 5]], np.int32)
    tt, _ = ttr.generate(params, prompt, max_len=16, n_layer=2, n_head=2,
                         d_model=32, device="cpu")
    jt, _ = jtr.generate(params, prompt, max_len=16, n_layer=2, n_head=2,
                         d_model=32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the reference names it the same way
    pt.core.unique_name.reset()
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        jtr.build(fused_head=True, **cfg)
    assert {p.name for p in jmain.all_parameters()} == set(names[True])
