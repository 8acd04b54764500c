"""The head widths the reference takes, on the port's CPU path and in its
family rules: the fused cross-entropy head past d = 768 and flash
attention at d_head 192 and 256.

* The family rules: ``ce_family`` keeps the sm90 family at d <= 768 and
  gives the simple one (whose kernels loop over d-chunks) past it;
  ``bwd_family`` keeps sm90 at d_head <= 128 and gives the simple one
  (which takes d_head up to 256) past it.
* The plain versions at those widths against the JAX package's Pallas
  kernels in interpret mode: the CE head at d = 1024 and 2048
  (``pallas_ce.fused_softmax_ce_head``, small explicit blocks), flash
  attention at d_head 192 and 256 (``pallas_attention.flash_attention``,
  16-wide blocks), forward and gradients, f32 and bf16 within
  ``ORACLE_TOL``.
* One Adam step of ``transformer.build`` through both packages' Executors
  from one startup state: the fused head at d_model 1024 and a GPT with
  d_head 256 (2 heads of d_model 512), one layer, t = 16, vocab 61, f32:
  the loss within 1e-5 relative and every parameter's gradient within
  1e-4 of its largest entry (the key-projection biases, whose gradient is
  roundoff in both packages, held to the model's largest gradient entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu.ops import pallas_ce as jce
from paddle_tpu_torch.core.scope import tensor_from_numpy
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_ce as tce
from paddle_tpu_torch.models import transformer as ttr
from torch_ref_gauges import restore_reference_gauges  # noqa: F401


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("d,want", [(64, "sm90"), (768, "sm90"),
                                    (776, "simple"), (1024, "simple"),
                                    (2048, "simple")])
def test_ce_family_keeps_sm90_to_768(d, want):
    assert tce.ce_family(torch.bfloat16, d, 32768, [0, 256, 512]) == want
    assert tce.ce_family(torch.float32, d, 32768, [0, 256, 512]) == "simple"


@pytest.mark.parametrize("d,want", [(64, "sm90"), (128, "sm90"),
                                    (136, "simple"), (192, "simple"),
                                    (256, "simple")])
def test_flash_family_keeps_sm90_to_128(d, want):
    strides = [(4096 * 6 * d, 6 * d, d)] * 3
    assert tfa.bwd_family(torch.bfloat16, d, strides, [0, 256, 512]) == want


# (rows, d, V, blocks (block_n, block_v, block_v_fwd)); labels -1 and V
CE_CASES = {"d1024": (40, 1024, 100, (20, 50, 50)),
            "d2048": (24, 2048, 90, (12, 30, 45))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CE_CASES))
def test_fused_ce_past_768_matches_the_pallas_kernels(case, dtype):
    n, d, v, (bn, bv, bvf) = CE_CASES[case]
    rng = np.random.default_rng(d + v)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (2 * rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int64)
    y[1], y[4] = -1, v
    g = rng.standard_normal(n).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)

    def f(a, b):
        return jce.fused_softmax_ce_head(
            a, b, jnp.asarray(y), block_n=bn, block_v=bv, block_v_fwd=bvf,
            backend="pallas_tpu", interpret=True)
    jloss, vjp = jax.vjp(f, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))

    tx, tw = (tensor_from_numpy(np.asarray(a)) for a in (jx, jw))
    ty = torch.tensor(y).to(torch.int32)
    loss, lse = tce.ce_fwd(tx, tw, ty)
    dx = tce.ce_dx(tx, tw, ty, lse, torch.tensor(g))
    dw = tce.ce_dw(tx, tw, ty, lse, torch.tensor(g))
    assert _rel(_np(loss), jloss) <= tce.oracle_tol(dtype, "fwd")
    assert dx.dtype == tx.dtype and dw.shape == (d, v)
    assert _rel(_np(dx), jdx) <= tce.oracle_tol(dtype, "grad")
    assert _rel(_np(dw), jdw) <= tce.oracle_tol(dtype, "grad")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [192, 256])
def test_flash_at_wide_heads_matches_the_pallas_kernels(d, dtype, causal):
    b, t, h, blk = 1, 32, 2, 16
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                   for _ in range(4))
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))

    def f(a, b_, c):
        return jfa.flash_attention(a, b_, c, causal=causal, block_q=blk,
                                   block_k=blk)
    jo, vjp = jax.vjp(f, jq, jk, jv)
    jgrads = vjp(jdo)
    tq, tk, tv, tdo = (tensor_from_numpy(np.asarray(a))
                       for a in (jq, jk, jv, jdo))
    to, tlse = tfa.flash_fwd(tq, tk, tv, causal=causal)
    assert _rel(_np(to), jo) <= tfa.oracle_tol(dtype, "fwd")
    got = tfa.flash_bwd(tq, tk, tv, to, tlse, tdo, causal=causal)
    for name, gt, want in zip(("dq", "dk", "dv"), got, jgrads):
        assert _rel(_np(gt), want) <= tfa.oracle_tol(dtype, "grad"), name


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """An empty tune cache for the reference, as the other parity files
    pin it: both packages build with their defaults."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


VOCAB, T, BATCH = 61, 16, 2


def _build(pkg, model, cfg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = model.build(**cfg)
    return main, startup, out


# name -> (d_model, n_head, fused_head)
STEP_CASES = {"fused_head_d1024": (1024, 8, True),
              "d_head_256": (512, 2, False)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_training_step_matches_the_reference(case):
    d_model, n_head, fused_head = STEP_CASES[case]
    cfg = dict(vocab_size=VOCAB, n_layer=1, n_head=n_head, d_model=d_model,
               max_len=T, dropout_rate=0.0, dtype="float32",
               fused_head=fused_head, learning_rate=2e-3)
    rng = np.random.default_rng(d_model)
    start = rng.integers(0, VOCAB, (BATCH, 1))
    toks = (start + np.arange(T)[None, :]) % VOCAB
    labels = np.concatenate([toks[:, 1:], -np.ones((BATCH, 1), np.int64)],
                            axis=1)
    feed = {"tokens": toks.astype(np.int64),
            "labels": labels.astype(np.int64)}

    jmain, jstart, jout = _build(pt, jtr, cfg)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.get(v.name))
            for v in jmain.persistable_vars()}
    params = [p.name for p in jmain.all_parameters()]
    fetch = [jout["avg_cost"].name] + [p + "@GRAD" for p in params]
    want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)

    tmain, _, _ = _build(tpt, ttr, cfg)
    scope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    got = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=fetch, scope=scope)
    loss, ref_loss = float(got[0].ravel()[0]), float(
        np.asarray(want[0]).ravel()[0])
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    top = max(float(np.abs(np.asarray(g)).max()) for g in want[1:])
    for name, g, w in zip(params, got[1:], want[1:]):
        w = np.asarray(w, np.float32)
        scale = top if "_att_k.b" in name else float(np.abs(w).max())
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)
