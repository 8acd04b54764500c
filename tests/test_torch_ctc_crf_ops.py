"""The ops of the CTC, CRF and image-zoo slice in the port against the JAX
package's, on the CPU: ``warpctc``, ``linear_chain_crf``,
``crf_decoding``, ``ctc_align``, ``edit_distance``, ``arg_max``,
``row_conv`` and ``lrn``.

Every op runs on the same seeded numpy inputs in both packages.  Float
outputs are held within ORACLE_TOL f32's forward bound (2e-4 of the
output's largest magnitude; ``warpctc`` row by row, since a row whose
label does not fit its frames costs about 1e30) and the gradient of every
float input under one seeded cotangent within the gradient bound (1e-3 of
the gradient's largest magnitude); ``lrn`` in bf16 within ORACLE_TOL
bf16 (2e-2 forward, 5e-2 gradient).  Integer outputs (decodes,
alignments, distances) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.core.registry import get_op_impl as jax_op
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu_torch.core.registry import get_op_impl as torch_op

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
GRAD_TOL = ORACLE_TOL[("flash_attention", "float32")]["grad"]   # 1e-3
BF16_FWD = ORACLE_TOL[("flash_attention", "bfloat16")]["fwd"]   # 2e-2
BF16_GRAD = ORACLE_TOL[("flash_attention", "bfloat16")]["grad"]  # 5e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float() if x.is_floating_point() else x.detach()
    return np.asarray(x, np.float64)


def _rel(got, want):
    got, want = _np(got), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(op, floats, fixed, attrs, outs, seed, dtype=np.float32,
          n_diff=None):
    """``op`` in both packages: the float inputs ``floats`` (cast to
    ``dtype``, differentiated) and ``fixed`` (ints): ``(got, want,
    got_grads, want_grads)`` under seeded cotangents on the first
    ``n_diff`` outputs (all by default; the rest get zeros)."""
    names = sorted(floats)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    fixed_j = {k: jnp.asarray(v) for k, v in fixed.items()}

    def jfn(*vals):
        res = jax_op(op).fn(**dict(zip(names, vals)), **fixed_j, **attrs)
        return tuple(res[o] for o in outs)

    want, vjp = jax.vjp(jfn, *[jnp.asarray(floats[n], jdt) for n in names])
    rng = np.random.default_rng(seed + 100)
    cots = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]
    for i in range(len(cots) if n_diff is None else n_diff, len(cots)):
        cots[i] = np.zeros_like(cots[i])
    want_grads = vjp(tuple(jnp.asarray(c, w.dtype)
                           for c, w in zip(cots, want)))
    ts = {n: torch.tensor(floats[n]).to(tdt).requires_grad_()
          for n in names}
    res = torch_op(op).fn(**ts, **{k: torch.tensor(v)
                                   for k, v in fixed.items()}, **attrs)
    got = [res[o] for o in outs]
    total = sum((g.float() * torch.tensor(c)).sum()
                for g, c in zip(got, cots))
    grads = torch.autograd.grad(total, [ts[n] for n in names],
                                allow_unused=True)
    grads = [torch.zeros_like(ts[n]) if g is None else g
             for n, g in zip(names, grads)]
    return (got, [np.asarray(w.astype(jnp.float32)) for w in want],
            dict(zip(names, grads)),
            {n: np.asarray(w.astype(jnp.float32))
             for n, w in zip(names, want_grads)})


# -- warpctc -----------------------------------------------------------------

# five rows, each an edge: no label; a label longer than its frames (the
# reference's finite ~1e30); repeated labels that need a blank between
# them; frames shorter than T; a full row
CTC_T, CTC_V, CTC_L = 8, 5, 4
CTC_LOGIT_LEN = np.array([8, 2, 8, 5, 8], np.int32)
CTC_LABEL_LEN = np.array([0, 4, 3, 2, 4], np.int32)


def _ctc_inputs(blank):
    rng = np.random.default_rng(1)
    b = len(CTC_LOGIT_LEN)
    labels = rng.integers(0, CTC_V - 1, (b, CTC_L))
    labels = np.where(labels >= blank, labels + 1, labels)  # never blank
    labels[2, :3] = labels[2, 0]                             # repeats
    for r, n in enumerate(CTC_LABEL_LEN):
        labels[r, n:] = 0
    return ({"Logits": rng.standard_normal((b, CTC_T, CTC_V)
                                           ).astype(np.float32)},
            {"Label": labels.astype(np.int32),
             "LogitsLength": CTC_LOGIT_LEN, "LabelLength": CTC_LABEL_LEN})


@pytest.mark.parametrize("norm_by_times", [False, True],
                         ids=["sum", "norm_by_times"])
@pytest.mark.parametrize("blank", [0, CTC_V - 1], ids=["blank0", "blankV"])
def test_warpctc_op(blank, norm_by_times):
    floats, fixed = _ctc_inputs(blank)
    got, want, g_grads, w_grads = _both(
        "warpctc", floats, fixed,
        dict(blank=blank, norm_by_times=norm_by_times), ("Loss",), 1)
    loss, ref = _np(got[0])[:, 0], want[0][:, 0]
    assert np.isfinite(loss).all()
    # the label that does not fit: the reference's -(-1e30 + log 2)
    assert ref[1] > 1e29 and np.isfinite(ref[1])
    for r in range(len(ref)):
        assert abs(loss[r] - ref[r]) <= FWD_TOL * abs(ref[r]), (
            r, loss[r], ref[r])
    assert _rel(g_grads["Logits"], w_grads["Logits"]) <= GRAD_TOL


def test_warpctc_is_not_the_library_loss():
    """``F.ctc_loss`` agrees on the rows whose labels fit, and gives
    ``inf`` where the op gives about 1e30."""
    floats, fixed = _ctc_inputs(0)
    logits = torch.tensor(floats["Logits"])
    ours = torch_op("warpctc").fn(
        Logits=logits, **{k: torch.tensor(v) for k, v in fixed.items()},
        blank=0)["Loss"][:, 0]
    lib = F.ctc_loss(torch.log_softmax(logits, -1).transpose(0, 1),
                     torch.tensor(fixed["Label"]).long(),
                     torch.tensor(CTC_LOGIT_LEN).long(),
                     torch.tensor(CTC_LABEL_LEN).long(), blank=0,
                     reduction="none")
    fits = [0, 2, 3, 4]
    assert torch.allclose(ours[fits], lib[fits], rtol=1e-5)
    assert torch.isinf(lib[1]) and 1e29 < ours[1] < float("inf")


# -- linear_chain_crf, crf_decoding -------------------------------------------

CRF_T, CRF_N = 6, 4
CRF_LEN = np.array([6, 1, 3, 4], np.int32)        # a length-1 row


def _crf_inputs(seed):
    rng = np.random.default_rng(seed)
    b = len(CRF_LEN)
    # labels past a row's length are nonzero tags: they must not count
    label = rng.integers(0, CRF_N, (b, CRF_T)).astype(np.int64)
    return ({"Emission": rng.standard_normal((b, CRF_T, CRF_N)
                                             ).astype(np.float32),
             "Transition": (0.5 * rng.standard_normal((CRF_N + 2, CRF_N))
                            ).astype(np.float32)},
            {"Label": label, "Length": CRF_LEN})


def test_linear_chain_crf_op():
    floats, fixed = _crf_inputs(2)
    outs = ("LogLikelihood", "EmissionExps", "TransitionExps", "Alpha")
    got, want, g_grads, w_grads = _both("linear_chain_crf", floats, fixed,
                                        {}, outs, 2, n_diff=1)
    for o, g, w in zip(outs, got, want):
        assert _rel(g, w) <= FWD_TOL, (o, _rel(g, w))
    assert not _np(got[3]).any()
    for n in ("Emission", "Transition"):
        assert _rel(g_grads[n], w_grads[n]) <= GRAD_TOL, n
    # the length-1 row: start + emission + end, and only its first step's
    # emission takes a gradient
    assert not g_grads["Emission"][1, 1:].any()


def test_linear_chain_crf_without_lengths():
    floats, fixed = _crf_inputs(3)
    got, want, g_grads, w_grads = _both(
        "linear_chain_crf", floats, {"Label": fixed["Label"][:, :, None]},
        {}, ("LogLikelihood",), 3)
    assert _rel(got[0], want[0]) <= FWD_TOL
    for n in ("Emission", "Transition"):
        assert _rel(g_grads[n], w_grads[n]) <= GRAD_TOL, n


@pytest.mark.parametrize("with_label", [False, True],
                         ids=["path", "label_mask"])
@pytest.mark.parametrize("lengths", [True, False],
                         ids=["ragged", "full"])
def test_crf_decoding_op(with_label, lengths):
    floats, fixed = _crf_inputs(4)
    ins = dict(floats)
    if lengths:
        ins["Length"] = fixed["Length"]
    if with_label:
        ins["Label"] = fixed["Label"]
    want = np.asarray(jax_op("crf_decoding").fn(
        **{k: jnp.asarray(v) for k, v in ins.items()})["ViterbiPath"])
    got = torch_op("crf_decoding").fn(
        **{k: torch.tensor(v) for k, v in ins.items()})["ViterbiPath"]
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if lengths:
        assert not got[1, 1:].any()


def test_crf_decoding_ties_go_to_the_first_tag():
    """All-equal scores: every step's best predecessor is tag 0, and the
    path is all zeros in both packages."""
    em = np.zeros((2, 5, 3), np.float32)
    tr = np.zeros((5, 3), np.float32)
    ln = np.array([5, 2], np.int32)
    want = np.asarray(jax_op("crf_decoding").fn(
        Emission=jnp.asarray(em), Transition=jnp.asarray(tr),
        Length=jnp.asarray(ln))["ViterbiPath"])
    got = torch_op("crf_decoding").fn(
        Emission=torch.tensor(em), Transition=torch.tensor(tr),
        Length=torch.tensor(ln))["ViterbiPath"]
    assert np.array_equal(got.numpy(), want) and not want.any()


# -- ctc_align, edit_distance, arg_max ----------------------------------------

@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no_merge"])
@pytest.mark.parametrize("lengths", [True, False], ids=["ragged", "full"])
@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_align_op(merge, lengths, blank):
    rng = np.random.default_rng(5)
    ins = {"Input": rng.integers(0, 4, (5, 10)).astype(np.int32)}
    if lengths:
        ins["Length"] = np.array([10, 0, 4, 7, 1], np.int32)
    attrs = dict(blank=blank, merge_repeated=merge)
    want = jax_op("ctc_align").fn(
        **{k: jnp.asarray(v) for k, v in ins.items()}, **attrs)
    got = torch_op("ctc_align").fn(
        **{k: torch.tensor(v) for k, v in ins.items()}, **attrs)
    for slot in ("Output", "OutputLength"):
        assert np.array_equal(got[slot].numpy(), np.asarray(want[slot])), slot


@pytest.mark.parametrize("normalized", [False, True],
                         ids=["count", "normalized"])
@pytest.mark.parametrize("lengths", [True, False], ids=["ragged", "full"])
def test_edit_distance_op(normalized, lengths):
    rng = np.random.default_rng(6)
    b = 6
    ins = {"Hyps": rng.integers(0, 3, (b, 7)).astype(np.int64),
           "Refs": rng.integers(0, 3, (b, 9)).astype(np.int64)}
    if lengths:
        # empty hypothesis, empty reference, both empty, ragged, full
        ins["HypsLength"] = np.array([0, 5, 0, 3, 7, 6], np.int32)
        ins["RefsLength"] = np.array([4, 0, 0, 9, 2, 9], np.int32)
    want = jax_op("edit_distance").fn(
        **{k: jnp.asarray(v) for k, v in ins.items()}, normalized=normalized)
    got = torch_op("edit_distance").fn(
        **{k: torch.tensor(v) for k, v in ins.items()},
        normalized=normalized)
    assert got["Out"].dtype == torch.float32
    assert np.array_equal(got["Out"].numpy(), np.asarray(want["Out"]))
    assert np.array_equal(got["SequenceNum"].numpy(),
                          np.asarray(want["SequenceNum"]))


@pytest.mark.parametrize("axis", [-1, 1])
def test_arg_max_op(axis):
    rng = np.random.default_rng(7)
    # rounded values: many ties, which go to the first index
    x = np.round(rng.standard_normal((3, 5, 6)), 0).astype(np.float32)
    want = np.asarray(jax_op("arg_max").fn(X=jnp.asarray(x), axis=axis)["Out"])
    got = torch_op("arg_max").fn(X=torch.tensor(x), axis=axis)["Out"]
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# -- row_conv, lrn ------------------------------------------------------------

def test_row_conv_op_reads_the_frames_past_a_rows_end():
    """Ragged rows whose padded frames hold nonzero values: a valid frame
    within the lookahead of its row's end reads them (only the output is
    masked), in both packages."""
    rng = np.random.default_rng(8)
    b, t, d, ctx = 3, 9, 4, 5
    floats = {"X": rng.standard_normal((b, t, d)).astype(np.float32),
              "Filter": rng.standard_normal((ctx, d)).astype(np.float32)}
    ln = np.array([9, 4, 6], np.int32)
    got, want, g_grads, w_grads = _both("row_conv", floats, {"Length": ln},
                                        {}, ("Out",), 8)
    assert _rel(got[0], want[0]) <= FWD_TOL
    for n in ("X", "Filter"):
        assert _rel(g_grads[n], w_grads[n]) <= GRAD_TOL, n
    out = _np(got[0])
    assert not out[1, 4:].any()
    # frame 3 of row 1 reads frames 4..7: zeroing them changes it
    x2 = floats["X"].copy()
    x2[1, 4:] = 0.0
    masked = torch_op("row_conv").fn(
        X=torch.tensor(x2), Filter=torch.tensor(floats["Filter"]),
        Length=torch.tensor(ln))["Out"].numpy()
    assert not np.allclose(masked[1, 3], out[1, 3])
    assert g_grads["X"][1, 4:].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrn_op(dtype):
    rng = np.random.default_rng(9)
    # AlexNet's scale after conv1's relu: activations of order 10, so the
    # window sum moves mid well away from k
    x = (10.0 * np.abs(rng.standard_normal((2, 7, 5, 5)))).astype(np.float32)
    attrs = dict(n=5, k=2.0, alpha=1e-4, beta=0.75)
    got, want, g_grads, w_grads = _both("lrn", {"X": x}, {}, attrs,
                                        ("Out", "MidOut"), 9, dtype=dtype)
    fwd, grad = ((FWD_TOL, GRAD_TOL) if dtype == "float32" else
                 (BF16_FWD, BF16_GRAD))
    for o, g, w in zip(("Out", "MidOut"), got, want):
        assert g.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16)
        assert _rel(g, w) <= fwd, (o, _rel(g, w))
    assert _rel(g_grads["X"], w_grads["X"]) <= grad


def test_lrn_is_not_the_library_norm():
    """``F.local_response_norm`` averages the window (``alpha / n``): at
    the same attrs it is another function; with ``alpha * n`` it is this
    one."""
    rng = np.random.default_rng(10)
    x = torch.tensor((10.0 * rng.standard_normal((2, 8, 4, 4))
                      ).astype(np.float32))
    ours = torch_op("lrn").fn(X=x, n=5, k=2.0, alpha=1e-4, beta=0.75)["Out"]
    lib = F.local_response_norm(x, 5, alpha=1e-4, beta=0.75, k=2.0)
    assert _rel(lib, ours) > 100 * FWD_TOL
    lib_n = F.local_response_norm(x, 5, alpha=5e-4, beta=0.75, k=2.0)
    assert _rel(lib_n, ours) <= FWD_TOL
