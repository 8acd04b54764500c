"""The CTC, CRF and image-zoo ops of the port on the card against the same
ops on the CPU (paddle_tpu_torch only: no jax, so these run on a host
without it), and DeepSpeech2 and the CRF tagger training on the card
with every op's tensors there.  Every test needs an NVIDIA GPU and skips
without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ctc_crf.py

(``--noconftest`` because tests/conftest.py imports the JAX package.)
TF32 is off.  Tolerance: ORACLE_TOL's f32 bounds (2e-4 forward, 1e-3
gradient, of the largest magnitude), bf16's (2e-2, 5e-2) for ``lrn`` in
bf16; integer outputs equal."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.registry import get_op_impl as torch_op

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's run of the op")


def _rel(got, ref):
    d = (got.double().cpu() - ref.double().cpu()).abs().max().item()
    return d / max(ref.double().abs().max().item(), 1e-30)


def _on_both(op, floats, fixed, attrs, outs, dtype=torch.float32, n_diff=1):
    """``op`` on the card and on the CPU from the same inputs: each
    output, then the gradients of the float inputs under one seeded
    cotangent on the first ``n_diff`` outputs (none for ``n_diff=0``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            ts = {k: torch.tensor(v, device=dev).to(dtype).requires_grad_(
                n_diff > 0) for k, v in floats.items()}
            got = torch_op(op).fn(
                **ts, **{k: torch.tensor(v, device=dev)
                         for k, v in fixed.items()}, **attrs)
            vals = [got[o] for o in outs]
            grads = []
            if n_diff:
                gen = torch.Generator().manual_seed(1)
                total = sum((v.float() * torch.randn(
                    v.shape, generator=gen).to(dev)).sum()
                    for v in vals[:n_diff])
                grads = torch.autograd.grad(total, list(ts.values()))
            res[dev] = ([v.detach().cpu() for v in vals],
                        [g.cpu() for g in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res["cuda"], res["cpu"]


def _hold(card, cpu, fwd=2e-4, grad=1e-3):
    for g, w in zip(card[0], cpu[0]):
        if g.is_floating_point():
            assert _rel(g, w) <= fwd
        else:
            assert torch.equal(g, w)
    for g, w in zip(card[1], cpu[1]):
        assert _rel(g, w) <= grad


def test_warpctc_on_the_card_matches_the_cpu():
    """At DS2's path shape: b=32, 256 frames, vocab 29 + blank, labels of
    width 64 with lengths 20-40, frames 128-256."""
    _need_card()
    rng = np.random.default_rng(0)
    b, t, v = 32, 256, 30
    label = rng.integers(0, v - 1, (b, 64)).astype(np.int32)
    card, cpu = _on_both(
        "warpctc", {"Logits": rng.standard_normal((b, t, v))},
        {"Label": label,
         "LogitsLength": rng.integers(128, t + 1, b).astype(np.int32),
         "LabelLength": rng.integers(20, 41, b).astype(np.int32)},
        {"blank": v - 1}, ("Loss",))
    _hold(card, cpu)


def test_linear_chain_crf_on_the_card_matches_the_cpu():
    """At SRL's path shape: b=64, t=64, 67 tags, lengths 13-64."""
    _need_card()
    rng = np.random.default_rng(1)
    b, t, n = 64, 64, 67
    card, cpu = _on_both(
        "linear_chain_crf",
        {"Emission": rng.standard_normal((b, t, n)),
         "Transition": 0.1 * rng.standard_normal((n + 2, n))},
        {"Label": rng.integers(0, n, (b, t)),
         "Length": rng.integers(13, t + 1, b).astype(np.int32)},
        {}, ("LogLikelihood", "EmissionExps", "TransitionExps", "Alpha"))
    _hold(card, cpu)


@pytest.mark.parametrize("with_label", [False, True],
                         ids=["path", "label_mask"])
def test_crf_decoding_on_the_card_matches_the_cpu(with_label):
    _need_card()
    rng = np.random.default_rng(2)
    b, t, n = 64, 64, 67
    fixed = {"Length": rng.integers(13, t + 1, b).astype(np.int32)}
    if with_label:
        fixed["Label"] = rng.integers(0, n, (b, t))
    card, cpu = _on_both(
        "crf_decoding",
        {"Emission": rng.standard_normal((b, t, n)),
         "Transition": 0.1 * rng.standard_normal((n + 2, n))},
        fixed, {}, ("ViterbiPath",), n_diff=0)
    _hold(card, cpu)


def test_decoders_on_the_card_match_the_cpu():
    """``arg_max`` -> ``ctc_align`` -> ``edit_distance`` at DS2's path
    shape, from probabilities with ties."""
    _need_card()
    rng = np.random.default_rng(3)
    b, t, v = 32, 256, 30
    probs = np.round(rng.random((b, t, v)), 1).astype(np.float32)
    lens = rng.integers(128, t + 1, b).astype(np.int32)
    refs = rng.integers(0, v - 1, (b, 64))
    ref_len = rng.integers(20, 41, b).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        ids = torch_op("arg_max").fn(X=torch.tensor(probs, device=dev))["Out"]
        al = torch_op("ctc_align").fn(Input=ids,
                                      Length=torch.tensor(lens, device=dev),
                                      blank=v - 1)
        dist = torch_op("edit_distance").fn(
            Hyps=al["Output"], Refs=torch.tensor(refs, device=dev),
            HypsLength=al["OutputLength"],
            RefsLength=torch.tensor(ref_len, device=dev), normalized=True)
        out[dev] = [x.cpu() for x in (ids, al["Output"], al["OutputLength"],
                                      dist["Out"])]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)


def test_row_conv_on_the_card_matches_the_cpu():
    """At DS2's path shape: b=32, 256 frames, 512 features (the BiGRU's
    two directions), lookahead 4, ragged."""
    _need_card()
    rng = np.random.default_rng(4)
    card, cpu = _on_both(
        "row_conv", {"X": rng.standard_normal((32, 256, 512)),
                     "Filter": rng.standard_normal((5, 512))},
        {"Length": rng.integers(128, 257, 32).astype(np.int32)}, {},
        ("Out",))
    _hold(card, cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lrn_on_the_card_matches_the_cpu(dtype):
    """At AlexNet's conv1 shape: b=8 of the row's 128, 96 channels,
    55x55."""
    _need_card()
    rng = np.random.default_rng(5)
    card, cpu = _on_both(
        "lrn", {"X": 10.0 * np.abs(rng.standard_normal((8, 96, 55, 55)))},
        {}, dict(n=5, k=2.0, alpha=1e-4, beta=0.75), ("Out", "MidOut"),
        dtype=dtype)
    if dtype == torch.float32:
        _hold(card, cpu)
    else:
        _hold(card, cpu, fwd=2e-2, grad=5e-2)


def _train_on_the_card(build, rows):
    """Three steps of ``build``'s program on one batch fed through
    ``DataFeeder``: every tensor an op reads or writes lies on the card;
    the losses."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.core import registry

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        out = build(tpt)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    feed = tpt.DataFeeder(out["feed"]).feed(rows)
    seen = []
    real_call = registry.OpImpl.call

    def checked_call(self, ins, attrs, ctx, live=None):
        res = real_call(self, ins, attrs, ctx, live)
        for v in list(ins.values()) + list((res or {}).values()):
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(x, torch.Tensor) and x.device.type != "cuda":
                    seen.append((self.type, x.device))
        return res

    registry.OpImpl.call = checked_call
    try:
        losses = [float(exe.run(main, feed=feed, scope=scope,
                                fetch_list=[out["avg_cost"]])[0][0])
                  for _ in range(3)]
    finally:
        registry.OpImpl.call = real_call
    assert not seen, seen[:5]
    return losses


def test_deep_speech2_trains_on_the_card_without_a_cpu_tensor():
    _need_card()
    rng = np.random.default_rng(6)
    rows = [(rng.standard_normal((int(rng.integers(20, 33)), 16)
                                 ).astype(np.float32).tolist(),
             rng.integers(0, 9, int(rng.integers(3, 7))).tolist())
            for _ in range(8)]
    losses = _train_on_the_card(lambda tpt: tpt.models.deep_speech2.build(
        feat_dim=16, max_audio_len=32, max_label_len=8, rnn_size=32,
        num_rnn_layers=2, vocab_size=9, learning_rate=5e-3), rows)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_srl_trains_on_the_card_without_a_cpu_tensor():
    _need_card()
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(8):
        n = int(rng.integers(4, 13))
        cols = [rng.integers(0, 100, n).tolist() for _ in range(6)]
        cols += [rng.integers(0, high, n).tolist() for high in (20, 2, 7)]
        rows.append(tuple(cols))
    losses = _train_on_the_card(
        lambda tpt: tpt.models.label_semantic_roles.build(
            word_dict_len=100, label_dict_len=7, pred_dict_len=20,
            max_len=12, word_dim=8, hidden_dim=32, depth=2,
            learning_rate=0.01), rows)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
