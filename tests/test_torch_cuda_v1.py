"""The v1 layer DSL's ops, a v1 config and temperature sampling on the
card against the same on the CPU (paddle_tpu_torch only: no jax, so these
run on a host without it).  Every test needs an NVIDIA GPU and skips
without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_v1.py

(``--noconftest`` because tests/conftest.py imports the JAX package.)
TF32 is off.  The ops' cases, at mid sizes, and their comparison are
``chip_smoke.py`` phase 20c's (``v1_op_cases``, ``_op_on``, ``_agree``).
Tolerance: ORACLE_TOL's f32 bounds (2e-4 forward, 1e-3 gradient, of the
largest magnitude); integer outputs equal.  The draws
(``sampling_id``, ``generate``'s temperature, ``nce``'s negatives) are
held by total variation over n = 4096 draws (bound 0.08; its mean is at
most 0.5 * sqrt(2 k / (pi n)), 0.044 at k = 32 categories)."""

import importlib.util
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import get_op_impl as torch_op

pytestmark = pytest.mark.cuda

TV_BOUND, N = 0.08, 4096


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's run of the op")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# one table of the ops' cases, with its runner and its bounds: phase 20c's
_SMOKE_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SMOKE_SPEC)
_SMOKE_SPEC.loader.exec_module(smoke)
CASES = {op: case for op, *case in
         smoke.v1_op_cases(np, np.random.default_rng(0))}


@pytest.mark.parametrize("op", list(CASES))
def test_op_on_the_card_matches_the_cpu(op):
    _need_card()
    case = CASES[op]
    smoke._agree(np, op, smoke._op_on(torch, op, *case, "cuda", 7),
                 smoke._op_on(torch, op, *case, "cpu", 7))


def _tv(draws, p):
    q = np.bincount(draws.reshape(-1), minlength=p.size) / draws.size
    return 0.5 * np.abs(q - p).sum()


def test_nce_on_the_card_on_its_own_negatives():
    """The CPU op on the card's drawn negatives gives the card's cost; the
    negatives are uniform over 32 classes."""
    _need_card()
    rng = np.random.default_rng(3)
    floats = {"Input": rng.normal(size=(512, 8)).astype(np.float32),
              "Weight": rng.normal(size=(32, 8)).astype(np.float32),
              "Bias": rng.normal(size=32).astype(np.float32)}
    fixed = {"Label": rng.integers(0, 32, (512, 1))}
    attrs = {"num_neg_samples": 8, "num_total_classes": 32}
    outs = ("Cost", "SampleLogits", "SampleLabels")
    card = smoke._op_on(torch, "nce", floats, fixed, attrs, outs, "cuda", 7,
                        torch.Generator(device="cuda").manual_seed(0))
    neg = torch.tensor(card[0][2][:, 1:], dtype=torch.int64)
    with mock.patch.object(torch, "randint", return_value=neg):
        cpu = smoke._op_on(torch, "nce", floats, fixed, attrs, outs, "cpu",
                           7, torch.Generator())
    smoke._agree(np, "nce", card, cpu)
    assert _tv(card[0][2][:, 1:].astype(np.int64), np.full(32, 1 / 32)) \
        <= TV_BOUND


def test_sampling_id_on_the_card_follows_the_row():
    _need_card()
    row = np.array([0.05, 0.3, 0.0, 0.9, 0.15, 0.6, 0.01, 0.2], np.float32)
    ids = torch_op("sampling_id").fn(
        X=torch.tensor(np.tile(row, (N, 1)), device="cuda"),
        _gen=torch.Generator(device="cuda").manual_seed(0))["Out"]
    assert ids.dtype == torch.int32 and (ids != 2).all()
    assert _tv(ids.cpu().numpy(), row / row.sum()) <= TV_BOUND


def _gpt_params(rng, vocab=64, n_layer=2, d=32):
    def w(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    p = {"tok_emb.w": w(vocab, d), "pos_emb.w.w": w(32, d),
         "ln_f.scale": np.ones(d, np.float32),
         "ln_f.bias": np.zeros(d, np.float32), "lm_head.w": 20 * w(d, vocab)}
    for i in range(n_layer):
        for ln in ("ln1", "ln2"):
            p[f"block{i}_{ln}.scale"] = np.ones(d, np.float32)
            p[f"block{i}_{ln}.bias"] = np.zeros(d, np.float32)
        for nm in ("att_q", "att_k", "att_v", "att_out"):
            p[f"block{i}_{nm}.w"] = w(d, d)
            p[f"block{i}_{nm}.b"] = np.zeros(d, np.float32)
        p[f"block{i}_ffn1.w"] = w(d, 4 * d)
        p[f"block{i}_ffn1.b"] = np.zeros(4 * d, np.float32)
        p[f"block{i}_ffn2.w"] = w(4 * d, d)
        p[f"block{i}_ffn2.b"] = np.zeros(d, np.float32)
    return p


def test_generate_samples_on_the_card():
    """Temperature 0.8 on the card: the same seed twice the same tokens,
    the prompt kept; 4096 rows' first sampled token against
    ``softmax(logits / 0.8)`` (over the 31 likeliest tokens and the rest);
    temperature 0 the CPU's greedy tokens."""
    _need_card()
    from paddle_tpu_torch.models import transformer

    params = _gpt_params(np.random.default_rng(0))
    prompt = np.array([[3, 9, 4, 1]], np.int32)
    kw = dict(n_layer=2, n_head=2, d_model=32)
    a, _ = transformer.generate(params, prompt, 12, temperature=0.8, key=5,
                                device="cuda", **kw)
    b, _ = transformer.generate(params, prompt, 12, temperature=0.8, key=5,
                                device="cuda", **kw)
    assert torch.equal(a, b) and (a[0, :4].cpu().numpy() == prompt[0]).all()
    greedy, logits = transformer.generate(params, prompt, 12, device="cuda",
                                          **kw)
    cpu, _ = transformer.generate(params, prompt, 12, device="cpu", **kw)
    np.testing.assert_array_equal(greedy.cpu().numpy(), cpu.numpy())
    p = torch.softmax(logits[0, 3].double() / 0.8, 0).cpu().numpy()
    many, _ = transformer.generate(params, np.repeat(prompt, N, 0), 5,
                                   temperature=0.8, key=6, device="cuda",
                                   return_logits=False, **kw)
    draws = many[:, 4].long().cpu().numpy()
    top = np.argsort(-p)[:31]
    q = np.bincount(draws, minlength=p.size) / N
    tv = 0.5 * (np.abs(q[top] - p[top]).sum()
                + abs(q[top].sum() - p[top].sum()))
    assert tv <= TV_BOUND, tv


def test_v1_config_on_the_card_matches_the_cpu():
    """run.py's smallnet row in v1 names, from one startup state: the
    first step's loss within 2e-4 and every parameter's update within
    2e-4 (norm of the difference over the CPU's) of the CPU's step."""
    _need_card()

    def build():
        pt.core.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            v1 = pt.compat.v1
            net = v1.data_layer("data", size=3 * 32 * 32, height=32,
                                width=32)
            label = v1.data_layer("label", size=1, is_label=True)
            net = v1.img_conv_layer(input=net, filter_size=5,
                                    num_filters=16, padding=2)
            net = v1.img_pool_layer(input=net, pool_size=3, stride=2,
                                    padding=1, pool_type=v1.AvgPooling())
            out = v1.fc_layer(input=net, size=10,
                              act=v1.SoftmaxActivation())
            cost = v1.classification_cost(input=out, label=label)
            v1.settings(learning_rate=0.01,
                        learning_method=v1.MomentumOptimizer(0.9),
                        regularization=v1.L2Regularization(1e-4)).minimize(
                cost)
        return main, startup, cost

    rng = np.random.default_rng(1)
    feed = {"data": rng.normal(size=(16, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (16, 1))}
    main, startup, cost = build()
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: scope.get(v.name).detach().cpu().clone()
             for v in main.persistable_vars()}
    cscope = pt.load_numpy_state(
        pt.Scope(), {k: v.clone() for k, v in state.items()}, device="cpu")
    (want,) = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                             fetch_list=[cost], scope=cscope)
    (got,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert abs(float(got[0]) - float(want[0])) <= 2e-4 * abs(float(want[0]))
    for p in main.all_parameters():
        d_card = scope.get(p.name).detach().cpu() - state[p.name]
        d_cpu = cscope.get(p.name) - state[p.name]
        assert float((d_card - d_cpu).norm()) <= 2e-4 * float(
            d_cpu.norm()), p.name
