"""Temperature sampling in the port's ``models.transformer.generate`` and
the ops that draw inside them (``sampling_id``, ``nce``'s negatives),
against the JAX package on the CPU.

The port draws from a ``torch.Generator`` and the reference from a
threefry key, so no draw is compared bit for bit: the distributions are.
Each test takes n = 4096 draws from a seeded generator and holds the
empirical histogram ``q`` against the reference's distribution ``p``:

- total variation ``0.5 * sum |q - p| <= 0.06``: for k categories its
  mean is at most ``0.5 * sqrt(2 k / (pi n))`` (0.031 at k = 24), and
  its spread over seeds is a few thousandths;
- Pearson's ``chi2 = n * sum (q - p)**2 / p`` over the categories with
  ``n p >= 5`` (the rest pooled) within ``df + 6 sqrt(2 df)`` (six
  standard deviations of the chi-square law over its mean ``df``).

The reference's ``p`` is ``softmax(logits / T)`` of the JAX package's own
logits for ``generate``, and ``softmax(log X)`` for ``sampling_id``;
``nce``'s negatives are uniform over the classes.  Greedy decoding
(``temperature=0``) draws nothing: its tokens and logits do not depend on
``key``, and each new token is the argmax of the step's logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.random_ops import categorical
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

VOCAB, NL, NH, DM, T = 24, 2, 2, 16, 12
N = 4096
TV_BOUND = 0.06


def _chi2_bound_ok(q, p, n):
    """Pearson's statistic of the counts ``n q`` against ``p`` within six
    standard deviations of its mean (the small cells pooled)."""
    big = n * p >= 5
    qs = np.append(q[big], q[~big].sum())
    ps = np.append(p[big], p[~big].sum())
    keep = ps > 0
    qs, ps = qs[keep], ps[keep]
    chi2 = n * np.sum((qs - ps) ** 2 / ps)
    df = len(ps) - 1
    return chi2 <= df + 6 * np.sqrt(2 * df), (chi2, df)


def _hold(draws, p):
    q = np.bincount(np.asarray(draws).reshape(-1), minlength=len(p)) / \
        np.asarray(draws).size
    tv = 0.5 * np.abs(q - p).sum()
    ok, stat = _chi2_bound_ok(q, p, np.asarray(draws).size)
    assert tv <= TV_BOUND, tv
    assert ok, stat
    return tv


@pytest.fixture(scope="module")
def params():
    """The JAX program's weights (2 layers, d16, vocab 24), the LM head
    scaled by 3 so the next-token distribution is far from uniform
    (its largest probabilities 0.50, 0.20, 0.15 at T = 0.8)."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        jtr.build(vocab_size=VOCAB, n_layer=NL, n_head=NH, d_model=DM,
                  max_len=T, dropout_rate=0.0, dtype="float32")
    pt.Executor().run(startup)
    params = jtr.extract_params(program=main)
    params["lm_head.w"] = params["lm_head.w"] * 3.0
    return params


def _gen(params, prompt, **kw):
    return ttr.generate(params, prompt, max_len=kw.pop("max_len", T),
                        n_layer=NL, n_head=NH, d_model=DM, device="cpu", **kw)


def test_greedy_draws_nothing_and_follows_the_argmax(params):
    """``temperature=0``: the same tokens and logits, bit for bit, with or
    without ``key``; from the prompt's end each token is the argmax of the
    previous step's logits; the prompt is kept."""
    prompt = np.array([[3, 5, 7], [1, 2, 4]], np.int32)
    toks, logits = _gen(params, prompt)
    toks_k, logits_k = _gen(params, prompt, key=123)
    assert torch.equal(toks, toks_k) and torch.equal(logits, logits_k)
    np.testing.assert_array_equal(toks.numpy()[:, :3], prompt)
    for t in range(2, T - 1):
        np.testing.assert_array_equal(
            toks.numpy()[:, t + 1], logits[:, t].argmax(-1).numpy())
    jt, _ = jtr.generate(params, prompt, max_len=T, n_layer=NL, n_head=NH,
                         d_model=DM)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))


def test_sampling_without_a_key_raises(params):
    with pytest.raises(ValueError, match="key"):
        _gen(params, np.array([[1]], np.int32), temperature=0.8)
    with pytest.raises(ValueError, match="key"):
        jtr.generate(params, np.array([[1]], np.int32), max_len=T,
                     n_layer=NL, n_head=NH, d_model=DM, temperature=0.8)


def test_same_seed_same_tokens(params):
    """An int seed and a generator seeded alike give the same tokens; the
    prompt is kept; another seed gives other tokens."""
    prompt = np.array([[3, 5], [8, 1], [2, 2]], np.int32)
    a, _ = _gen(params, prompt, temperature=0.8, key=7)
    b, _ = _gen(params, prompt, temperature=0.8, key=7)
    g = torch.Generator().manual_seed(7)
    c, _ = _gen(params, prompt, temperature=0.8, key=g)
    d, _ = _gen(params, prompt, temperature=0.8, key=8)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, d)
    np.testing.assert_array_equal(a.numpy()[:, :2], prompt)
    assert ((a >= 0) & (a < VOCAB)).all()


@pytest.mark.parametrize("temperature", [0.8, 2.0])
def test_first_sample_follows_the_references_softmax(params, temperature):
    """4096 rows of one prompt: the first sampled token's histogram
    against ``softmax(logits / T)`` of the JAX package's logits at the
    prompt's last position (TV and chi-square bounds above); the
    distribution itself is far from uniform, so a wrong temperature or a
    uniform draw would fail."""
    prompt = np.array([[4, 9, 2]], np.int32)
    _, jl = jtr.generate(params, prompt, max_len=4, n_layer=NL, n_head=NH,
                         d_model=DM)
    p = np.asarray(jax.nn.softmax(jnp.asarray(jl)[0, 2] / temperature),
                   np.float64)
    assert 0.5 * np.abs(p - 1.0 / VOCAB).sum() > 0.3
    toks, _ = _gen(params, np.repeat(prompt, N, axis=0), max_len=4,
                   temperature=temperature, key=0, return_logits=False)
    np.testing.assert_array_equal(toks.numpy()[:, :3],
                                  np.repeat(prompt, N, axis=0))
    _hold(toks.numpy()[:, 3], p)
    # half the temperature's distribution is another one: the bound bites
    p_other = np.asarray(jax.nn.softmax(
        jnp.asarray(jl)[0, 2] / (temperature * 2)), np.float64)
    assert 0.5 * np.abs(p_other - p).sum() > TV_BOUND


def test_tiny_temperature_is_greedy(params):
    prompt = np.array([[3, 5, 7], [1, 2, 4]], np.int32)
    greedy, _ = _gen(params, prompt)
    cold, _ = _gen(params, prompt, temperature=1e-4, key=3)
    assert torch.equal(greedy, cold)


def test_sampling_id_follows_the_rows_distribution():
    """``sampling_id`` on 4096 copies of one unnormalised row, with a
    seeded generator, against ``softmax(log X)`` (the reference's
    categorical over ``log X``)."""
    x = np.array([0.05, 0.3, 1e-30, 0.9, 0.15, 0.6, 0.01, 0.2], np.float32)
    p = np.asarray(jax.nn.softmax(jnp.log(jnp.maximum(x, 1e-20))),
                   np.float64)
    out = torch_op("sampling_id").fn(
        X=torch.tensor(np.tile(x, (N, 1))),
        _gen=torch.Generator().manual_seed(0))["Out"]
    assert out.dtype == torch.int32 and tuple(out.shape) == (N,)
    assert (out != 2).all()                         # a zero-probability id
    _hold(out.numpy(), p)


def test_categorical_is_softmax_of_the_logits():
    logits = torch.tensor([[1.0, -2.0, 0.5, 3.0, 0.0]]).repeat(N, 1)
    draws = categorical(logits, torch.Generator().manual_seed(5))
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits[0].numpy())),
                   np.float64)
    _hold(draws.numpy(), p)


def test_sampling_id_in_a_program_advances_with_the_step():
    """Through the v1 layer and the Executor: the step's generator lives
    in the scope, so a fresh scope repeats the draws and the next step
    draws anew."""
    probs = np.full((64, 6), 1.0, np.float32)
    runs = []
    for _ in range(2):
        tpt.core.unique_name.reset()
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup):
            p = tpt.layers.data("p", shape=[6])
            ids = tpt.compat.v1.sampling_id_layer(p)
        scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
        exe.run(startup, scope=scope)
        runs.append([exe.run(main, feed={"p": probs}, fetch_list=[ids],
                             scope=scope)[0] for _ in range(2)])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert not np.array_equal(runs[0][0], runs[0][1])


def test_nce_negatives_are_uniform():
    """``nce``'s negatives: 512 rows of 8 over 16 classes from the step's
    generator, uniform (TV and chi-square bounds); the first sample
    column is the label."""
    rng = np.random.default_rng(2)
    b, k, classes = 512, 8, 16
    labels = rng.integers(0, classes, (b, 1))
    out = torch_op("nce").fn(
        Input=torch.tensor(rng.normal(size=(b, 4)).astype(np.float32)),
        Label=torch.tensor(labels),
        Weight=torch.tensor(rng.normal(size=(classes, 4)).astype(
            np.float32)),
        num_neg_samples=k, num_total_classes=classes,
        _gen=torch.Generator().manual_seed(1))
    ids = out["SampleLabels"].numpy()
    assert ids.shape == (b, k + 1) and ids.dtype == np.int32
    p = np.full(classes, 1.0 / classes)
    _hold(ids[:, 1:], p)
    np.testing.assert_array_equal(ids[:, 0], labels[:, 0])
