"""The port's GPT serving math (paddle_tpu_torch/models/transformer.py)
against the JAX package's: weights from a tiny JAX program (2 layers,
d32, h2, vocab 50, max_len 32) carried across by ``params_from_numpy``;
``generate`` must give equal tokens and logits within 1e-4 (f32, CPU),
and ``infer_compute_dtype`` must pick the same dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

VOCAB, NL, NH, DM, T = 50, 2, 2, 32, 32


def _make_params(seed=11):
    """The JAX program's initial weights, with seeded noise on every
    LayerNorm and bias vector so the affine terms are exercised too."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        jtr.build(vocab_size=VOCAB, n_layer=NL, n_head=NH, d_model=DM,
                  max_len=T, dropout_rate=0.0, dtype="float32")
    pt.Executor().run(startup)
    params = jtr.extract_params(program=main)
    rng = np.random.default_rng(seed)
    for k, v in params.items():
        if v.ndim == 1:
            params[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return params


@pytest.fixture(scope="module")
def params():
    return _make_params()


@pytest.mark.parametrize("p_len,batch", [(1, 1), (5, 1), (7, 2)])
def test_generate_matches_jax(params, p_len, batch):
    rng = np.random.default_rng(p_len)
    prompt = rng.integers(1, VOCAB, (batch, p_len)).astype(np.int32)
    jt, jl = jtr.generate(params, prompt, max_len=T, n_layer=NL, n_head=NH,
                          d_model=DM)
    tt, tl = ttr.generate(params, prompt, max_len=T, n_layer=NL, n_head=NH,
                          d_model=DM, device="cpu")
    assert tt.dtype == torch.int32 and tl.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert float(np.max(np.abs(tl.numpy() - np.asarray(jl)))) <= 1e-4


def test_generate_without_logits(params):
    prompt = np.array([[3, 1, 4]], np.int32)
    full, _ = ttr.generate(params, prompt, max_len=12, n_layer=NL,
                           n_head=NH, d_model=DM, device="cpu")
    toks, logits = ttr.generate(params, prompt, max_len=12, n_layer=NL,
                                n_head=NH, d_model=DM, device="cpu",
                                return_logits=False)
    assert logits is None
    np.testing.assert_array_equal(toks.numpy(), full.numpy())
    np.testing.assert_array_equal(toks.numpy()[0, :3], prompt[0])


def test_generate_rejects_what_is_not_ported(params):
    """Sampling without a generator raises as the reference does
    (``ValueError``), and so does a length past the position table."""
    prompt = np.array([[1, 2]], np.int32)
    with pytest.raises(ValueError, match="key"):
        ttr.generate(params, prompt, max_len=8, n_layer=NL, n_head=NH,
                     d_model=DM, temperature=0.7, device="cpu")
    with pytest.raises(ValueError):
        ttr.generate(params, prompt, max_len=T + 1, n_layer=NL, n_head=NH,
                     d_model=DM, device="cpu")


def test_entry_points_raise_without_a_card(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    prompt = np.array([[1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.generate(params, prompt, max_len=8, n_layer=NL, n_head=NH,
                     d_model=DM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.params_from_numpy(params)


def test_params_from_numpy_keeps_names_layout_and_bf16_bits(params):
    got = ttr.params_from_numpy(params, device="cpu")
    assert list(got) == list(params)
    for k, v in params.items():
        assert tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    # bf16 arrays from the JAX side cross bit for bit
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
          for k, v in params.items()}
    got = ttr.params_from_numpy(bf, device="cpu")
    for k, v in bf.items():
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy(), v.view(np.int16))
    cast = ttr.params_from_numpy(params, device="cpu", dtype="bfloat16")
    for k, v in bf.items():
        np.testing.assert_array_equal(
            cast[k].view(torch.int16).numpy(), v.view(np.int16))


def _with_dtypes(params, dtype, keys):
    return {k: (np.asarray(jnp.asarray(v, dtype)) if keys(k) else v)
            for k, v in params.items()}


@pytest.mark.parametrize("case", ["f32", "bf16_blocks", "bf16_embedding_only",
                                  "f16_head", "no_block_names"])
def test_infer_compute_dtype_matches_jax(params, case):
    if case == "f32":
        p = params
    elif case == "bf16_blocks":
        p = _with_dtypes(params, jnp.bfloat16,
                         lambda k: k.startswith(("block", "lm_head"))
                         and k.endswith(".w"))
    elif case == "bf16_embedding_only":
        p = _with_dtypes(params, jnp.bfloat16, lambda k: "emb" in k)
    elif case == "f16_head":
        p = _with_dtypes(params, jnp.float16, lambda k: k == "lm_head.w")
    else:
        p = {"emb": np.zeros((4, 4), np.float32),
             "proj": np.asarray(jnp.zeros((4, 4), jnp.bfloat16))}
    want = jnp.dtype(jtr.infer_compute_dtype(p)).name
    got = ttr.infer_compute_dtype(p)
    assert str(got) == f"torch.{want}"
    # tensors answer the same as the numpy arrays they came from
    tp = {k: ttr._to_tensor(v) for k, v in p.items()}
    assert ttr.infer_compute_dtype(tp) == got
