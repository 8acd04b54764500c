"""The port's flash attention (paddle_tpu_torch/kernels/flash_attention.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

The same seeded numpy inputs go through ``flash_attention`` /
``flash_attention_packed`` / ``flash_attention_with_lse`` of
``paddle_tpu.ops.pallas_attention`` (explicit 16-wide blocks at t=64, so
the kernel walks a 4x4 grid of tiles, not one degenerate tile) and
through the port's plain PyTorch versions, which the CPU path uses and
the CUDA kernels are held against on the card.  Compared: ``o``, ``lse``
and ``dq, dk, dv`` from one cotangent.

Tolerance: ``ORACLE_TOL`` (max |a - b| / max |b|) — f32 fwd 2e-4 / grad
1e-3, bf16 fwd 2e-2 / grad 5e-2: the blocked online softmax reassociates
the f32 sums, and in bf16 the two sides round ``p`` and ``ds`` at tile
rather than row granularity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu_torch.core.scope import tensor_from_numpy
from paddle_tpu_torch.kernels import flash_attention as tfa

B, T, BLK = 2, 64, 16
# name -> (n_head, d_head, packed): the three head geometries the layer
# emits — 4-D op at d16, paired d64 heads, one 128-wide head
GEOMS = {"d16_4d": (2, 16, False), "d64_paired": (2, 64, True),
         "d128_one_head": (1, 128, True)}


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _inputs(h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, h, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_forward_and_backward_match_the_pallas_kernels(geom, dtype, causal):
    h, d, packed = GEOMS[geom]
    q, k, v, do = _inputs(h, d, seed=h * d)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))

    if packed:
        flat = lambda x: x.reshape(B, T, h * d)  # noqa: E731

        def f(a, b_, c):
            return jfa.flash_attention_packed(
                flat(a), flat(b_), flat(c), h, causal=causal, block_q=BLK,
                block_k=BLK).reshape(B, T, h, d)
    else:
        def f(a, b_, c):
            return jfa.flash_attention(a, b_, c, causal=causal, block_q=BLK,
                                       block_k=BLK)
    jo, vjp = jax.vjp(f, jq, jk, jv)
    jgrads = vjp(jdo)

    # the reference's arrays cross as numpy (bf16 as the extension type)
    tq, tk, tv, tdo = (tensor_from_numpy(np.asarray(x))
                       for x in (jq, jk, jv, jdo))
    assert tq.dtype == getattr(torch, dtype)
    to, tlse = tfa.flash_attention_ref(tq, tk, tv, causal)
    assert to.dtype == tq.dtype and tlse.shape == (B * h, T)
    assert _rel(_np(to), jo) <= tfa.oracle_tol(dtype, "fwd")
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, to, tlse, tdo, None, causal)
    for name, g, want in zip(("dq", "dk", "dv"), got, jgrads):
        assert g.dtype == tq.dtype
        assert _rel(_np(g), want) <= tfa.oracle_tol(dtype, "grad"), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_and_its_cotangent_match(dtype):
    """``flash_attention_with_lse``: o, lse [b, h, t] and the gradients of
    a loss that reads both outputs (the ``dlse`` input of the backward)."""
    h, d = 2, 16
    q, k, v, do = _inputs(h, d, seed=5)
    dlse = np.random.default_rng(6).standard_normal((B, h, T)).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))

    def f(a, b_, c):
        return jfa.flash_attention_with_lse(a, b_, c, causal=True,
                                            block_q=BLK, block_k=BLK)
    (jo, jlse), vjp = jax.vjp(f, jq, jk, jv)
    jgrads = vjp((jdo, jnp.asarray(dlse)))

    tq, tk, tv, tdo = (tensor_from_numpy(np.asarray(x)).requires_grad_(i < 3)
                       for i, x in enumerate((jq, jk, jv, jdo)))
    to, tlse = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
    assert tlse.shape == (B, h, T) and tlse.dtype == torch.float32
    assert _rel(_np(to), jo) <= tfa.oracle_tol(dtype, "fwd")
    assert _rel(_np(tlse), jlse) <= tfa.oracle_tol(dtype, "fwd")
    torch.autograd.backward([to, tlse], [tdo, torch.from_numpy(dlse)])
    for name, x, want in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        assert _rel(_np(x.grad), want) <= tfa.oracle_tol(dtype, "grad"), name


def test_packed_equals_4d_on_the_same_memory():
    h, d = 2, 64
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(h, d, seed=9))
    o4 = tfa.flash_attention(q, k, v, causal=True)
    op = tfa.flash_attention_packed(
        q.reshape(B, T, h * d), k.reshape(B, T, h * d),
        v.reshape(B, T, h * d), h, causal=True)
    assert torch.equal(op.reshape(B, T, h, d), o4)


def test_packed_sub_heads_rule_is_the_reference_rule():
    for n_head in (1, 2, 3, 6, 8):
        for d_head in (16, 64, 100, 128, 256):
            assert (tfa.packed_sub_heads(n_head, d_head)
                    == jfa.packed_sub_heads(n_head, d_head))


def test_autograd_function_saves_exactly_the_residual_contract(monkeypatch):
    """Forward saves (q, k, v, o, lse) and nothing else; backward is one
    ``flash_bwd`` call and never re-runs the forward."""
    assert tfa.FLASH_BWD_RESIDUALS == jfa.FLASH_BWD_RESIDUALS
    h, d = 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(h, d, seed=3))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tfa.flash_fwd, tfa.flash_bwd

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        assert len(a) >= 7 and a[6] is None          # no lse cotangent
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", fwd)
    monkeypatch.setattr(tfa, "flash_bwd", bwd)
    o = tfa.flash_attention(q, k, v, causal=True)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == len(tfa.FLASH_BWD_RESIDUALS)
    assert saved[0].data_ptr() == q.data_ptr()
    assert saved[1].data_ptr() == k.data_ptr()
    assert saved[2].data_ptr() == v.data_ptr()
    assert saved[3].data_ptr() == o.data_ptr()
    assert saved[4].shape == (B * h, T) and saved[4].dtype == torch.float32
    o.backward(do)
    assert calls == {"fwd": 1, "bwd": 1}
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_cpu_launch_counters_stay_at_zero():
    """A wrapper adds to its count where it launches its kernel, and
    nowhere else: CPU tensors take the plain version and count nothing."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 16, seed=4))
    f0, b0 = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    o, lse = tfa.flash_fwd(q, k, v, True)
    tfa.flash_bwd(q, k, v, o, lse, do, None, True)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == (f0, b0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gradcheck_of_the_plain_path_in_f64(causal):
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal((1, 5, 2, 4)),
                            dtype=torch.float64, requires_grad=True)
               for _ in range(3))

    def f(a, b_, c):
        return tfa.flash_attention_with_lse(a, b_, c, causal=causal)
    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


def test_ragged_and_unequal_lengths_follow_the_position_rule():
    """t_q > t_k under the causal rule q_pos >= k_pos (positions from 0):
    against dense softmax attention written out here."""
    rng = np.random.default_rng(2)
    b, t_q, t_k, h, d = 1, 7, 5, 2, 8
    q = torch.tensor(rng.standard_normal((b, t_q, h, d)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((b, t_k, h, d)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((b, t_k, h, d)), dtype=torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    keep = torch.arange(t_q)[:, None] >= torch.arange(t_k)[None, :]
    s = s.masked_fill(~keep, float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    got, lse = tfa.flash_fwd(q, k, v, True)
    assert _rel(got, want) <= 1e-6
    assert _rel(lse.reshape(b, h, t_q), torch.logsumexp(s, -1)) <= 1e-6


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, q[:, :, :1], q)
    with pytest.raises(ValueError):
        tfa.flash_fwd(q.reshape(1, 4, 16), q, q)
    with pytest.raises(ValueError):
        tfa.flash_attention_packed(q.reshape(1, 4, 16), q.reshape(1, 4, 16),
                                   q.reshape(1, 4, 16), n_head=3)
    o, lse = tfa.flash_fwd(q, q, q)
    with pytest.raises(ValueError):
        tfa.flash_bwd(q, q, q, o, lse[:, :2], q)
