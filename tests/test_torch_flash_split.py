"""The backward route of the port's flash attention — fused, or the split
dq + dk/dv pair — against the JAX package's ``_flash_bwd``.

* With ``FUSED_BWD_PARTIAL_BYTES`` patched to 0 in BOTH packages, the
  port's split-route gradients (its plain version on the CPU) match the
  JAX package's split Pallas kernels run in interpret mode with 16-wide
  blocks at t=64, in the 4-D layout, packed d=128 (one head a slice) and
  packed d=64 (two heads a slice), causal and not, with and without an
  ``lse`` cotangent; f32 at ``ORACLE_TOL``'s flash grad bound (1e-3).
* The port's split and fused routes agree (``dk``, ``dv`` bit-equal on
  the CPU plain path), and the route is counted on either device.
* ``bwd_route`` equals the reference's choice, read by tracing
  ``_flash_bwd`` under ``jax.eval_shape`` (abstract, nothing runs) with
  ``_flash_bwd_fused`` wrapped in a recorder: at the flagship's b=8, h=6,
  d=128 in bf16, t=4096 is fused and t=8192 and t=16384 are split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

B, T, BLK = 2, 64, 16
# name -> (n_head, d_head, packed)
GEOMS = {"4d_d16": (2, 16, False), "packed_d128": (1, 128, True),
         "packed_d64_paired": (2, 64, True)}


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, h, d)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture
def split_everywhere(monkeypatch):
    """Both packages take the split route for every shape."""
    monkeypatch.setattr(jfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    fused_calls = []
    real = jfa._flash_bwd_fused

    def record(*a, **kw):
        fused_calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(jfa, "_flash_bwd_fused", record)
    return fused_calls


def _jax_grads(f, q, k, v, cts):
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(cts)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_split_route_matches_the_jax_split_kernels(geom, causal,
                                                   split_everywhere):
    h, d, packed = GEOMS[geom]
    q, k, v, do = _inputs(h, d, seed=h * d + causal)
    flat = lambda x: x.reshape(B, T, h * d)  # noqa: E731
    if packed:
        def f(a, b_, c):
            return jfa.flash_attention_packed(
                flat(a), flat(b_), flat(c), h, causal=causal, block_q=BLK,
                block_k=BLK).reshape(B, T, h, d)
    else:
        def f(a, b_, c):
            return jfa.flash_attention(a, b_, c, causal=causal, block_q=BLK,
                                       block_k=BLK)
    want = _jax_grads(f, q, k, v, jnp.asarray(do))
    assert split_everywhere == []          # the reference took the split pair

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(tfa.BWD_ROUTE_CALLS)
    if packed:
        o = tfa.flash_attention_packed(flat(tq), flat(tk), flat(tv), h,
                                       causal, block_q=BLK, block_k=BLK)
        o = o.reshape(B, T, h, d)
    else:
        o = tfa.flash_attention(tq, tk, tv, causal, block_q=BLK, block_k=BLK)
    o.backward(torch.from_numpy(do))
    assert tfa.BWD_ROUTE_CALLS["split"] == before["split"] + 1
    assert tfa.BWD_ROUTE_CALLS["fused"] == before["fused"]
    tol = tfa.oracle_tol(torch.float32, "grad")
    for name, x, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert _rel(x.grad.numpy(), w) <= tol, name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_route_with_an_lse_cotangent(causal, split_everywhere):
    """``flash_attention_with_lse``: the ``dlse`` input of both split
    kernels (it enters ``delta``)."""
    h, d = 2, 16
    q, k, v, do = _inputs(h, d, seed=11 + causal)
    dlse = np.random.default_rng(12).standard_normal((B, h, T)).astype(
        np.float32)

    def f(a, b_, c):
        return jfa.flash_attention_with_lse(a, b_, c, causal=causal,
                                            block_q=BLK, block_k=BLK)
    want = _jax_grads(f, q, k, v, (jnp.asarray(do), jnp.asarray(dlse)))
    assert split_everywhere == []

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal, block_q=BLK,
                                          block_k=BLK)
    torch.autograd.backward([o, lse], [torch.from_numpy(do),
                                       torch.from_numpy(dlse)])
    tol = tfa.oracle_tol(torch.float32, "grad")
    for name, x, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert _rel(x.grad.numpy(), w) <= tol, name


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
def test_port_split_and_fused_routes_agree(with_dlse, monkeypatch):
    h, d = 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(h, d, seed=21))
    o, lse = tfa.flash_fwd(q, k, v, True)
    dlse = (torch.from_numpy(np.random.default_rng(22).standard_normal(
        (B * h, T)).astype(np.float32)) if with_dlse else None)
    before = dict(tfa.BWD_ROUTE_CALLS)
    fused = tfa.flash_bwd(q, k, v, o, lse, do, dlse, True)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    split = tfa.flash_bwd(q, k, v, o, lse, do, dlse, True)
    assert tfa.BWD_ROUTE_CALLS == {"fused": before["fused"] + 1,
                                    "split": before["split"] + 1}
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2], fused[2])
    assert _rel(split[0], fused[0]) <= 1e-6
    # the split wrappers alone: their plain versions on CPU tensors, no
    # launch counted
    l0 = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    dq = tfa.flash_bwd_dq(q, k, v, o, lse, do, dlse, True)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, o, lse, do, dlse, True)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == l0
    assert torch.equal(dq, split[0]) and torch.equal(dk, split[1])
    assert torch.equal(dv, split[2])
    with pytest.raises(ValueError):
        tfa.flash_bwd_dq(q, k, v, o, lse[:, :3], do)


def _reference_route(b, t, h, d, dtype, block_k):
    """The JAX package's choice for ``_flash_bwd`` on [b*h, t, d] inputs,
    traced abstractly: ``"fused"`` if it called ``_flash_bwd_fused``."""
    called = []
    real = jfa._flash_bwd_fused

    def record(q, *a, **kw):
        called.append(True)
        return real(q, *a, **kw)

    x = jax.ShapeDtypeStruct((b * h, t, d), dtype)
    lse = jax.ShapeDtypeStruct((b * h, t, 1), jnp.float32)
    jfa._flash_bwd_fused = record
    try:
        jax.eval_shape(
            lambda q, k, v, o, l_, do: jfa._flash_bwd(
                q, k, v, o, l_, do, d ** -0.5, True, 1024, block_k, True),
            x, x, x, x, lse, x)
    finally:
        jfa._flash_bwd_fused = real
    return "fused" if called else "split"


# (b, t, h, d, dtype, block_k): the flagship's shape across t, f32, ragged
# t (_pick_block's divisor search), a smaller block_k, and d_head 256 (the
# partial bytes scale with d: 3 heads of 256 split at t=8192 as 6 of 128
# do)
ROUTE_CASES = [(8, t, 6, 128, "bfloat16", 1024)
               for t in (4096, 6144, 8192, 16384)] + [
    (8, 4096, 6, 128, "float32", 1024), (8, 6144, 6, 128, "float32", 1024),
    (8, 6144, 6, 128, "bfloat16", 512), (2, 1000, 6, 128, "bfloat16", 1024),
    (8, 8191, 6, 128, "bfloat16", 1024), (8, 10000, 6, 128, "bfloat16", 1024),
    (1, 12288, 12, 64, "float32", 1024)] + [
    (8, t, h, 256, "bfloat16", 1024)
    for t, h in ((2048, 6), (4096, 6), (4096, 3), (8192, 3))]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: f"b{c[0]}_t{c[1]}_{c[4]}_bk{c[5]}")
def test_bwd_route_is_the_reference_choice(case):
    b, t, h, d, dtype, block_k = case
    want = _reference_route(b, t, h, d, jnp.dtype(dtype), block_k)
    itemsize = jnp.dtype(dtype).itemsize
    assert tfa.bwd_route((b, t, h, d), t, itemsize, block_k) == want


def test_flagship_routes():
    """At b=8, h=6, d=128, bf16: fused at t=4096, split from t=8192."""
    route = lambda t: tfa.bwd_route((8, t, 6, 128), t, 2)  # noqa: E731
    assert [route(t) for t in (4096, 8192, 16384)] == [
        "fused", "split", "split"]
    assert tfa.FUSED_BWD_PARTIAL_BYTES == jfa.FUSED_BWD_PARTIAL_BYTES
