"""The split flash backward's delta pre-pass and kernel-family rule, on the
CPU (the CUDA kernels of ``csrc/flash_bwd_sm90.cu`` run on the card only:
``tests/test_torch_cuda_kernels.py``).

* ``flash_bwd_delta_ref`` — ``delta = rowsum(do * o) - dlse`` — against
  the JAX package's delta algebra (``paddle_tpu/kernels/xla_ref.py``
  ``_attn_bwd_math``: ``einsum("bqhd,bqhd->bhq", do, o) - dlse``)
  evaluated in JAX on the same numpy inputs, f32, in the 4-D and the
  packed ``[b, t, h*d]`` layouts, with and without ``dlse``; and the
  plain backward fed that delta against ``_attn_bwd_math`` itself.
* ``flash_bwd_dq`` / ``flash_bwd_dkv`` given a precomputed ``delta``
  equal their results without it, bit for bit.
* The split route, its wrappers fed one precomputed delta, still matches
  the JAX split Pallas kernels in interpret mode (both packages forced
  onto the split route); the fused route's plain backward fed one
  pre-pass delta matches the JAX package's ``_flash_bwd_fused`` in
  interpret mode and equals its result without delta.
* ``bwd_family`` as a pure function over (dtype, d, strides, pointers):
  bf16 with d <= 128 and every stride and pointer 16-byte aligned takes
  the sm90 kernels, anything else the simple ones — for the split pair's
  tensors, the forward's (q, k, v, o) and the fused route's; on the CPU
  no family counter moves.
Tolerance: f32 ``ORACLE_TOL`` (flash grad 1e-3); delta to 1e-6 relative
(two f32 sums of d products in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import xla_ref
from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

B, T, BLK = 2, 64, 16


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _arrays(h, d, seed, t=T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, h, d)).astype(np.float32)
            for _ in range(4)]


def _jax_delta(o, do, dlse):
    """xla_ref._attn_bwd_math's delta, [b, h, t_q]."""
    delta = jnp.einsum("bqhd,bqhd->bhq", jnp.asarray(do).astype(jnp.float32),
                       jnp.asarray(o).astype(jnp.float32))
    if dlse is not None:
        delta = delta - jnp.asarray(dlse).astype(jnp.float32)
    return np.asarray(delta)


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("layout", ["4d", "packed"])
def test_delta_plain_version_matches_the_jax_algebra(layout, with_dlse):
    h, d = (2, 16) if layout == "4d" else (2, 64)
    _, _, o, do = _arrays(h, d, seed=31 + with_dlse)
    dlse = (np.random.default_rng(32).standard_normal((B, h, T)).astype(
        np.float32) if with_dlse else None)
    to = torch.from_numpy(o)
    tdo = torch.from_numpy(do)
    if layout == "packed":
        # the raw projection layout: the 4-D view of the same memory
        to = to.reshape(B, T, h * d).reshape(B, T, h, d)
        tdo = tdo.reshape(B, T, h * d).reshape(B, T, h, d)
    tdl = None if dlse is None else torch.from_numpy(dlse).reshape(B * h, T)
    before = tfa.flash_bwd_delta.launches
    got = tfa.flash_bwd_delta(to, tdo, tdl)
    assert tfa.flash_bwd_delta.launches == before   # CPU: no kernel
    assert got.shape == (B * h, T) and got.dtype == torch.float32
    assert torch.equal(got, tfa.flash_bwd_delta_ref(to, tdo, tdl))
    want = _jax_delta(o, do, dlse).reshape(B * h, T)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_backward_fed_delta_matches_xla_ref(causal, with_dlse):
    h, d = 2, 32
    q, k, v, do = _arrays(h, d, seed=41 + causal)
    dlse = (np.random.default_rng(42).standard_normal((B, h, T)).astype(
        np.float32) if with_dlse else None)
    sm_scale = d ** -0.5
    o, lse = xla_ref._attn_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), sm_scale, causal)
    want = xla_ref._attn_bwd_math(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
        jnp.asarray(do), sm_scale, causal,
        None if dlse is None else jnp.asarray(dlse))
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, o, do)]
    tlse = torch.from_numpy(np.array(lse)).reshape(B * h, T)
    tdl = None if dlse is None else torch.from_numpy(dlse).reshape(B * h, T)
    delta = tfa.flash_bwd_delta(t[3], t[4], tdl)
    got = tfa.flash_attention_bwd_ref(t[0], t[1], t[2], t[3], tlse, t[4],
                                      tdl, causal, sm_scale, delta=delta)
    tol = tfa.oracle_tol(torch.float32, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.numpy(), w) <= tol, name


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_wrappers_fed_delta_equal_their_results_without(causal,
                                                             with_dlse):
    h, d = 3, 24
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(h, d, seed=51))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    dlse = (torch.from_numpy(np.random.default_rng(52).standard_normal(
        (B * h, T)).astype(np.float32)) if with_dlse else None)
    delta = tfa.flash_bwd_delta(o, do, dlse)
    l0 = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches,
          dict(tfa.BWD_FAMILY_CALLS))
    dq = tfa.flash_bwd_dq(q, k, v, o, lse, do, dlse, causal)
    dq_d = tfa.flash_bwd_dq(q, k, v, o, lse, do, dlse, causal, None, delta)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, o, lse, do, dlse, causal)
    dk_d, dv_d = tfa.flash_bwd_dkv(q, k, v, o, lse, do, dlse, causal, None,
                                   delta)
    assert torch.equal(dq, dq_d)
    assert torch.equal(dk, dk_d) and torch.equal(dv, dv_d)
    # the plain versions launch nothing and take no family
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches,
            tfa.BWD_FAMILY_CALLS) == l0
    with pytest.raises(ValueError):
        tfa.flash_bwd_dq(q, k, v, o, lse, do, dlse, causal, None,
                         delta[:, :5])
    with pytest.raises(ValueError):
        tfa.flash_bwd_delta(o, do[:, :5])


@pytest.fixture
def split_everywhere(monkeypatch):
    """Both packages take the split route for every shape."""
    monkeypatch.setattr(jfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("packed", [False, True], ids=["4d", "packed_d64"])
def test_split_route_fed_one_delta_matches_the_jax_split_kernels(
        packed, causal, split_everywhere):
    h, d = 2, (64 if packed else 16)
    q, k, v, do = _arrays(h, d, seed=61 + causal)
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
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd(tq, tk, tv, causal)
    assert tfa.bwd_route(tq.shape, T, 4, BLK) == "split"
    delta = tfa.flash_bwd_delta(o, tdo)
    got = (tfa.flash_bwd_dq(tq, tk, tv, o, lse, tdo, None, causal, None,
                            delta),
           *tfa.flash_bwd_dkv(tq, tk, tv, o, lse, tdo, None, causal, None,
                              delta))
    tol = tfa.oracle_tol(torch.float32, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.numpy(), w) <= tol, name


# (dtype, d, strides per tensor, pointers) -> family
FLAGSHIP = (16384 * 768, 768, 128)          # packed [b, t, h*d], h=6, d=128
FAMILY_CASES = {
    "flagship_packed_t16384_bf16": (torch.bfloat16, 128, [FLAGSHIP] * 5,
                                    [0x7f0000000000 + i * 2 ** 28
                                     for i in range(5)], "sm90"),
    "flagship_f32": (torch.float32, 128, [FLAGSHIP] * 5,
                     [0x7f0000000000] * 5, "simple"),
    "packed_d64_two_heads": (torch.bfloat16, 64, [(4096 * 128, 128, 64)] * 5,
                             [1 << 20] * 5, "sm90"),
    "d16": (torch.bfloat16, 16, [(64 * 32, 32, 16)] * 5, [1 << 20] * 5,
            "sm90"),
    "ragged_d100_time_stride_300": (torch.bfloat16, 100,
                                    [(77 * 300, 300, 100)] * 5,
                                    [1 << 20] * 5, "simple"),
    "d_over_128": (torch.bfloat16, 160, [(64 * 160, 160, 160)] * 5,
                   [1 << 20] * 5, "simple"),
    "pointer_off_by_8_bytes": (torch.bfloat16, 128, [FLAGSHIP] * 5,
                               [1 << 20] * 4 + [(1 << 20) + 8], "simple"),
    "batch_stride_not_16_bytes": (torch.bfloat16, 128,
                                  [(16384 * 768 + 4, 768, 128)] + [FLAGSHIP]
                                  * 4, [1 << 20] * 5, "simple"),
    "f16": (torch.float16, 128, [FLAGSHIP] * 5, [1 << 20] * 5, "simple"),
    # the forward's q, k, v, o and the fused route's q, k, v, o, do, dk, dv
    "forward_flagship_packed_t4096": (torch.bfloat16, 128,
                                      [(4096 * 768, 768, 128)] * 4,
                                      [0x7f0000000000 + i * 2 ** 26
                                       for i in range(4)], "sm90"),
    "forward_o_off_by_8_bytes": (torch.bfloat16, 128,
                                 [(4096 * 768, 768, 128)] * 4,
                                 [1 << 20] * 3 + [(1 << 20) + 8], "simple"),
    "forward_f32": (torch.float32, 128, [(4096 * 768, 768, 128)] * 4,
                    [1 << 20] * 4, "simple"),
    "fused_flagship_packed_t4096": (torch.bfloat16, 128,
                                    [(4096 * 768, 768, 128)] * 7,
                                    [0x7f0000000000 + i * 2 ** 26
                                     for i in range(7)], "sm90"),
    "fused_packed_d64_two_heads": (torch.bfloat16, 64,
                                   [(1024 * 128, 128, 64)] * 7,
                                   [1 << 20] * 7, "sm90"),
    "fused_ragged_d100": (torch.bfloat16, 100, [(77 * 300, 300, 100)] * 7,
                          [1 << 20] * 7, "simple"),
}


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_rule(case):
    dtype, d, strides, ptrs, want = FAMILY_CASES[case]
    assert tfa.bwd_family(dtype, d, strides, ptrs) == want


def test_family_of_real_tensors():
    """``_family`` reads the (batch, time, head) strides and the pointers
    of real tensors: a contiguous bf16 [b, t, h, d] with d=128 is sm90, a
    view one element in is not."""
    x = torch.zeros(2, 8, 3, 128, dtype=torch.bfloat16)
    assert tfa._family(x, x, x) == "sm90"
    assert tfa._family(x.float(), x.float()) == "simple"
    odd = torch.zeros(2 * 8 * 3 * 128 + 1, dtype=torch.bfloat16)[1:]
    assert tfa._family(x, odd.view(2, 8, 3, 128)) == "simple"


def test_cpu_family_counters_stay_at_zero():
    """CPU tensors take the plain versions on every route and count no
    kernel family: the forward, the fused route and the split route."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(2, 16, seed=71))
    before = (dict(tfa.FWD_FAMILY_CALLS), dict(tfa.FUSED_FAMILY_CALLS),
              dict(tfa.BWD_FAMILY_CALLS), tfa.flash_bwd_delta.launches)
    o, lse = tfa.flash_fwd(q, k, v, True)
    assert tfa.bwd_route(q.shape, T, 4) == "fused"
    tfa.flash_bwd(q, k, v, o, lse, do, None, True)
    tfa.flash_bwd(q, k, v, o, lse, do, None, True, None, BLK, 1)
    assert tfa.bwd_route(q.shape, T, 4, 1) == "fused"
    assert (dict(tfa.FWD_FAMILY_CALLS), dict(tfa.FUSED_FAMILY_CALLS),
            dict(tfa.BWD_FAMILY_CALLS), tfa.flash_bwd_delta.launches) == before


def _jax_fused(q, k, v, do, dlse, causal, h, d, packed):
    """The JAX package's fused backward kernel (``_flash_bwd_fused``) in
    interpret mode, from its own forward's ``o`` and ``lse``: ``(o, lse
    [b*h, t], dq, dk, dv)``, back in the [b, t, h, d] layout."""
    if packed:
        def lay(x):
            return jnp.asarray(x).reshape(B, T, h * d)

        def back(y):
            return np.asarray(y).reshape(B, T, h, d)
        kw = {"n_head": h, "sub_heads": jfa.packed_sub_heads(h, d)}
    else:
        def lay(x):
            return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, T, d)

        def back(y):
            return np.asarray(y).reshape(B, h, T, d).transpose(0, 2, 1, 3)
        kw = {}
    sm_scale = d ** -0.5
    jq, jk, jv, jdo = (lay(x) for x in (q, k, v, do))
    o, lse = jfa._flash_fwd(jq, jk, jv, sm_scale, causal, BLK, BLK, True,
                            **kw)
    jdl = None if dlse is None else jnp.asarray(dlse).reshape(B * h, T, 1)
    dq, dk, dv = jfa._flash_bwd_fused(jq, jk, jv, o, lse[:, :, None], jdo,
                                      sm_scale, causal, BLK, BLK, True,
                                      dlse=jdl, **kw)
    return (back(o), np.asarray(lse).reshape(B * h, T), back(dq), back(dk),
            back(dv))


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("packed", [False, True], ids=["4d", "packed_d64"])
def test_fused_route_fed_one_delta_matches_the_jax_fused_kernel(
        packed, causal, with_dlse):
    """The sm90 fused route reads one pre-pass delta where the JAX fused
    kernel computes delta inside: the port's plain backward fed
    ``flash_bwd_delta_ref``'s delta matches ``_flash_bwd_fused`` within
    the f32 ORACLE_TOL, and equals the same backward without delta."""
    h, d = 2, (64 if packed else 16)
    q, k, v, do = _arrays(h, d, seed=81 + causal + 2 * with_dlse)
    dlse = (np.random.default_rng(82).standard_normal((B * h, T)).astype(
        np.float32) if with_dlse else None)
    o, lse, *want = _jax_fused(q, k, v, do, dlse, causal, h, d, packed)
    tq, tk, tv, to, tdo = (torch.from_numpy(np.array(x))
                           for x in (q, k, v, o, do))
    tlse = torch.from_numpy(np.array(lse))
    tdl = None if dlse is None else torch.from_numpy(dlse)
    assert tfa.bwd_route(tq.shape, T, 4, BLK) == "fused"
    delta = tfa.flash_bwd_delta_ref(to, tdo, tdl)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, to, tlse, tdo, tdl, causal,
                                      d ** -0.5, delta=delta)
    plain = tfa.flash_attention_bwd_ref(tq, tk, tv, to, tlse, tdo, tdl,
                                        causal, d ** -0.5)
    tol = tfa.oracle_tol(torch.float32, "grad")
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert torch.equal(g, p), name
        assert _rel(g.numpy(), w) <= tol, name
