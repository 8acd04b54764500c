"""The port's paged attention (paddle_tpu_torch/kernels/paged_attention.py)
against the JAX package's: the plain PyTorch block scan against the JAX
block-scan oracle and against the Pallas TPU kernel run in interpret
mode, on the same seeded numpy inputs (W in {1, 3}, ragged positions,
blocks shared between slots, trash-block entries past each position).
Tolerance: ORACLE_TOL, max |port - jax| / max |jax| (f32 2e-4, bf16
2e-2).  The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_cuda_kernels.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa

S, H, DH, B, NB, NUM_BLOCKS = 4, 2, 16, 4, 5, 14


def _inputs(w, seed=0):
    """Seeded numpy inputs: slot 1 shares slot 0's first two blocks,
    positions are ragged, entries past each slot's chain name the trash
    block 0, which holds large finite garbage."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, w, H, DH)).astype(np.float32)
    pk = rng.standard_normal((NUM_BLOCKS, B, H, DH)).astype(np.float32)
    pv = rng.standard_normal((NUM_BLOCKS, B, H, DH)).astype(np.float32)
    pk[0] = 50.0 * rng.standard_normal((B, H, DH))
    pv[0] = 50.0 * rng.standard_normal((B, H, DH))
    base = np.array([13, 9, 2, 17])[:, None]           # ragged, < NB*B-w
    pos = (base + np.arange(w)[None, :]).astype(np.int32)
    blocks = rng.permutation(np.arange(1, NUM_BLOCKS))
    table = np.zeros((S, NB), np.int32)
    nxt = 0
    for s in range(S):
        n = int(pos[s].max()) // B + 1
        for nb in range(n):
            if s == 1 and nb < 2:
                table[s, nb] = table[0, nb]             # shared prefix
            else:
                table[s, nb] = blocks[nxt % len(blocks)]
                nxt += 1
    return q, pk, pv, table, pos


def _rel_err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _jax_args(arrs, dtype):
    q, pk, pv, table, pos = arrs
    return (jnp.asarray(q, dtype), jnp.asarray(pk, dtype),
            jnp.asarray(pv, dtype), jnp.asarray(table), jnp.asarray(pos))


def _torch_args(arrs, dtype):
    q, pk, pv, table, pos = arrs
    return (torch.tensor(q).to(dtype), torch.tensor(pk).to(dtype),
            torch.tensor(pv).to(dtype), torch.tensor(table),
            torch.tensor(pos))


def _to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [1, 3])
def test_ref_matches_jax_oracle(dtype, w):
    arrs = _inputs(w)
    ref = jpa.paged_attention_ref(*_jax_args(arrs, getattr(jnp, dtype)))
    got = tpa.paged_attention_ref(*_torch_args(arrs, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (S, w, H, DH)
    assert _rel_err(_to_np(got), ref) <= tpa.oracle_tol(dtype)


@pytest.fixture
def pallas_interpretable(monkeypatch):
    """The TPU kernel passes Mosaic ``compiler_params`` in the dict form,
    which the installed jax rejects before interpreting; interpret mode
    ignores them (they set TPU grid semantics), so drop them for the
    call.  The kernel body runs unchanged."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def pallas_call(*args, **kw):
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [1, 3])
def test_ref_matches_pallas_kernel_interpret(dtype, w,
                                             pallas_interpretable):
    arrs = _inputs(w, seed=1)
    ref = jpa.paged_attention_pallas(*_jax_args(arrs, getattr(jnp, dtype)),
                                     interpret=True)
    got = tpa.paged_attention_ref(*_torch_args(arrs, getattr(torch, dtype)))
    assert _rel_err(_to_np(got), ref) <= tpa.oracle_tol(dtype)


def test_ref_ignores_garbage_past_pos():
    """Rewriting every key/value past each slot's position (trash block
    included) leaves the output unchanged: the mask, not the content,
    decides."""
    q, pk, pv, table, pos = _inputs(1, seed=3)
    args = _torch_args((q, pk, pv, table, pos), torch.float32)
    base = tpa.paged_attention_ref(*args)
    pk2, pv2 = pk.copy(), pv.copy()
    live = {(int(table[s, j // B]), j % B)
            for s in range(S) for j in range(int(pos[s, 0]) + 1)}
    for blk in range(NUM_BLOCKS):
        for b in range(B):
            if (blk, b) not in live:
                pk2[blk, b] = 1e3
                pv2[blk, b] = -1e3
    got = tpa.paged_attention_ref(
        *_torch_args((q, pk2, pv2, table, pos), torch.float32))
    np.testing.assert_array_equal(_to_np(got), _to_np(base))


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch_args(_inputs(3, seed=4), torch.float32)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args)
    np.testing.assert_array_equal(_to_np(got),
                                  _to_np(tpa.paged_attention_ref(*args)))
    assert tpa.paged_attention.launches == before  # no kernel launched


def test_wrapper_rejects_bad_inputs():
    q, pk, pv, tbl, pos = _torch_args(_inputs(1), torch.float32)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), pk.half(), pv.half(), tbl, pos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q, pk.to(torch.bfloat16), pv, tbl, pos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q, pk, pv, tbl.long(), pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pk, pv, tbl, pos[:, :0])
    with pytest.raises(ValueError):
        tpa.paged_attention(q[0], pk, pv, tbl, pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pk[:, :, :1], pv, tbl, pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            pk, pv, tbl, pos)
