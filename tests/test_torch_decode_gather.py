"""The port's decode gather (paddle_tpu_torch/kernels/decode_gather.py)
against the JAX package's, on the CPU: the plain version is bit-equal to
the Pallas kernel ``pallas_gather.decode_gather`` run in interpret mode
and to the oracle ``xla_ref.decode_gather``, as tests/test_kernels.py
runs them, in f32 and in bf16 (compared as bit patterns), with ragged
blocks and repeated and trash (0) table entries; and the wrapper checks
its inputs before anything runs.  The kernel itself runs on the card
(tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import xla_ref
from paddle_tpu.kernels.pallas_gather import decode_gather as jax_gather
from paddle_tpu_torch.kernels import decode_gather as tdg


def _bits(a):
    """A tensor or array's raw bits, bf16 carried as uint16."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _case(S, NB, B, H, DH, nblk, seed):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((nblk, B, H, DH)).astype(np.float32)
    table = rng.integers(0, nblk, (S, NB)).astype(np.int32)
    table[:, -1] = 0                           # trash entries
    table[S // 2:, 0] = table[0, 0]            # repeated entries
    return pool, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [(3, 6, 4, 2, 8, 9), (5, 3, 5, 3, 21, 7),
                                  (1, 4, 16, 2, 32, 5)],
                         ids=["kernels_test", "ragged", "prefill"])
def test_plain_version_bit_equal_to_pallas_and_oracle(dtype, geom):
    pool_np, table_np = _case(*geom, seed=sum(geom))
    jpool = jnp.asarray(pool_np, getattr(jnp, dtype))
    jtable = jnp.asarray(table_np)
    pallas = jax_gather(jpool, jtable, interpret=True)
    oracle = xla_ref.decode_gather(jpool, jtable)
    # the port gets the same bits: bf16 rounds from f32 identically
    tpool = torch.tensor(pool_np).to(getattr(torch, dtype))
    assert np.array_equal(_bits(tpool), _bits(jpool))
    got = tdg.decode_gather(tpool, torch.tensor(table_np))
    S, NB, B, H, DH, _ = geom
    assert tuple(got.shape) == (S, NB * B, H, DH) == pallas.shape
    assert got.dtype == tpool.dtype
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


def test_wrapper_on_the_cpu_is_the_plain_version_and_counts_nothing():
    pool_np, table_np = _case(4, 5, 4, 2, 8, 11, seed=0)
    pool, table = torch.tensor(pool_np), torch.tensor(table_np)
    before = tdg.decode_gather.launches
    got = tdg.decode_gather(pool, table)
    assert tdg.decode_gather.launches == before
    assert torch.equal(got, tdg.decode_gather_ref(pool, table))
    # slot s, logical block nb is physical block table[s, nb]
    for s in range(4):
        for nb in range(5):
            assert torch.equal(got[s, nb * 4:(nb + 1) * 4],
                               pool[table_np[s, nb]])


def test_wrapper_rejects_bad_inputs():
    pool = torch.zeros((5, 4, 2, 8))
    table = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        tdg.decode_gather(pool.half(), table)
    with pytest.raises(TypeError, match="int32"):
        tdg.decode_gather(pool, table.long())
    with pytest.raises(ValueError, match="num_blocks"):
        tdg.decode_gather(pool[0], table)
    with pytest.raises(ValueError, match=r"\[S, NB\]"):
        tdg.decode_gather(pool, table[0])
    with pytest.raises(ValueError, match="contiguous"):
        tdg.decode_gather(pool[:, :, :, ::2], table)
    with pytest.raises(ValueError, match="no block"):
        tdg.decode_gather(pool[:0], table)
    with pytest.raises(ValueError, match="share a device"):
        tdg.decode_gather(pool, table.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tdg.decode_gather(pool.to("meta"), table.to("meta"))


def test_oracle_tolerance_is_exact():
    assert tdg.oracle_tol(torch.float32) == 0.0
    assert tdg.oracle_tol(torch.bfloat16) == 0.0
    assert (xla_ref.oracle_tol("decode_gather", "bfloat16")
            == tdg.oracle_tol(torch.bfloat16))
