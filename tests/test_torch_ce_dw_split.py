"""The sm90 dW kernel's decomposition of the fused softmax-CE head's weight
gradient (``paddle_tpu_torch.kernels.fused_ce``: ``fused_ce_dw_split_ref``
and the static rule ``ce_family``) against the JAX package, on seeded
numpy inputs fed to both.

The plain spelling of the cluster decomposition — partial scores over d
slices summed in slice order, ``ds`` cast to the input dtype, each slice's
``x^T . ds`` update — is held to the dW of ``pallas_ce._ce_bwd`` run in
interpret mode (small explicit blocks, so its grid walks several row and
vocab tiles) and to the port's plain ``fused_ce_dw_ref``, with slices that
cut d evenly, raggedly and not at all, and labels -1 and V (no onehot).
The CUDA kernel itself is held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: f32 ``ORACLE_TOL`` 2e-4 (max |port - jax| / max |jax|): the
slices reassociate f32 sums only; bf16 against the plain version at the
grad tolerance 5e-2 (``ds`` rounds to bf16 from scores that differ in
their last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ce as jce
from paddle_tpu_torch.kernels import fused_ce as tce

TOL = tce.oracle_tol("float32")   # 2e-4


def _inputs(n, d, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (2 * rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    y[1::7] = -1
    y[3::11] = v
    g = rng.standard_normal(n).astype(np.float32)
    g[2::5] = 0.0
    return x, w, y, g


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def case():
    """(inputs, lse, the JAX dW) for N=150 rows, d=40, V=72; the JAX
    kernels in interpret mode with blocks of 50 rows and 24 columns."""
    x, w, y, g = _inputs(150, 40, 72, seed=3)
    jx, jw, jy = jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)
    _, lse = jce._ce_fwd(jx, jw, jy, 50, 24, True)
    _, jdw = jce._ce_bwd(jx, jw, jy, lse, jnp.asarray(g), 50, 24, True)
    return (x, w, y, g), np.array(lse), np.asarray(jdw)


@pytest.mark.parametrize("d_slice", [8, 16, 40, 256],
                         ids=["5slices", "ragged3", "one_exact", "one_wide"])
@pytest.mark.parametrize("block_n", [64, 32])
def test_split_spelling_matches_jax_dw(case, d_slice, block_n):
    (x, w, y, g), lse, jdw = case
    got = tce.fused_ce_dw_split_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        torch.from_numpy(lse), torch.from_numpy(g), d_slice=d_slice,
        block_n=block_n)
    assert got.dtype == torch.float32 and tuple(got.shape) == jdw.shape
    assert _rel(got.numpy(), jdw) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_spelling_matches_plain_dw(dtype):
    x, w, y, g = (torch.from_numpy(a) for a in _inputs(200, 48, 100, seed=4))
    dt = getattr(torch, dtype)
    x, w = x.to(dt), w.to(dt)
    _, lse = tce.fused_ce_ref(x, w, y)
    ref = tce.fused_ce_dw_ref(x, w, y, lse, g)
    got = tce.fused_ce_dw_split_ref(x, w, y, lse, g, d_slice=16)
    assert got.dtype == dt
    tol = TOL if dtype == "float32" else tce.oracle_tol(dtype, "grad")
    assert _rel(got.float().numpy(), ref.float().numpy()) <= tol


def test_family_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    ok = (0, 4096, 256, 512, 768)
    # the training paths (d 768, V 32768) and the ragged shape
    assert tce.ce_family(bf16, 768, 32768, ok) == "sm90"
    assert tce.ce_family(bf16, 200, 5000, ok) == "sm90"
    assert tce.ce_family(bf16, 8, 8, ok) == "sm90"
    # f32, d past 768, rows no multiple of 16 bytes, a misaligned base
    assert tce.ce_family(f32, 768, 32768, ok) == "simple"
    assert tce.ce_family(bf16, 776, 32768, ok) == "simple"
    assert tce.ce_family(bf16, 61, 333, ok) == "simple"
    assert tce.ce_family(bf16, 768, 2100, ok) == "simple"
    assert tce.ce_family(bf16, 768, 32768, (0, 8)) == "simple"


def test_cpu_calls_count_no_family():
    x, w, y, g = (torch.from_numpy(a) for a in _inputs(30, 16, 40, seed=5))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    before = (dict(tce.CE_DW_FAMILY_CALLS), tce.ce_dw.launches)
    _, lse = tce.ce_fwd(x, w, y)
    got = tce.ce_dw(x, w, y, lse, g)
    assert torch.equal(got, tce.fused_ce_dw_ref(x, w, y, lse, g))
    assert (dict(tce.CE_DW_FAMILY_CALLS), tce.ce_dw.launches) == before


def test_reset_launches_zeroes_every_family():
    """``kernels.reset_launches`` zeroes the family counts with the launch
    counts, so a run that resets before its main path reads only that
    path's families (``kernels.family_counts``)."""
    from paddle_tpu_torch import kernels

    assert kernels.FAMILIES["fused_ce_dw"] is tce.CE_DW_FAMILY_CALLS
    for calls in kernels.FAMILIES.values():
        for fam in calls:
            calls[fam] += 2
    kernels.reset_launches()
    assert all(n == 0 for calls in kernels.family_counts().values()
               for n in calls.values())
    assert set(kernels.family_counts()["paged_attention"]) == {"split",
                                                               "simple"}
