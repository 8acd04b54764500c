"""The sm90 forward and dx kernels' decompositions of the fused softmax-CE
head (``paddle_tpu_torch.kernels.fused_ce``: ``fused_ce_fwd_tiled_ref``,
``fused_ce_dx_split_ref``, the split point ``dx_d_half`` and the static
rule ``ce_family``) against the JAX package, on seeded numpy inputs fed to
both.

The plain spelling of the forward — an online softmax over vocab tiles in
the exp2 domain with the label's logit picked in its tile — is held to
``pallas_ce._ce_fwd``; the plain spelling of dx — partial scores over two
``d`` halves summed, ``ds`` cast to the input dtype, each half's
``ds . w^T`` accumulated over vocab tiles — to the dx of
``pallas_ce._ce_bwd``.  Both JAX kernels run in interpret mode with small
explicit blocks (50 rows, 24 columns), so their grids walk several row and
vocab tiles.  Both spellings are also held to the port's plain
``fused_ce_ref`` / ``fused_ce_dx_ref``: tiles that no V divides, ``d``
split evenly, raggedly and not at all, labels -1 and V (no pick, no
onehot).  The CUDA kernels themselves are held against the plain versions
on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: f32 ``ORACLE_TOL`` 2e-4 (max |port - jax| / max |jax|): tiles
and halves reassociate f32 sums only; bf16 against the plain version at
the forward tolerance 2e-2 and the grad tolerance 5e-2 (``ds`` rounds to
bf16 from scores that differ in their last bits).
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
    """(inputs, the JAX loss, lse and dx) for N=150 rows, d=40, V=72; the
    JAX kernels in interpret mode with blocks of 50 rows and 24 columns."""
    x, w, y, g = _inputs(150, 40, 72, seed=7)
    jx, jw, jy = jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)
    loss, lse = jce._ce_fwd(jx, jw, jy, 50, 24, True)
    jdx, _ = jce._ce_bwd(jx, jw, jy, lse, jnp.asarray(g), 50, 24, True)
    return (x, w, y, g), np.asarray(loss), np.array(lse), np.asarray(jdx)


@pytest.mark.parametrize("block_v", [16, 24, 32, 128],
                         ids=["ragged16", "even24", "ragged32", "one128"])
def test_tiled_forward_matches_jax(case, block_v):
    (x, w, y, _), jloss, jlse, _ = case
    loss, lse = tce.fused_ce_fwd_tiled_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        block_v=block_v)
    assert loss.dtype == torch.float32 and tuple(loss.shape) == jloss.shape
    assert _rel(lse.numpy(), jlse) <= TOL
    assert _rel(loss.numpy(), jloss) <= TOL
    out = (y < 0) | (y >= w.shape[1])
    assert np.array_equal(loss.numpy()[out], lse.numpy()[out])


@pytest.mark.parametrize("d_half", [8, 16, 20, 40, 256],
                         ids=["5parts", "ragged3", "even2", "one_exact",
                              "one_wide"])
@pytest.mark.parametrize("block_v", [32, 24])
def test_split_dx_matches_jax(case, d_half, block_v):
    (x, w, y, g), _, jlse, jdx = case
    got = tce.fused_ce_dx_split_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        torch.from_numpy(jlse), torch.from_numpy(g), d_half=d_half,
        block_v=block_v)
    assert got.dtype == torch.float32 and tuple(got.shape) == jdx.shape
    assert _rel(got.numpy(), jdx) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,v", [(200, 48, 100), (90, 200, 300),
                                   (64, 128, 256)],
                         ids=["v_ragged", "d_ragged_half", "aligned"])
def test_split_spellings_match_plain(dtype, n, d, v):
    """The two spellings at their kernels' own tiles (128 vocab columns for
    the forward, 32 for dx, ``d`` cut at ``dx_d_half``) against the plain
    versions, f32 and bf16."""
    x, w, y, g = (torch.from_numpy(a) for a in _inputs(n, d, v, seed=8))
    dt = getattr(torch, dtype)
    x, w = x.to(dt), w.to(dt)
    loss, lse = tce.fused_ce_ref(x, w, y)
    tloss, tlse = tce.fused_ce_fwd_tiled_ref(x, w, y)
    ftol = TOL if dtype == "float32" else tce.oracle_tol(dtype, "fwd")
    assert _rel(tlse.numpy(), lse.numpy()) <= ftol
    assert _rel(tloss.numpy(), loss.numpy()) <= ftol
    ref = tce.fused_ce_dx_ref(x, w, y, lse, g)
    got = tce.fused_ce_dx_split_ref(x, w, y, lse, g)
    assert got.dtype == dt
    gtol = TOL if dtype == "float32" else tce.oracle_tol(dtype, "grad")
    assert _rel(got.float().numpy(), ref.float().numpy()) <= gtol


def test_dx_split_point():
    """Each consumer warpgroup of the sm90 dx kernel owns 64, 128, 192 or
    384 columns: the path's d = 768 splits evenly, d = 200 raggedly, a
    narrow d leaves the second half empty."""
    assert tce.dx_d_half(768) == 384
    assert tce.dx_d_half(512) == 384
    assert tce.dx_d_half(384) == 192
    assert tce.dx_d_half(200) == 128
    assert tce.dx_d_half(128) == 64
    assert tce.dx_d_half(40) == 64


@pytest.mark.parametrize("kernel", ["forward", "dx", "dW"])
def test_family_rule_for_each_kernel(kernel):
    """One static rule picks the family of all three CE kernels from the
    pointers each launch reads: the forward x, w, y; dx and dW also lse
    and g."""
    bf16, f32 = torch.bfloat16, torch.float32
    n_ptrs = 3 if kernel == "forward" else 5
    ok = (0, 4096, 256, 512, 768)[:n_ptrs]
    odd = ok[:-1] + (8,)
    # the training paths (d 768, V 32768), the ragged shape, the least
    assert tce.ce_family(bf16, 768, 32768, ok) == "sm90"
    assert tce.ce_family(bf16, 200, 5000, ok) == "sm90"
    assert tce.ce_family(bf16, 8, 8, ok) == "sm90"
    # f32, d past 768, rows no multiple of 16 bytes, a misaligned pointer
    assert tce.ce_family(f32, 768, 32768, ok) == "simple"
    assert tce.ce_family(bf16, 776, 32768, ok) == "simple"
    assert tce.ce_family(bf16, 61, 333, ok) == "simple"
    assert tce.ce_family(bf16, 768, 2100, ok) == "simple"
    assert tce.ce_family(bf16, 768, 32768, odd) == "simple"


def test_cpu_calls_count_no_family():
    """On the CPU the three wrappers take the plain versions and count no
    launch and no family."""
    x, w, y, g = (torch.from_numpy(a) for a in _inputs(30, 16, 40, seed=9))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    tables = (tce.CE_FWD_FAMILY_CALLS, tce.CE_DX_FAMILY_CALLS,
              tce.CE_DW_FAMILY_CALLS)
    wrappers = (tce.ce_fwd, tce.ce_dx, tce.ce_dw)
    before = ([dict(t) for t in tables], [f.launches for f in wrappers])
    loss, lse = tce.ce_fwd(x, w, y)
    rloss, rlse = tce.fused_ce_ref(x, w, y)
    assert torch.equal(loss, rloss) and torch.equal(lse, rlse)
    assert torch.equal(tce.ce_dx(x, w, y, lse, g),
                       tce.fused_ce_dx_ref(x, w, y, lse, g))
    assert torch.equal(tce.ce_dw(x, w, y, lse, g),
                       tce.fused_ce_dw_ref(x, w, y, lse, g))
    assert ([dict(t) for t in tables],
            [f.launches for f in wrappers]) == before


def test_every_ce_family_table_is_registered():
    """``kernels.family_counts`` reads all three CE tables, and
    ``reset_launches`` zeroes them with the rest."""
    from paddle_tpu_torch import kernels

    assert kernels.FAMILIES["fused_ce_fwd"] is tce.CE_FWD_FAMILY_CALLS
    assert kernels.FAMILIES["fused_ce_dx"] is tce.CE_DX_FAMILY_CALLS
    assert kernels.FAMILIES["fused_ce_dw"] is tce.CE_DW_FAMILY_CALLS
    tce.CE_FWD_FAMILY_CALLS["sm90"] += 3
    tce.CE_DX_FAMILY_CALLS["simple"] += 1
    kernels.reset_launches()
    counts = kernels.family_counts()
    assert counts["fused_ce_fwd"] == counts["fused_ce_dx"] == {
        "sm90": 0, "simple": 0}
