"""The sm90 bottleneck kernel's decomposition, on the CPU.

* ``bottleneck_rows_ref`` (``paddle_tpu_torch/kernels/bottleneck.py``) —
  the plain spelling of what ``csrc/bottleneck_sm90.cu`` does: strips of
  rows, a row-by-row walk two rows a step, a rolling ring of y1 rows with
  zero slots and zero rows, conv1 once per row a strip needs (its halo rows
  included), the same two roundings — against the port's ``bottleneck_ref``
  and the JAX script it replaces (``benchmarks/bottleneck_pallas.py``:
  ``make_fused(..., interpret=True)`` where its band divides H, and
  ``xla_reference``).  Inputs from one numpy seed, the script's recipe.
  Shapes: a strip boundary (and an odd last strip), H = 1, W = 1 and W no
  multiple of 8, at the kernel's Cm = 64; f32 within ORACLE_TOL's 2e-4
  (summation order), bf16 within the script's 2e-2.
* The family rule ``bottleneck_family`` on each of its boundaries, and the
  strip height ``strip_rows``.
* On CPU tensors the wrapper takes the plain version and counts no
  family, whatever ``family`` asks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks import bottleneck_pallas as bp
from paddle_tpu_torch.kernels import bottleneck as tbn

CM = 64


def _inputs(dtype, n, h, w, cin, seed):
    """The script's recipe in both packages: x normal x 0.5, weights
    normal x 0.05, scales and shifts 1 + 0.1 normal (f32)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(n, h, w, cin)) * 0.5,
              rng.normal(size=(cin, CM)) * 0.05,
              rng.normal(size=(3, 3, CM, CM)) * 0.05,
              rng.normal(size=(CM, cin)) * 0.05]
    sb = [rng.normal(size=(c,)) * 0.1 + 1.0
          for c in (CM, CM, CM, CM, cin, cin)]
    jd = jnp.dtype(dtype)
    jax_args = ([jnp.asarray(a, jd) for a in arrays]
                + [jnp.asarray(v, jnp.float32) for v in sb])
    td = getattr(torch, dtype)
    torch_args = ([torch.tensor(np.asarray(a.astype(jnp.float32))).to(td)
                   for a in jax_args[:4]]
                  + [torch.tensor(v, dtype=torch.float32) for v in sb])
    return jax_args, torch_args


def _max_rel(got, want):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got)
                     else jnp.asarray(got).astype(jnp.float32))
    want = np.asarray(want.float().numpy() if torch.is_tensor(want)
                      else jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


# name -> (n, h, w, cin, strip, band of make_fused or None)
GEOMS = {"strips_3_of_8": (2, 8, 8, 64, 3, 4),
         "odd_strip": (1, 7, 9, 64, 2, 7),
         "whole_image": (2, 6, 6, 128, None, 3),
         "h1": (2, 1, 5, 64, 1, 1),
         "w1": (1, 5, 1, 64, 2, 5),
         "w13": (1, 4, 13, 64, 4, 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_rows_spelling_matches_the_plain_version_and_the_script(dtype, geom):
    n, h, w, cin, strip, band = GEOMS[geom]
    jax_args, torch_args = _inputs(dtype, n, h, w, cin, seed=len(geom))
    got = tbn.bottleneck_rows_ref(*torch_args, strip=strip)
    tol = tbn.oracle_tol(getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (n, h, w, cin)
    assert torch.isfinite(got.float()).all()
    assert _max_rel(got, tbn.bottleneck_ref(*torch_args)) <= tol
    assert _max_rel(got, jax.jit(bp.xla_reference)(*jax_args)) <= tol
    fused = bp.make_fused(h, w, cin, CM, cin, band, interpret=True)
    assert _max_rel(got, fused(*jax_args)) <= tol


@pytest.mark.parametrize("ring", [6, 5, 4])
def test_the_ring_needs_no_more_rows_than_it_holds(ring):
    """The walk reads rows r - 1 .. r + 2 of the ring in a step and writes
    two: four rows are the least it can hold, and every depth from there
    up gives the same output (the kernel keeps six so that one barrier a
    step orders the writes after the last reads)."""
    _, args = _inputs("float32", 1, 9, 7, 64, seed=3)
    want = tbn.bottleneck_rows_ref(*args, strip=9)
    assert torch.equal(tbn.bottleneck_rows_ref(*args, strip=9, ring=ring),
                       want)


def test_strip_rows():
    """At N = 128 on 132 SMs a strip is a whole image; small batches cut
    each image into up to ``sms // N`` strips; never more than H."""
    assert tbn.strip_rows(128, 56, 132) == 56
    assert tbn.strip_rows(300, 56, 132) == 56
    assert tbn.strip_rows(2, 56, 132) == 1
    assert tbn.strip_rows(4, 56, 132) == 2          # 33 strips of 2
    assert tbn.strip_rows(64, 56, 132) == 28
    assert tbn.strip_rows(1, 1, 132) == 1
    assert tbn.strip_rows(10, 13, 132) == 1


ALIGNED = [0, 256, 512, 768, 1024]


@pytest.mark.parametrize("case,want", [
    ((torch.bfloat16, 56, 56, 256, 64, ALIGNED), "sm90"),
    ((torch.bfloat16, 1, 1, 64, 64, ALIGNED), "sm90"),
    ((torch.bfloat16, 9, 64, 192, 64, ALIGNED), "sm90"),
    ((torch.bfloat16, 56, 56, 256, 72, ALIGNED), "simple"),     # Cm != 64
    ((torch.bfloat16, 56, 56, 256, 32, ALIGNED), "simple"),
    ((torch.bfloat16, 14, 14, 512, 64, ALIGNED), "simple"),     # Cin > 256
    ((torch.bfloat16, 56, 56, 96, 64, ALIGNED), "simple"),      # Cin % 64
    ((torch.bfloat16, 56, 65, 256, 64, ALIGNED), "simple"),     # W > 64
    ((torch.float32, 56, 56, 256, 64, ALIGNED), "simple"),      # f32
    ((torch.bfloat16, 56, 56, 256, 64, [2] + ALIGNED[1:]), "simple"),
    ((torch.bfloat16, 56, 56, 256, 64, ALIGNED[:4] + [8]), "simple"),
], ids=["path", "h1w1", "c192", "cm72", "cm32", "cin512", "cin96", "w65",
        "f32", "x_misaligned", "out_misaligned"])
def test_family_rule(case, want):
    assert tbn.bottleneck_family(*case) == want


@pytest.mark.parametrize("family", [None, "sm90", "simple"])
def test_cpu_calls_take_the_plain_version_and_count_no_family(family):
    _, args = _inputs("bfloat16", 1, 3, 4, 64, seed=5)
    before = (tbn.bottleneck.launches, dict(tbn.BOTTLENECK_FAMILY_CALLS))
    got = tbn.bottleneck(*args, family=family)
    assert torch.equal(got, tbn.bottleneck_ref(*args))
    assert (tbn.bottleneck.launches,
            dict(tbn.BOTTLENECK_FAMILY_CALLS)) == before
