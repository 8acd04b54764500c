"""The port's fused bottleneck (``paddle_tpu_torch/kernels/bottleneck.py``)
against the JAX script it replaces (``benchmarks/bottleneck_pallas.py``),
on the CPU.

* The plain version :func:`bottleneck_ref` against the Pallas kernel body
  ``make_fused(..., interpret=True)`` and against the script's composed
  oracle ``xla_reference``, on the script's seeded input recipe at H = W =
  16, Cin = Cout = 32, Cm = 8, N = 2, band 8: f32 within ORACLE_TOL's
  2e-4 (summation order only), bf16 within the script's own 2e-2
  criterion.  A height no band divides (H = 12) against ``xla_reference``
  alone: the Pallas kernel leaves such a remainder unwritten.
* The weight helpers: ``kernel_weights`` keeps the script's layout,
  ``block_weights`` and ``fold_bn`` take a ResNet identity block of the
  port's model (OIHW filters, batch norm with running statistics) to the
  kernel's arguments, and the fused function then equals the port's own
  ``is_test`` ops on that block (conv2d, batch_norm, relu, residual add).
* The wrapper takes the plain version for CPU tensors (no launch is
  counted) and rejects what the kernel does not take.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks import bottleneck_pallas as bp
from paddle_tpu_torch.benchmarks import bottleneck as tbench
from paddle_tpu_torch.core.registry import get_op_impl as torch_op
from paddle_tpu_torch.kernels import bottleneck as tbn

N, HW, CIN, CM, TILE_H = 2, 16, 32, 8, 8


def _inputs(dtype, h=HW, seed=0):
    """The script's recipe (``main``) at a small shape, in both packages:
    x normal x 0.5, weights normal x 0.05, scales/shifts 1 + 0.1 normal."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(N, h, HW, CIN)) * 0.5,
              rng.normal(size=(CIN, CM)) * 0.05,
              rng.normal(size=(3, 3, CM, CM)) * 0.05,
              rng.normal(size=(CM, CIN)) * 0.05]
    sb = [rng.normal(size=(c,)) * 0.1 + 1.0
          for c in (CM, CM, CM, CM, CIN, CIN)]
    jd = jnp.dtype(dtype)
    jax_args = ([jnp.asarray(a, jd) for a in arrays]
                + [jnp.asarray(v, jnp.float32) for v in sb])
    td = getattr(torch, dtype)
    torch_args = ([torch.tensor(np.asarray(a.astype(jnp.float32))).to(td)
                   for a in jax_args[:4]]
                  + [torch.tensor(v, dtype=torch.float32) for v in sb])
    return jax_args, torch_args


def _max_rel(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_pallas_kernel_and_the_oracle(dtype):
    jax_args, torch_args = _inputs(dtype)
    fused = bp.make_fused(HW, HW, CIN, CM, CIN, TILE_H, interpret=True)
    want_kernel = fused(*jax_args)
    want_oracle = jax.jit(bp.xla_reference)(*jax_args)
    got = tbn.bottleneck_ref(*torch_args)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (N, HW, HW, CIN)
    tol = tbn.oracle_tol(getattr(torch, dtype))
    assert _max_rel(got, want_kernel) <= tol
    assert _max_rel(got, want_oracle) <= tol
    assert float(got.float().abs().max()) > 1.0     # about 3 here


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_on_a_height_no_band_divides(dtype):
    jax_args, torch_args = _inputs(dtype, h=12, seed=1)
    want = jax.jit(bp.xla_reference)(*jax_args)
    got = tbn.bottleneck(*torch_args)           # CPU: the plain version
    assert _max_rel(got, want) <= tbn.oracle_tol(getattr(torch, dtype))


def test_kernel_weights_keep_the_scripts_layout():
    _, (x, w1, w2, w3, *_) = _inputs("float32")
    k1, k2, k3 = tbn.kernel_weights(w1, w2, w3,
                                    dtype=torch.bfloat16)
    assert (k1.shape, k2.shape, k3.shape) == ((CIN, CM), (3, 3, CM, CM),
                                              (CM, CIN))
    assert all(k.dtype == torch.bfloat16 and k.is_contiguous()
               for k in (k1, k2, k3))
    assert torch.equal(k2.float(), w2.to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="HWIO"):
        tbn.kernel_weights(w1, w2.permute(2, 3, 0, 1)[:, :, :1], w3)


def test_block_weights_and_fold_bn_give_the_models_is_test_block():
    """An identity bottleneck block of the port's model (1x1, 3x3 pad 1,
    1x1 convs, each followed by an ``is_test`` batch norm, relu on the
    first two, residual add, relu) through the port's own ops, against the
    fused function on the NHWC activation with folded batch norm."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(N, CIN, 10, 10)), dtype=torch.float32)
    filters = [torch.tensor(rng.normal(size=s) * 0.1, dtype=torch.float32)
               for s in ((CM, CIN, 1, 1), (CM, CM, 3, 3), (CIN, CM, 1, 1))]
    bns = []
    for c in (CM, CM, CIN):
        bns.append({"Scale": torch.tensor(1 + 0.1 * rng.normal(size=c),
                                          dtype=torch.float32),
                    "Bias": torch.tensor(0.1 * rng.normal(size=c),
                                         dtype=torch.float32),
                    "Mean": torch.tensor(0.2 * rng.normal(size=c),
                                         dtype=torch.float32),
                    "Variance": torch.tensor(1 + rng.random(c),
                                             dtype=torch.float32)})
    conv, norm = torch_op("conv2d").fn, torch_op("batch_norm").fn
    h = x
    for i, (f, p) in enumerate(zip(filters, bns)):
        h = conv(Input=h, Filter=f, paddings=[1, 1] if i == 1 else [0, 0])
        h = norm(X=h["Output"], **p, is_test=True, epsilon=1e-5)["Y"]
        if i < 2:
            h = torch_op("relu").fn(X=h)["Out"]
    h = torch_op("relu").fn(
        X=torch_op("elementwise_add").fn(X=x, Y=h)["Out"])["Out"]
    sb = []
    for p in bns:
        sb += tbn.fold_bn(p["Scale"], p["Bias"], p["Mean"], p["Variance"])
    w = tbn.block_weights(*filters)
    got = tbn.bottleneck(x.permute(0, 2, 3, 1).contiguous(), *w, *sb)
    want = h.permute(0, 2, 3, 1)
    assert float((got - want).abs().max() / want.abs().max()) <= \
        tbn.oracle_tol(torch.float32)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    _, args = _inputs("float32")
    before = tbn.bottleneck.launches
    assert torch.equal(tbn.bottleneck(*args), tbn.bottleneck_ref(*args))
    assert tbn.bottleneck.launches == before
    x, w1, w2, w3, *sb = args
    with pytest.raises(ValueError, match="Cout == Cin"):
        tbn.bottleneck(x, w1, w2, w3[:, :CIN // 2], *sb)
    with pytest.raises(ValueError, match="f32"):
        tbn.bottleneck(x, w1, w2, w3, sb[0].double(), *sb[1:])
    with pytest.raises(TypeError, match="share a dtype"):
        tbn.bottleneck(x, w1.to(torch.bfloat16), w2, w3, *sb)
    with pytest.raises(ValueError, match=r"\[N, H, W, C\]"):
        tbn.bottleneck(x[0], w1, w2, w3, *sb)


def test_benchmark_runs_its_check_on_the_cpu(capsys):
    assert tbench.main(["--device", "cpu", "--batch", "1"]) == 0
    assert "max rel diff fused vs composed" in capsys.readouterr().out
    x, w1, w2, w3, *sb = tbench.make_inputs(1, "cpu")
    assert x.shape == (1, 56, 56, 256) and x.dtype == torch.bfloat16
    assert (w1.shape, w2.shape, w3.shape) == ((256, 64), (3, 3, 64, 64),
                                              (64, 256))
    assert all(v.dtype == torch.float32 for v in sb)
