"""GoogLeNet with its two aux heads at 0.3 (``benchmarks/run.py``'s
``googlenet`` row) in the port against the JAX package, on the CPU, at
``tests/test_benchmark_models.py``'s size (128x128, 4 classes, f32,
Momentum at 1e-3), batch 2, with the ``dropout_prob`` attrs set to 0 in
both built programs: three steps from the reference's startup state, each
loss within ORACLE_TOL f32's 2e-4, the first step's gradient of every
parameter and every parameter after the third step within 1e-3 of its
largest magnitude (``test_torch_zoo_models._three_steps``)."""

from test_torch_zoo_models import _three_steps


def test_googlenet_three_steps():
    _three_steps("googlenet")
