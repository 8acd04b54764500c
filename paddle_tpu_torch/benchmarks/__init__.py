"""Benchmarks of the port's kernels, each runnable as a module
(``python -m paddle_tpu_torch.benchmarks.<name>``)."""
