"""Shared fixture for the port's test files that run the reference's
Executor.

The reference's Executor keeps process-wide high-water gauges
(``set_max``): a compile raises ``executor.temp_bytes``,
``executor.hbm_high_water_bytes`` and ``executor.compiled_peak_bytes``
past what a later test file in the same process compares its own step
against (``tests/test_memory_engine.py::
test_step_cost_memory_fields_and_gauges``).  A file that imports
``restore_reference_gauges`` puts them back as it found them.  Usage::

    from torch_ref_gauges import restore_reference_gauges  # noqa: F401
"""

import pytest

GAUGES = ("executor.temp_bytes", "executor.hbm_high_water_bytes",
          "executor.compiled_peak_bytes")


@pytest.fixture(scope="module", autouse=True)
def restore_reference_gauges():
    """Module-wide: the reference's high-water gauges after the file are
    what they were before it."""
    from paddle_tpu.observability.metrics import get_registry

    reg = get_registry()
    before = {n: reg.value(n) for n in GAUGES}
    yield
    for n, v in before.items():
        reg.gauge(n).set(v)
