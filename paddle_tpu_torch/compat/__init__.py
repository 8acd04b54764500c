"""Compatibility surfaces for the older APIs (``paddle_tpu/compat/``).

`v1` — the trainer_config_helpers layer-DSL names
(python/paddle/trainer_config_helpers/layers.py).  The shim maps them onto
the port's layers DSL, so a v1-style model config builds a Program
directly; the v1 proto pipeline (config_parser -> TrainerConfig proto) is
not reproduced: the configuration is the Program.
"""

from . import v1

__all__ = ["v1"]
