"""Device layers (reference: fluid/layers/device.py:26 ``get_places`` —
feeds ``parallel_do``'s place list; ``paddle_tpu/layers/device.py``).  A
mesh is the port's place list and parallelism is sharding, so this
returns the devices for introspection only."""

import torch

from ..core.place import CPUPlace, CUDAPlace

__all__ = ["get_places"]


def get_places(device_count=None, device_type=None):
    """The places of this host: every card (``CUDAPlace(i)``), or the CPU
    (``CPUPlace()``) when ``device_type`` is ``"CPU"`` or there is no
    card; at most ``device_count`` of them."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "CPU" or (not cards and device_type is None):
        places = [CPUPlace()]
    elif device_type in (None, "GPU", "CUDA", "TPU"):
        places = [CUDAPlace(i) for i in range(cards)]
    else:
        raise ValueError(f"unknown device_type {device_type!r}")
    if device_count:
        places = places[:device_count]
    return places
