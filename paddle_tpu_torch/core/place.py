"""Device placement — the one rule every entry point follows.

The counterpart of ``paddle_tpu/core/place.py``, where a Place selects a
``jax.Device``.  The port runs on the card: an entry point given no
device resolves to ``cuda``, and on a host without a usable card it
raises instead of dropping to the CPU.  The CPU is reached only when the
caller asks for it by name (``device="cpu"`` / ``CPUPlace()``, as the CPU
tests do), and then every kernel wrapper takes its plain PyTorch version
because the tensors it is handed lie on the CPU.
"""

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the card (``cuda``).  ``"cpu"`` must be asked for
    explicitly.  A ``Place`` resolves to its device.  A CUDA request on a
    host with no usable card raises ``RuntimeError`` — nothing falls back
    to the CPU silently."""
    if isinstance(device, Place):
        device = device.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; paddle_tpu_torch runs on the "
            "card by default — pass device='cpu' / CPUPlace() to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


class Place:
    """Where an Executor runs (``paddle_tpu.core.place``'s Places)."""

    device = None

    def __repr__(self):
        return f"{type(self).__name__}({self.device!r})"


class CPUPlace(Place):
    def __init__(self):
        self.device = "cpu"


class CUDAPlace(Place):
    """The card with index ``device_id`` (default 0)."""

    def __init__(self, device_id=0):
        self.device = f"cuda:{int(device_id)}"
