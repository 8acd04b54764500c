"""Device placement — the one rule every entry point follows.

The counterpart of ``paddle_tpu/core/place.py``, where a Place selects a
``jax.Device``.  The port runs on the card: an entry point given no
device resolves to ``cuda``, and on a host without a usable card it
raises instead of dropping to the CPU.  The CPU is reached only when the
caller asks for it by name (the CPU tests do), and then every kernel
wrapper takes its plain PyTorch version because the tensors it is
handed lie on the CPU.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the card (``cuda``).  ``"cpu"`` must be asked for
    explicitly.  A CUDA request on a host with no usable card raises
    ``RuntimeError`` — nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; paddle_tpu_torch runs on the "
            "card by default — pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev
