"""The port's kernels: each op class keeps a plain PyTorch version beside
a hand-written CUDA kernel for Hopper (``paddle_tpu_torch/csrc/``),
built at first use by ``_build``.  Wrappers take the plain version for
CPU tensors and launch the kernel for CUDA tensors, and count their
launches (``<wrapper>.launches``)."""

from . import _build
from . import flash_attention as _fa
from . import paged_attention as _pa

# name -> wrapper, for callers that reset or read every launch count
WRAPPERS = {"paged_attention": _pa.paged_attention,
            "flash_attention_fwd": _fa.flash_fwd,
            "flash_attention_bwd": _fa.flash_bwd}


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0


def build_all():
    """Build (if stale) every kernel source, in parallel, and load the
    libraries — set-up work that belongs outside any timed window."""
    _build.build()
    _pa.build()
    _fa.build()


__all__ = ["WRAPPERS", "reset_launches", "build_all"]
