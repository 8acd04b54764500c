"""paddle_tpu_torch — the PyTorch / CUDA port of ``paddle_tpu`` for an
NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package does what
it does in PyTorch, and every kernel the JAX package wrote in Pallas
for the TPU is a kernel written by hand for Hopper (``csrc/``, built by
``nvcc`` for ``sm_90a`` at first use into ``_build/``).  It imports
torch, numpy and the standard library, never jax and nothing of
``paddle_tpu``.  Entry points run on the card unless the caller passes
``device="cpu"``; with no card and no such request they raise.

Ported so far: the serving path (``serving``, ``models.transformer``,
``kernels.paged_attention``).
"""

from .core.place import resolve_device

__all__ = ["resolve_device"]
