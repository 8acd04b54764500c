"""paddle_tpu_torch.analysis — checks over what a step did.  ``comm``
holds the communication plan of a mesh step and the contracts it is
held to (``paddle_tpu/analysis/comm``)."""

from . import comm

__all__ = ["comm"]
