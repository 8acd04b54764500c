"""The port's kernels: each op class keeps a plain PyTorch version beside
a hand-written CUDA kernel for Hopper (``paddle_tpu_torch/csrc/``),
built at first use by ``_build``.  Wrappers take the plain version for
CPU tensors and launch the kernel for CUDA tensors, and count their
launches (``<wrapper>.launches``) and, where a static rule picks among
kernel families, the calls of each family (``FAMILIES``)."""

from . import _build
from . import bottleneck as _bn
from . import decode_gather as _dg
from . import flash_attention as _fa
from . import fused_ce as _ce
from . import paged_attention as _pa

# name -> wrapper, for callers that reset or read every launch count
WRAPPERS = {"paged_attention": _pa.paged_attention,
            "decode_gather": _dg.decode_gather,
            "flash_attention_fwd": _fa.flash_fwd,
            "flash_attention_bwd": _fa.flash_bwd,
            "flash_attention_bwd_delta": _fa.flash_bwd_delta,
            "flash_attention_bwd_dq": _fa.flash_bwd_dq,
            "flash_attention_bwd_dkv": _fa.flash_bwd_dkv,
            "fused_ce_fwd": _ce.ce_fwd,
            "fused_ce_dx": _ce.ce_dx,
            "fused_ce_dw": _ce.ce_dw,
            "bottleneck": _bn.bottleneck}


# name -> {family: calls} of the wrappers whose kernels come in families
FAMILIES = {"paged_attention": _pa.PAGED_FAMILY_CALLS,
            "flash_attention_fwd": _fa.FWD_FAMILY_CALLS,
            "flash_attention_bwd": _fa.FUSED_FAMILY_CALLS,
            "flash_attention_split": _fa.BWD_FAMILY_CALLS,
            "fused_ce_fwd": _ce.CE_FWD_FAMILY_CALLS,
            "fused_ce_dx": _ce.CE_DX_FAMILY_CALLS,
            "fused_ce_dw": _ce.CE_DW_FAMILY_CALLS,
            "bottleneck": _bn.BOTTLENECK_FAMILY_CALLS}


def reset_launches():
    """Every launch count, and every family's, back to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for calls in FAMILIES.values():
        for fam in calls:
            calls[fam] = 0


def family_counts():
    """``{name: {family: calls}}`` of every wrapper with kernel families."""
    return {nm: dict(calls) for nm, calls in FAMILIES.items()}


def launch_counts():
    """``{name: launches}`` of every wrapper."""
    return {nm: fn.launches for nm, fn in WRAPPERS.items()}


def build_all():
    """Build (if stale) every kernel source, in parallel, and load the
    libraries — set-up work that belongs outside any timed window."""
    _build.build()
    _pa.build()
    _dg.build()
    _fa.build()
    _ce.build()
    _bn.build()


__all__ = ["WRAPPERS", "FAMILIES", "reset_launches", "launch_counts",
           "family_counts", "build_all"]
