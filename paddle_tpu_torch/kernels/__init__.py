"""The port's kernels: each op class keeps a plain PyTorch version beside
a hand-written CUDA kernel for Hopper (``paddle_tpu_torch/csrc/``),
built at first use by ``_build``, and, for ``flash_attention`` and
``paged_attention``, Triton kernels (``triton_attention``).  Wrappers
take the plain version for CPU tensors and launch the kernel for CUDA
tensors, and count their launches (``<wrapper>.launches``) and, where a
static rule picks among kernel families, the calls of each family
(``FAMILIES``).

Every op class resolves its backend (``cuda``, ``triton`` or
``torch_ref``) through :mod:`.registry`: an explicit ``backend=``, a
forced backend, ``PADDLE_TPU_KERNEL_BACKEND_<OP>``,
``PADDLE_TPU_KERNEL_BACKEND``, then auto (``cuda`` on a card, the plain
versions on the CPU).  Triton writes its compiled kernels under
``paddle_tpu_torch/_build/triton/`` unless ``TRITON_CACHE_DIR`` is set.
``python -m paddle_tpu_torch --kernels-selftest`` checks the whole
surface."""

import os
import re

from . import registry  # first: the kernel modules register into it
from .registry import (
    AUTO_ORDER, BACKENDS, GLOBAL_ENV, TIMED_RUN_ENV, KernelUnavailable,
    available_backends, forced_backend, get_kernel, registered_op_classes,
    reset_selected, resolve, resolve_name, selected_backends, timed_run,
    timed_run_active)
from . import _build
from . import bottleneck as _bn
from . import decode_gather as _dg
from . import flash_attention as _fa
from . import fused_ce as _ce
from . import paged_attention as _pa
from . import triton_attention as _tr

os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(_build.BUILD_DIR, "triton"))

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
            "bottleneck": _bn.bottleneck,
            "paged_attention_triton": _pa.paged_attention_triton,
            "flash_attention_triton_fwd": _tr.flash_fwd_triton,
            "flash_attention_triton_dq": _tr.flash_bwd_dq_triton,
            "flash_attention_triton_dkv": _tr.flash_bwd_dkv_triton}


# the ``__global__`` functions of ``csrc/`` and the ``@triton.jit``
# functions, as a profiler names them (a kernel's trace name holds its
# function name as a word)
KERNEL_NAMES = _tr.KERNEL_NAMES + (
    "paged_attention_kernel", "paged_split_kernel", "paged_merge_kernel",
    "decode_gather_kernel",
    "flash_fwd_kernel", "flash_fwd_sm90_kernel", "flash_bwd_kernel",
    "flash_bwd_sm90_fused_kernel", "flash_bwd_delta_kernel",
    "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
    "flash_bwd_sm90_dq_kernel", "flash_bwd_sm90_dkv_kernel",
    "ce_fwd_kernel", "ce_fwd_sm90_kernel", "ce_dx_kernel",
    "ce_dx_sm90_kernel", "ce_dw_kernel", "ce_dw_sm90_kernel",
    "bottleneck_kernel", "bottleneck_sm90_kernel")
_KERNEL_RE = re.compile(r"\b(" + "|".join(KERNEL_NAMES) + r")\b")


def hand_written(trace_name):
    """The ``csrc/`` kernel a profiler's kernel name is, or None (a
    library's kernel)."""
    m = _KERNEL_RE.search(trace_name)
    return m.group(1) if m else None


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
    _pa.PAGED_SPLIT_CALLS.clear()


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


__all__ = ["WRAPPERS", "FAMILIES", "KERNEL_NAMES", "hand_written",
           "reset_launches", "launch_counts", "family_counts", "build_all",
           "registry", "AUTO_ORDER", "BACKENDS", "GLOBAL_ENV",
           "TIMED_RUN_ENV", "KernelUnavailable", "available_backends",
           "forced_backend", "get_kernel", "registered_op_classes",
           "reset_selected", "resolve", "resolve_name",
           "selected_backends", "timed_run", "timed_run_active"]
