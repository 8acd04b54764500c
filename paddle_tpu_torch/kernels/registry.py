"""Multi-backend kernel registry — the port's counterpart of
``paddle_tpu/kernels/registry.py``.

Each fused op class (``flash_attention``, ``fused_ce``,
``paged_attention``, ``decode_gather``) registers up to three backends,
and every call site resolves through one selection path:

* ``cuda`` — the hand-written CUDA C++ kernels for Hopper
  (``paddle_tpu_torch/csrc/``) behind the wrappers of ``kernels/`` and
  their static family rules.  Available where torch sees a card; a kernel
  that then fails to build or launch raises where it fails (it never
  makes the backend "unavailable").
* ``triton`` — the JAX package's GPU decomposition as ``@triton.jit``
  kernels (``kernels/triton_attention.py``,
  ``kernels/paged_attention.py: paged_attention_triton``): a parallel
  grid over independent cells, the reduction loop inside the body.
  Available where ``triton`` is installed and torch sees a card.
* ``torch_ref`` — the plain PyTorch versions beside each kernel (the
  numerics every backend is held against).  Always available.  On a CUDA
  tensor it runs only when asked for by name.

Selection precedence (``tests/test_torch_kernel_registry.py`` pins it):

1. an explicit ``backend=`` argument at the call site — an unknown name
   raises ``ValueError``, an unavailable backend :class:`KernelUnavailable`
   with the probe's reason; then a backend forced by
   :func:`forced_backend` (the tuner's hook);
2. the per-op env ``PADDLE_TPU_KERNEL_BACKEND_<OP>`` (the op class upper
   cased) — as strict as an argument;
3. the global env ``PADDLE_TPU_KERNEL_BACKEND=auto|cuda|triton|
   torch_ref`` — where the op cannot serve it, resolution falls back to
   auto and ``kernels.env_fallbacks`` counts it (a forced backend does
   the same);
4. ``auto`` — the first registered and available backend of the
   platform's order (:data:`AUTO_ORDER`).

The platform is the device type of the call's tensors (``"cuda"`` or
``"cpu"``); the reference asks ``jax.default_backend()``.  Every
resolution is recorded (:func:`selected_backends`; the Executor snapshots
it into ``last_step_cost["kernel_backends"]`` for a lowered step's first
run) and counted in ``kernels.resolved``.
"""

import contextlib
import os
import threading

from ..observability import metrics as _obs

__all__ = [
    "BACKENDS", "AUTO_ORDER", "KernelUnavailable", "register_kernel",
    "get_kernel", "resolve", "resolve_name", "available_backends",
    "registered_op_classes", "selected_backends", "reset_selected",
    "forced_backend", "timed_run", "timed_run_active", "default_platform",
    "cuda_availability", "triton_availability", "TIMED_RUN_ENV",
    "GLOBAL_ENV",
]

BACKENDS = ("cuda", "triton", "torch_ref")

GLOBAL_ENV = "PADDLE_TPU_KERNEL_BACKEND"
TIMED_RUN_ENV = "PADDLE_TPU_TIMED_RUN"

# per-platform auto preference.  On a card auto never picks torch_ref:
# falling back to the plain version there would hide the kernel, so the
# plain version runs on a CUDA tensor only when it is asked for by name.
AUTO_ORDER = {
    "cuda": ("cuda", "triton"),
    "cpu": ("torch_ref",),
}


class KernelUnavailable(RuntimeError):
    """A requested backend is not available for the op class here (not
    registered for it, or its probe says no); ``.reason`` carries the
    probe's explanation."""

    def __init__(self, op_class, backend, reason):
        super().__init__(
            f"kernel backend {backend!r} for op {op_class!r} is "
            f"unavailable on this host: {reason}")
        self.op_class = op_class
        self.backend = backend
        self.reason = reason


class _Kernel:
    __slots__ = ("op_class", "backend", "impl", "_available")

    def __init__(self, op_class, backend, impl, available):
        self.op_class = op_class
        self.backend = backend
        self.impl = impl
        self._available = available

    def availability(self):
        """``(ok, reason)``.  A probe answers whether the backend can run
        here at all; it does not build or launch anything, so a kernel's
        build or launch error surfaces at its call, never as absence."""
        if self._available is None:
            return True, ""
        out = self._available()
        if isinstance(out, tuple):
            return bool(out[0]), str(out[1] or "")
        return bool(out), ""


_KERNELS = {}      # {op_class: {backend: _Kernel}}
_SELECTED = {}     # {op_class: backend}: the latest resolutions
_SEL_LOCK = threading.Lock()
_FORCED = []       # [(op_class or None, backend)]: the forced_backend stack


def register_kernel(op_class, backend, impl, available=None):
    """Register ``impl`` (a namespace of callables; each op class defines
    its calling convention) as ``op_class``'s ``backend``.  ``available``
    is a zero-argument probe returning ``bool`` or ``(bool, reason)``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} (valid: {BACKENDS})")
    per_op = _KERNELS.setdefault(op_class, {})
    if backend in per_op:
        raise ValueError(
            f"kernel {op_class!r}/{backend!r} registered twice")
    per_op[backend] = _Kernel(op_class, backend, impl, available)
    return impl


def registered_op_classes():
    return sorted(_KERNELS)


def get_kernel(op_class, backend):
    """The registered ``_Kernel`` or None (introspection: no resolution,
    no record)."""
    return _KERNELS.get(op_class, {}).get(backend)


def available_backends(op_class):
    """``[(backend, ok, reason)]`` for every registered backend of the op
    class, in ``BACKENDS`` order."""
    per_op = _KERNELS.get(op_class, {})
    out = []
    for b in BACKENDS:
        k = per_op.get(b)
        if k is not None:
            ok, reason = k.availability()
            out.append((b, ok, reason))
    return out


def cuda_availability():
    """The ``cuda`` backends' probe: a card that torch sees, and nothing
    more (a kernel that fails to build raises at its call)."""
    import torch

    if torch.cuda.is_available():
        return True, ""
    return False, "no CUDA device"


def triton_availability():
    """The ``triton`` backends' probe: the ``triton`` package is installed
    (looked up, not imported: the kernels import it when they launch) and
    torch sees a card."""
    import importlib.util

    if importlib.util.find_spec("triton") is None:
        return False, "triton is not importable: no module named 'triton'"
    return cuda_availability()


def default_platform():
    """The platform of a resolution that names none: the card when torch
    sees one (the port's entry points run there unless asked otherwise),
    else the CPU.  Call sites with tensors pass their device type."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def _env_value(op_class):
    """``(value, source)`` from the env layers: per-op wins over global;
    empty values fall through."""
    per_op = os.environ.get(
        f"{GLOBAL_ENV}_{op_class.upper()}", "").strip().lower()
    if per_op:
        return per_op, "env_op"
    glob = os.environ.get(GLOBAL_ENV, "").strip().lower()
    if glob:
        return glob, "env"
    return None, "auto"


def _auto_resolve(op_class, platform):
    order = AUTO_ORDER.get(platform)
    if order is None:
        raise ValueError(f"kernel registry: unknown platform {platform!r} "
                         f"(valid: {', '.join(AUTO_ORDER)})")
    per_op = _KERNELS.get(op_class, {})
    reasons = []
    for b in order:
        k = per_op.get(b)
        if k is None:
            reasons.append(f"{b}: not registered")
            continue
        ok, reason = k.availability()
        if ok:
            return k
        reasons.append(f"{b}: {reason or 'unavailable'}")
    raise KernelUnavailable(
        op_class, "auto",
        f"no backend available on platform {platform!r} "
        f"({'; '.join(reasons) or 'none registered'})")


def _validate(name):
    if name not in BACKENDS and name != "auto":
        raise ValueError(
            f"unknown kernel backend {name!r} (valid: auto, "
            f"{', '.join(BACKENDS)})")


def resolve(op_class, backend=None, platform=None, record=True):
    """The backend one call site of ``op_class`` runs on ``platform``
    (``"cuda"`` or ``"cpu"``: the device type of its tensors; None: see
    :func:`default_platform`).  Returns the chosen ``_Kernel``.

    Precedence: explicit ``backend`` > forced > per-op env > global env >
    auto (module docstring).  An explicit or per-op request is strict
    (unknown raises ``ValueError``, unavailable
    :class:`KernelUnavailable`); a global-env or forced request that this
    op cannot serve falls back to auto, counted in
    ``kernels.env_fallbacks``.  The resolution is recorded in
    :func:`selected_backends` and counted in ``kernels.resolved``;
    ``record=False`` (the lints' look-ahead) does neither."""
    if op_class not in _KERNELS:
        raise KeyError(f"no kernels registered for op {op_class!r}")
    platform = platform or default_platform()
    strict = True
    name = backend
    if name is None and _FORCED:
        for scope, forced in reversed(_FORCED):
            if scope is None or scope == op_class:
                name, strict = forced, False
                break
    if name is None:
        name, source = _env_value(op_class)
        strict = source == "env_op"
    if name is not None:
        name = str(name).strip().lower()
        _validate(name)
    if name is None or name == "auto":
        kernel = _auto_resolve(op_class, platform)
    else:
        kernel = _KERNELS[op_class].get(name)
        ok, reason = (kernel.availability() if kernel is not None
                      else (False, "not registered for this op"))
        if not ok:
            if strict:
                raise KernelUnavailable(op_class, name,
                                        reason or "unavailable")
            # a fleet-wide pin (or a tuner's forced candidate) must never
            # crash the one op that lacks the backend
            if record:
                _obs.get_registry().counter(
                    "kernels.env_fallbacks",
                    help="kernel backend requests that fell back to auto "
                         "(requested backend unavailable for the op)").inc()
            kernel = _auto_resolve(op_class, platform)
    if record:
        with _SEL_LOCK:
            _SELECTED[op_class] = kernel.backend
        _obs.get_registry().counter(
            "kernels.resolved",
            help="kernel registry resolutions (per call site)").inc()
    return kernel


def resolve_name(op_class, backend=None, platform=None):
    """:func:`resolve`, returning just the backend name."""
    return resolve(op_class, backend=backend, platform=platform).backend


def selected_backends():
    """The latest resolution of each op class — what the Executor folds
    into ``last_step_cost["kernel_backends"]`` (it resets the record
    before a lowered step's first run)."""
    with _SEL_LOCK:
        return dict(_SELECTED)


def reset_selected():
    with _SEL_LOCK:
        _SELECTED.clear()


@contextlib.contextmanager
def forced_backend(backend, op_class=None):
    """Force resolution to ``backend`` inside the context (every op class,
    or one) — how the tuner measures a backend candidate and how tests
    route without touching the environment.  Not strict: an op the
    backend cannot serve falls back to auto (counted).  An explicit
    ``backend=`` argument at a call site still wins."""
    if backend is not None:
        _validate(str(backend).strip().lower())
    _FORCED.append((op_class, None if backend is None
                    else str(backend).strip().lower()))
    try:
        yield
    finally:
        _FORCED.pop()


def timed_run_active():
    """True inside a declared timed-run region: there the
    ``jaxpr.kernel-backend`` lint holds every kernel op class to a
    hand-written kernel."""
    return os.environ.get(TIMED_RUN_ENV, "").lower() in (
        "1", "true", "yes")


@contextlib.contextmanager
def timed_run():
    """Declare a timed-run region: a kernel op class that runs its plain
    version (``torch_ref``) or a forced simple family inside it is a
    ``jaxpr.kernel-backend`` error — the timing would measure a stand-in,
    not the kernel."""
    old = os.environ.get(TIMED_RUN_ENV)
    os.environ[TIMED_RUN_ENV] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(TIMED_RUN_ENV, None)
        else:
            os.environ[TIMED_RUN_ENV] = old
