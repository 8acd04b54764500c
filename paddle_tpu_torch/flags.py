"""Process flags — the port's counterpart of ``paddle_tpu/flags.py``
(reference: gflags — legacy set in utils/Flags.h:19-44,
fluid's own in executor.cc:27-30 ``do_memory_benchmark``/``check_nan_inf``
and operator.cc ``op_sync``; Python argv forwarded via init_gflags,
pybind.cc:430).

A tiny typed flag registry, initialized from environment variables under
the JAX package's names (``PADDLE_TPU_<FLAG>``) and/or ``init_flags(argv)``.
Consumed by the Executor (``check_nan_inf``, ``do_memory_benchmark``) and
available to user code.  Only the flags something reads are defined: the
JAX package's ``use_pallas`` (the port has no Pallas kernels), ``profile``,
``log_period`` and ``seed`` (read nowhere there either) are not."""

import os

__all__ = ["FLAGS", "define_flag", "init_flags"]

_DEFS = {}


class _Flags:
    def __getattr__(self, name):
        if name in _DEFS:
            return _DEFS[name]["value"]
        raise AttributeError(f"unknown flag {name!r}")

    def __setattr__(self, name, value):
        if name not in _DEFS:
            raise AttributeError(f"unknown flag {name!r}")
        _DEFS[name]["value"] = _DEFS[name]["type"](value)


FLAGS = _Flags()


def _parse_bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


def define_flag(name, default, help="", type=None):
    if type is None:
        type = _parse_bool if isinstance(default, bool) else default.__class__
    value = default
    env = os.environ.get(f"PADDLE_TPU_{name.upper()}")
    if env is not None:
        value = type(env)
    _DEFS[name] = {"value": value, "type": type, "help": help,
                   "default": default}


def init_flags(argv):
    """Parse ``--flag=value`` / ``--flag value`` tokens (init_gflags
    analog); returns unrecognized tokens."""
    rest, i = [], 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            body = tok[2:]
            if "=" in body:
                k, v = body.split("=", 1)
            elif (i + 1 < len(argv) and body in _DEFS
                  and _DEFS[body]["type"] is not _parse_bool):
                # gflags semantics: only non-bool flags take the next
                # token as a value; a bare bool flag means "true"
                k, v = body, argv[i + 1]
                i += 1
            else:
                k, v = body, "true"
            if k in _DEFS:
                setattr(FLAGS, k, v)
            else:
                rest.append(tok)
        else:
            rest.append(tok)
        i += 1
    return rest


# -- the reference flag set ----------------------------------------------
define_flag("check_nan_inf", False,
            "check every float the step wrote or fetched for NaN/Inf after "
            "every run, a host sync each (executor.cc:28 FLAGS_check_nan_inf)")
define_flag("do_memory_benchmark", False,
            "log live-state bytes per step (executor.cc:27)")
