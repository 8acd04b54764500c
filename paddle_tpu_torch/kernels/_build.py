"""Builds the port's hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into
its own shared library with a plain C interface, and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension.load`` takes).  Libraries land in
``paddle_tpu_torch/_build/`` under a name keyed by a hash of the
source, the headers beside it and the flags, so a changed source
rebuilds and an unchanged one is reused — the idiom of
``paddle_tpu/native/build.py``.  Sources build in parallel: one
``nvcc`` per source, all started together.

Nothing here runs at import: the first launch of a kernel (or an
explicit :func:`build`) builds it.  This host-side module never needs
a card; ``nvcc`` is taken from ``$NVCC``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.dirname(_HERE)
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# sm_90a keeps wgmma / setmaxnreg available to later kernels; -Xptxas -v
# puts each kernel's registers, shared memory and spills in the log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}          # source name -> loaded ctypes.CDLL
build_seconds = {}  # source name -> nvcc wall this process spent (0: cached)


def sources():
    """Names (file stems) of every kernel source under ``csrc/``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(SRC_DIR, "*.cu")))


def nvcc_path():
    cand = [os.environ.get("NVCC"), shutil.which("nvcc"),
            "/usr/local/cuda/bin/nvcc"]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set $NVCC, or put the CUDA toolkit's bin/ on "
        "PATH); the CUDA kernels build on the machine with the card")


def _digest(name):
    h = hashlib.sha256()
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name):
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def log_path(name):
    """nvcc's output (with ``-Xptxas -v``) of the last build of ``name``."""
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.log")


def build(names=None):
    """Compile every stale source in ``names`` (default: all of
    ``csrc/``), in parallel, and return ``{name: library path}``.
    Raises ``RuntimeError`` with nvcc's output when a build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        log = open(log_path(name), "w")
        cmd = ([nvcc_path()] + NVCC_FLAGS
               + [os.path.join(SRC_DIR, f"{name}.cu"), "-o", tmp])
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in running.items():
        rc = proc.wait()
        log.close()
        build_seconds[name] = time.perf_counter() - t0
        if rc == 0:
            # atomic publish: a concurrent build of the same digest
            # either sees no library or the complete one
            os.replace(tmp, out)
        else:
            with open(log_path(name)) as f:
                failed.append(f"{name}.cu (nvcc rc {rc}):\n{f.read()}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def load(name):
    """The ``ctypes.CDLL`` of kernel source ``name``, built on first use.
    Thread-safe (the serving thread may be the first caller)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib
