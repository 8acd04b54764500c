"""Builds the port's native host library (the counterpart of
``paddle_tpu/native/build.py``).

Compiles ``src/recordio.cc`` and ``src/loader.cc`` — the port's own
copies — with g++ into one shared object with a flat C ABI, loaded
through ctypes.  The library's file name carries a digest of the
sources and flags, so a changed source builds a new library and an
unchanged one is reused; the compiler writes to a private temporary
name that is renamed into place, so processes that build at once never
load a half-written file.  The library lands in
``paddle_tpu_torch/_build/native/`` (git-ignored).
"""

import hashlib
import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
LIB_STEM = "libpaddle_tpu_torch_native"

CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]
LDLIBS = ["-lz"]


def sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cc"))


def lib_path():
    """Where the library of the current sources lives (built or not)."""
    h = hashlib.sha256()
    for s in sources():
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return os.path.join(BUILD_DIR, f"{LIB_STEM}-{h.hexdigest()[:16]}.so")


def build(force=False):
    """Compile the sources if their library is not there yet and return
    its path.  A missing compiler or a compile error raises
    ``RuntimeError`` with the compiler's output."""
    lib = lib_path()
    if os.path.exists(lib) and not force:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ([os.environ.get("CXX", "g++")] + CXXFLAGS + sources()
           + ["-o", tmp] + LDLIBS)
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        err = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                           f"{err}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


if __name__ == "__main__":
    print(build(force=True))
