"""Fused ResNet bottleneck block, forward, inference form — the port's
counterpart of ``benchmarks/bottleneck_pallas.py`` (``make_fused``, and
its composed oracle ``xla_reference``).

Calling convention and layouts are the script's::

    bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3) -> out

    x, out  [N, H, W, C]      NHWC, C = Cin = Cout (the residual)
    w1      [C, Cm]           conv1, 1x1
    w2      [3, 3, Cm, Cm]    conv2, 3x3 SAME, HWIO
    w3      [Cm, C]           conv3, 1x1
    s*, b*  [Cm] or [C] f32   batch norm folded to scale and shift

    y1  = relu(conv1(x) * s1 + b1)   f32 sums, rounded to x's dtype
    y2  = relu(conv2(y1) * s2 + b2)  f32 sums, rounded to x's dtype
    out = relu(conv3(y2) * s3 + b3 + x)

The spellings of the one function that live here:

* :func:`bottleneck_ref` — the plain PyTorch version, the script's
  ``xla_reference``: three ``F.conv2d`` on NCHW views, summed in f32 from
  the operands' exact values, with the same two roundings.  The CPU path
  and the reference the kernels are held against.
* :func:`bottleneck_rows_ref` — a plain spelling of the sm90 kernel's
  decomposition (strips of rows, a row-by-row walk, a rolling ring of y1
  rows with zero slots and zero rows), for the tests.
* two CUDA kernel families, hand-written for Hopper (``sm_90a``), which
  replace the TPU kernel ``make_fused`` (the mid activations never reach
  device memory), picked by the static rule :func:`bottleneck_family`:
  ``"sm90"`` (``csrc/bottleneck_sm90.cu``: resident weights, ``wgmma``,
  a TMA ring of x rows, a rolling y1 ring; bf16, Cm = 64, Cin = Cout a
  multiple of 64 up to 256, W <= 64, 16-byte aligned tensors) and
  ``"simple"`` (``csrc/bottleneck.cu``: bf16 with channel counts that are
  multiples of 8 on WMMA tiles, anything else on f32 FMA,
  :func:`uses_tensor_cores`).

:func:`bottleneck` is the wrapper: CPU tensors take the plain version,
CUDA tensors launch the kernel of the rule's family (or of ``family=``,
for tests) or raise — there is no fallback, from one family to the other
either.  Every launch adds one to ``bottleneck.launches`` and to its
family's count in ``BOTTLENECK_FAMILY_CALLS``.  The simple kernel picks
its own band height (:func:`band_rows`) and handles a last band that H
does not fill; the sm90 kernel takes its strip height from
:func:`strip_rows`.

:func:`kernel_weights` turns the script's weights into the kernel's
layout; :func:`fold_bn` and :func:`block_weights` take a ResNet identity
block of the port's model (OIHW filters, batch-norm parameters and
running statistics) to the same arguments.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["ORACLE_TOL", "BOTTLENECK_FAMILY_CALLS", "oracle_tol",
           "bottleneck", "bottleneck_ref", "bottleneck_rows_ref",
           "bottleneck_family", "strip_rows", "kernel_weights", "fold_bn",
           "block_weights", "band_rows", "uses_tensor_cores", "build"]

# max |kernel - ref| / max |ref|: f32 within the ORACLE_TOL f32 forward
# bound (summation order only); bf16 within the script's own criterion
# (benchmarks/bottleneck_pallas.py asserts 2e-2 against xla_reference)
ORACLE_TOL = {
    ("bottleneck", "float32"): {"fwd": 2e-4},
    ("bottleneck", "bfloat16"): {"fwd": 2e-2},
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches on the card, by kernel family (bottleneck_family)
BOTTLENECK_FAMILY_CALLS = {"sm90": 0, "simple": 0}

SM90_CM = 64         # the mid width the sm90 family takes
SM90_MAX_C = 256     # its widest Cin = Cout: the weights stay resident
SM90_MAX_W = 64      # its widest row: one image row is one 64-row tile
Y1_RING_ROWS = 6     # rows of its y1 ring


def oracle_tol(dtype, kind="fwd"):
    """The documented tolerance for ``bottleneck`` in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    return ORACLE_TOL[("bottleneck", name)][kind]


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def bottleneck_ref(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """The plain PyTorch version (module docstring): NHWC in and out."""
    dt, acc = x.dtype, _acc_dtype(x.dtype)

    def chan(v):
        return v.to(acc)[None, :, None, None]

    xn = x.permute(0, 3, 1, 2).to(acc)
    y1 = F.conv2d(xn, w1.to(acc).t()[:, :, None, None])
    y1 = torch.relu(y1 * chan(s1) + chan(b1)).to(dt)
    y2 = F.conv2d(y1.to(acc), w2.to(acc).permute(3, 2, 0, 1), padding=1)
    y2 = torch.relu(y2 * chan(s2) + chan(b2)).to(dt)
    y3 = F.conv2d(y2.to(acc), w3.to(acc).t()[:, :, None, None])
    out = torch.relu(y3 * chan(s3) + chan(b3) + xn).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


def strip_rows(n, h, sms=132):
    """The sm90 kernel's strip height for ``n`` images of ``h`` rows on a
    card of ``sms`` SMs: the strips of an image are ``sms // n`` (at least
    one, at most ``h``), so that the grid of ``n`` times that many blocks
    about fills the card, and each is ``ceil(h / strips)`` rows (the last
    may be shorter).  At N = 128 on 132 SMs a strip is a whole image."""
    strips = max(1, min(h, sms // max(n, 1)))
    return -(-h // strips)


def bottleneck_rows_ref(x, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                        strip=None, ring=Y1_RING_ROWS):
    """The plain spelling of the sm90 kernel's decomposition, NHWC in and
    out: each image is cut into strips of ``strip`` rows (default
    :func:`strip_rows` on 132 SMs); a strip walks its rows two a step,
    keeping y1 in a ring of ``ring`` rows of ``W + 2`` pixel slots (a zero
    slot at each end; rows outside the image are zero rows), computing
    conv1 once for each row it needs (its own and one halo row above and
    below), conv2 as nine shifted ``[W, Cm] . [Cm, Cm]`` products summed in
    tap order and conv3 with the residual, rounding y1 and y2 to x's dtype
    as the kernel does.  Sums in f32 (f64 for f64)."""
    n, h, w, c = x.shape
    cm = w1.shape[1]
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    strip = strip or strip_rows(n, h)
    xa, w1a, w2a, w3a = (t.to(acc) for t in (x, w1, w2, w3))
    s1, b1, s2, b2, s3, b3 = (v.to(acc) for v in (s1, b1, s2, b2, s3, b3))
    out = torch.empty_like(x)
    for img in range(n):
        for a in range(0, h, strip):
            e = min(a + strip, h)
            y1 = torch.zeros((ring, w + 2, cm), dtype=acc, device=x.device)
            steps = (e - a + 1) // 2
            for s in range(-1, steps):
                for g in (a + 2 * s + 1, a + 2 * s + 2):
                    if g > e:
                        continue      # past the strip's bottom halo row
                    slot = y1[(g - a + 1) % ring, 1:w + 1]
                    if 0 <= g < h:
                        v = torch.relu(xa[img, g] @ w1a * s1 + b1)
                        slot.copy_(v.to(dt).to(acc))
                    else:
                        slot.zero_()  # a zero row: SAME padding
                if s < 0:
                    continue
                for o in (a + 2 * s, a + 2 * s + 1):
                    if o >= e:
                        continue
                    y2 = torch.zeros((w, cm), dtype=acc, device=x.device)
                    for dy in range(3):
                        row = y1[(o + dy - a) % ring]
                        for dx in range(3):
                            y2 += row[dx:dx + w] @ w2a[dy, dx]
                    y2 = torch.relu(y2 * s2 + b2).to(dt).to(acc)
                    y3 = y2 @ w3a * s3 + b3 + xa[img, o]
                    out[img, o] = torch.relu(y3).to(dt)
    return out


def bottleneck_family(dtype, H, W, Cin, Cm, ptrs):
    """``"sm90"`` or ``"simple"``: the kernel family for ``x [N, H, W,
    Cin]`` of ``dtype`` with mid width ``Cm`` (Cout = Cin) and the base
    addresses ``ptrs`` of x, w1, w2, w3 and out.  ``"sm90"`` takes bf16,
    ``Cm == 64``, ``Cin`` a multiple of 64 up to 256 (the three weights stay
    resident in shared memory), ``W <= 64`` (one image row is one 64-row
    tile) and 16-byte aligned pointers (what TMA addresses); anything else
    is ``"simple"``.  Static: decided before any launch."""
    if dtype != torch.bfloat16 or Cm != SM90_CM or H < 1:
        return "simple"
    if Cin % 64 or not 64 <= Cin <= SM90_MAX_C or not 1 <= W <= SM90_MAX_W:
        return "simple"
    if any(p % 16 for p in ptrs):
        return "simple"
    return "sm90"


def kernel_weights(w1, w2, w3, dtype=None):
    """The script's weights (``w1 [Cin, Cm]``, ``w2 [3, 3, Cm, Cm]`` HWIO,
    ``w3 [Cm, Cout]``) as the kernel takes them: contiguous, one dtype
    (``dtype``, default ``w1``'s), ``w2`` tap-major so that tap
    ``(dy, dx)`` is the ``[Cm, Cm]`` matrix ``w2[dy, dx]`` — the HWIO order
    itself."""
    dtype = dtype or w1.dtype
    cin, cm = w1.shape
    if tuple(w2.shape) != (3, 3, cm, cm):
        raise ValueError(f"bottleneck: w2 must be [3, 3, {cm}, {cm}] (HWIO), "
                         f"got {tuple(w2.shape)}")
    if w3.dim() != 2 or w3.shape[0] != cm:
        raise ValueError(f"bottleneck: w3 must be [{cm}, Cout], got "
                         f"{tuple(w3.shape)}")
    return tuple(w.to(dtype).contiguous() for w in (w1, w2, w3))


def fold_bn(scale, offset, mean, variance, epsilon=1e-5):
    """Inference batch norm ``(v - mean) * scale / sqrt(variance + eps) +
    offset`` as ``v * s + b``: ``(s, b)`` in f32, as the port's
    ``batch_norm`` op computes them with ``is_test``."""
    s = scale.float() * torch.rsqrt(variance.float() + epsilon)
    return s, offset.float() - mean.float() * s


def block_weights(f1, f2, f3, dtype=None):
    """A ResNet bottleneck block's three conv filters in the model's OIHW
    layout (``[Cm, Cin, 1, 1]``, ``[Cm, Cm, 3, 3]``, ``[Cout, Cm, 1, 1]``)
    as :func:`kernel_weights` returns them."""
    return kernel_weights(f1[:, :, 0, 0].t(), f2.permute(2, 3, 1, 0),
                          f3[:, :, 0, 0].t(), dtype=dtype or f1.dtype)


def _check(x, w1, w2, w3, sb):
    if x.dim() != 4:
        raise ValueError(f"bottleneck: x must be [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if w1.dim() != 2 or w1.shape[0] != c:
        raise ValueError(f"bottleneck: w1 must be [{c}, Cm], got "
                         f"{tuple(w1.shape)}")
    cm = w1.shape[1]
    if tuple(w2.shape) != (3, 3, cm, cm):
        raise ValueError(f"bottleneck: w2 must be [3, 3, {cm}, {cm}], got "
                         f"{tuple(w2.shape)}")
    if tuple(w3.shape) != (cm, c):
        raise ValueError(f"bottleneck: w3 must be [{cm}, {c}] (the residual "
                         f"needs Cout == Cin), got {tuple(w3.shape)}")
    for v, n in zip(sb, (cm, cm, cm, cm, c, c)):
        if tuple(v.shape) != (n,) or v.dtype != torch.float32:
            raise ValueError(f"bottleneck: scales and shifts must be f32 "
                             f"[{n}], got {v.dtype} {tuple(v.shape)}")
    if any(w.dtype != x.dtype for w in (w1, w2, w3)):
        raise TypeError("bottleneck: x and the weights must share a dtype")
    ts = (x, w1, w2, w3) + tuple(sb)
    if any(t.device != x.device for t in ts):
        raise ValueError("bottleneck: all tensors must share a device")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bottleneck: dtype {x.dtype} not supported on the "
                        f"card (bfloat16 or float32)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("bottleneck: all tensors must be contiguous")
    if x.shape[0] > 65535:
        raise ValueError("bottleneck: at most 65535 images a call")


_fns = None
_sm90_fns = None


def _sm90_kernel():
    """The sm90 family's entry and error string function."""
    global _sm90_fns
    if _sm90_fns is None:
        lib = _build.load("bottleneck_sm90")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fwd = lib.bottleneck_sm90_fwd
        fwd.argtypes = [ptr] * 11 + [i32] * 8 + [ptr]
        fwd.restype = i32
        lib.bottleneck_sm90_error_string.argtypes = [i32]
        lib.bottleneck_sm90_error_string.restype = ctypes.c_char_p
        _sm90_fns = (fwd, lib.bottleneck_sm90_error_string)
    return _sm90_fns


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("bottleneck")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fwd = lib.bottleneck_fwd
        fwd.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
        fwd.restype = i32
        rows = lib.bottleneck_band_rows
        rows.argtypes = [i32] * 5
        rows.restype = i32
        tc = lib.bottleneck_uses_tensor_cores
        tc.argtypes = [ptr] * 5 + [i32] * 3
        tc.restype = i32
        lib.bottleneck_error_string.argtypes = [i32]
        lib.bottleneck_error_string.restype = ctypes.c_char_p
        _fns = (fwd, rows, tc, lib.bottleneck_error_string)
    return _fns


def build():
    """Build (if stale) and load the kernel libraries — set-up work that
    belongs outside any timed window."""
    _kernel()
    _sm90_kernel()


def band_rows(H, W, Cm, dtype, tensor_cores=False):
    """The band height the kernel takes for this geometry in the given
    spelling (0: the geometry's y1 band does not fit in a block's shared
    memory)."""
    return int(_kernel()[1](H, W, Cm, _DTYPE_CODE[dtype],
                            int(bool(tensor_cores))))


def uses_tensor_cores(x, w1, w2, w3, out):
    """Whether the kernel takes its tensor-core spelling for these CUDA
    tensors (bf16, channel counts multiples of 8, 16-byte aligned) or its
    f32 FMA spelling — the kernel's own rule, asked of it."""
    return bool(_kernel()[2](x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                             w3.data_ptr(), out.data_ptr(), x.shape[3],
                             w1.shape[1], _DTYPE_CODE[x.dtype]))


def bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, family=None):
    """The fused bottleneck forward (module docstring).  CPU tensors take
    :func:`bottleneck_ref`; CUDA tensors launch the kernel of the family
    :func:`bottleneck_family` picks (``family`` forces one, for tests) on
    the current stream, or raise."""
    sb = (s1, b1, s2, b2, s3, b3)
    _check(x, w1, w2, w3, sb)
    if x.device.type == "cpu":
        return bottleneck_ref(x, w1, w2, w3, *sb)
    n, h, w, c = x.shape
    cm = w1.shape[1]
    out = torch.empty_like(x)
    if family is None:
        family = bottleneck_family(x.dtype, h, w, c, cm, [
            t.data_ptr() for t in (x, w1, w2, w3, out)])
    if family == "sm90":
        fwd, errstr = _sm90_kernel()
        dev = x.device
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        with torch.cuda.device(dev):
            err = fwd(*(t.data_ptr() for t in (x, w1, w2, w3) + sb),
                      out.data_ptr(), n, h, w, c, cm, c,
                      strip_rows(n, h, sms), _DTYPE_CODE[x.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"bottleneck sm90 kernel launch failed: "
                               f"cudaError {err} ({errstr(err).decode()})")
        BOTTLENECK_FAMILY_CALLS["sm90"] += 1
        bottleneck.launches += 1
        return out
    if family != "simple":
        raise ValueError(f"bottleneck: unknown family {family!r}")
    fwd, _, _, errstr = _kernel()
    if band_rows(h, w, cm, x.dtype,
                 uses_tensor_cores(x, w1, w2, w3, out)) == 0:
        raise ValueError(f"bottleneck: a band of one row (W={w}, Cm={cm}) "
                         f"does not fit in a block's shared memory")
    with torch.cuda.device(x.device):
        err = fwd(*(t.data_ptr() for t in (x, w1, w2, w3) + sb),
                  out.data_ptr(), n, h, w, c, cm, c, _DTYPE_CODE[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bottleneck kernel launch failed: cudaError "
                           f"{err} ({errstr(err).decode()})")
    BOTTLENECK_FAMILY_CALLS["simple"] += 1
    bottleneck.launches += 1
    return out


bottleneck.launches = 0
