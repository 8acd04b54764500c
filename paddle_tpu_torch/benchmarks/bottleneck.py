"""The fused ResNet bottleneck kernel against the composed convolutions —
the PyTorch counterpart of ``benchmarks/bottleneck_pallas.py``.

One conv2-stage bottleneck block of ResNet-50, forward, inference form:
NHWC, batch 128 at 56 x 56, 256 -> 64 -> 3x3 64 -> 256 plus the residual
and relu, batch norm folded to per-channel scale and shift.  The inputs
are the script's, from ``numpy.random.default_rng(0)``: x and the weights
normal times 0.5 and 0.05 in bf16, the scales and shifts 1.0 + 0.1 times
normal in f32.  The kernel (``kernels/bottleneck.py``) must agree with the
composed version (``bottleneck_ref``, the script's ``xla_reference``) to
a max relative difference under 2e-2; on the card both are then timed.

    python -m paddle_tpu_torch.benchmarks.bottleneck [--batch N]
                                                      [--device cuda|cpu]

On the CPU (``--device cpu``, batch 2 by default, as the script's
``--interpret`` path) the wrapper takes the plain version: the run checks
the inputs and the shapes only.
"""

import argparse

import numpy as np
import torch

from ..core.place import resolve_device
from ..kernels import bottleneck as bn

H = W = 56
CIN = COUT = 256
CM = 64


def make_inputs(batch, device, dtype=torch.bfloat16, seed=0, h=H, w=W,
                cin=CIN, cm=CM):
    """The script's seeded inputs ``(x, w1, w2, w3, s1, b1, s2, b2, s3,
    b3)`` on ``device``, drawn in its order."""
    rng = np.random.default_rng(seed)

    def t(a, dt):
        return torch.tensor(a, dtype=torch.float32).to(dt).to(device)

    x = t(rng.normal(size=(batch, h, w, cin)) * 0.5, dtype)
    w1 = t(rng.normal(size=(cin, cm)) * 0.05, dtype)
    w2 = t(rng.normal(size=(3, 3, cm, cm)) * 0.05, dtype)
    w3 = t(rng.normal(size=(cm, cin)) * 0.05, dtype)
    sb = [t(rng.normal(size=(c,)) * 0.1 + 1.0, torch.float32)
          for c in (cm, cm, cm, cm, cin, cin)]
    return (x,) + bn.kernel_weights(w1, w2, w3) + tuple(sb)


def max_rel(got, want):
    """max |got - want| / max |want|, in f32."""
    scale = want.float().abs().max().item() or 1.0
    return (got.float() - want.float()).abs().max().item() / scale


def device_ms(fn, reps=20):
    """Median device time of one call over ``reps`` timed calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="images (default 128 on the card, 2 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    batch = args.batch or (128 if device.type == "cuda" else 2)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    args_ = make_inputs(batch, device)
    out = bn.bottleneck(*args_)
    ref = bn.bottleneck_ref(*args_)
    err = max_rel(out, ref)
    print(f"max rel diff fused vs composed: {err:.2e}")
    if not err < bn.oracle_tol(torch.bfloat16):     # the script's 2e-2
        raise SystemExit("fused bottleneck disagrees with the composed "
                         "convolutions")
    if device.type != "cuda":
        print("CPU check OK (the wrapper took the plain version)")
        return 0
    flops = 2 * batch * H * W * (CIN * CM + 9 * CM * CM + CM * COUT)
    for name, fn in (("fused kernel", lambda: bn.bottleneck(*args_)),
                     ("composed (plain)", lambda: bn.bottleneck_ref(*args_))):
        ms = device_ms(fn)
        print(f"{name}: {ms:8.3f} ms ({flops / (ms * 1e-3) / 1e12:6.1f} "
              f"TFLOP/s)")
    print(f"bound (x read, out written once over 3.35 TB/s): "
          f"{2 * args_[0].numel() * 2 / 3.35e12 * 1e3:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
