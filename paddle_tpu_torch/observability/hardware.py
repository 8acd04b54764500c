"""Hardware accounting: the card's peak FLOP/s, MFU and device-memory
stats — the port's counterpart of
``paddle_tpu/observability/hardware.py``.

The peak table holds the one card the port is written for, from NVIDIA's
H100 data sheet (SXM part, dense rate, 700 W): 989 TFLOP/s in bf16.  It
is keyed by the name ``torch.cuda.get_device_name`` reports for that
part.  A card the table does not name has no peak, so its ``mfu`` is
None: nothing falls back to another chip's figure.  The CPU has a
nominal 1e12 FLOP/s so MFU stays defined in CPU dev loops; against it
only step-to-step deltas mean anything.  ``HBM_BW`` is the same card's
memory rate from the same data sheet (3.35 TB/s), the memory side of the
attribution roofline (``observability/attribution.py``), keyed like the
peak; the CPU has a nominal 50 GB/s.  ``device_hbm_bytes`` is the card's
``total_memory`` (None on the CPU), the ceiling the ``hlo.hbm-preflight``
check holds a step's memory figure to.

``device_memory_stats`` reads ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info`` ({} on the CPU); ``sample_memory`` publishes
per-device ``device.bytes_in_use`` / ``device.peak_bytes_in_use`` gauges
and the process-wide ``device.hbm_high_water_bytes`` high-water mark.
"""

import torch

from ..core.place import resolve_device
from . import metrics as _metrics

__all__ = [
    "PEAK_BF16", "HBM_BW", "device_peak_flops", "device_hbm_bandwidth",
    "device_hbm_bytes", "mfu", "device_memory_stats", "sample_memory",
]

# bf16 dense peak FLOP/s by device-name substring (NVIDIA H100 data
# sheet, SXM part; the PCIe and NVL parts are slower and are named
# otherwise, so they match no row)
PEAK_BF16 = (("H100 80GB HBM3", 989e12),)

# HBM bytes/s by the same device-name substring (NVIDIA H100 data
# sheet, SXM part)
HBM_BW = (("H100 80GB HBM3", 3.35e12),)

# Nominal CPU figure so MFU stays defined on CPU runs (dev loops, CI)
_CPU_NOMINAL_PEAK = 1e12

# Nominal CPU memory rate (the reference's; only relative figures mean
# anything against it)
_CPU_NOMINAL_BW = 50e9


def _device(device):
    """``resolve_device``'s device (None: the card, raising without one),
    with the current card's index filled in."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _lookup(device, table=PEAK_BF16):
    name = torch.cuda.get_device_name(device)
    for sub, value in table:
        if sub in name:
            return value
    return None


def device_peak_flops(device=None):
    """Peak bf16 FLOP/s of one device (default: the current card), None
    for a card the table does not name; the nominal CPU constant for
    ``cpu``."""
    dev = _device(device)
    if dev.type == "cpu":
        return _CPU_NOMINAL_PEAK
    return _lookup(dev)


def device_hbm_bandwidth(device=None):
    """Memory rate in bytes/s of one device (default: the current card),
    None for a card the table does not name; the nominal CPU constant for
    ``cpu``."""
    dev = _device(device)
    if dev.type == "cpu":
        return _CPU_NOMINAL_BW
    return _lookup(dev, HBM_BW)


def device_hbm_bytes(device=None):
    """The card's memory capacity in bytes (``total_memory``), or None on
    the CPU, which reports none."""
    dev = _device(device)
    if dev.type == "cpu":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def mfu(flops_per_step, step_seconds, peak_flops):
    """Model FLOPs utilization in [0, 1]; None when not computable."""
    if not flops_per_step or not step_seconds or not peak_flops:
        return None
    if step_seconds <= 0 or peak_flops <= 0:
        return None
    return flops_per_step / step_seconds / peak_flops


def device_memory_stats(device=None):
    """The caching allocator's figures for one card as a dict
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit`` — the
    reference's keys); {} on the CPU or with no card."""
    if device is not None and torch.device(device).type == "cpu":
        return {}
    if not torch.cuda.is_available():
        return {}
    dev = _device(device)
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(total)}


def sample_memory(registry=None, devices=None):
    """Sample every card's memory stats into gauges and advance the
    process-wide high-water mark.  Returns ``{"bytes_in_use": max,
    "peak_bytes_in_use": max, "high_water": hw}`` over devices, or {}
    when no card reports.  Cheap host-only call — safe every step."""
    reg = registry or _metrics.get_registry()
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    in_use_max = peak_max = 0
    reported = False
    for i, d in enumerate(devices):
        stats = device_memory_stats(d)
        if not stats:
            continue
        reported = True
        in_use = stats["bytes_in_use"]
        peak = stats["peak_bytes_in_use"]
        reg.gauge("device.bytes_in_use", device=str(i)).set(in_use)
        reg.gauge("device.peak_bytes_in_use", device=str(i)).set(peak)
        reg.gauge("device.bytes_limit", device=str(i)).set(
            stats["bytes_limit"])
        in_use_max = max(in_use_max, in_use)
        peak_max = max(peak_max, peak)
    if not reported:
        return {}
    hw = reg.gauge("device.hbm_high_water_bytes")
    hw.set_max(max(in_use_max, peak_max))
    return {"bytes_in_use": in_use_max, "peak_bytes_in_use": peak_max,
            "high_water": hw.value}
