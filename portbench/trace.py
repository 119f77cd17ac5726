"""What a traced run reads from ``torch.profiler``: device intervals, their
union, sums by kernel name, and the idle gaps named by the benchmark's
own span the host was in. Frozen copies of ``chip_smoke.py``'s
``busy_us`` and by-name sums."""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

SPAN_PREFIX = "portbench."
PANORAMA_SPAN = "portbench:panorama"   # one profiled panorama, whole


class Trace(NamedTuple):
    """A traced window's readings, the input of every per-layer reader."""

    spans: Dict[str, List[float]]     # span name -> seconds, one a panorama
    stats: List[dict]                 # per panorama, the stages' counters
    device: List[Tuple[str, float, float]]   # (name, start us, end us)
    host_spans: List[Tuple[str, float, float]]   # our spans, profiler clock
    window_us: Tuple[float, float]    # the profiled panoramas' interval
    panoramas: int                    # panoramas under the profiler
    shapes: dict                      # the cell's sizes (views, shape)
    setup: dict                       # readings outside the profile


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def by_name(device) -> Dict[str, Tuple[float, int]]:
    """{device operation: (total us, count)}."""
    out: Dict[str, Tuple[float, int]] = {}
    for name, s, e in device:
        t, c = out.get(name, (0.0, 0))
        out[name] = (t + (e - s), c + 1)
    return out


def idle_gaps(device, host_spans, window) -> List[Tuple[str, float]]:
    """Every stretch of the window in which no device operation ran, as
    (the span the host was in when it began, or "host", seconds)."""
    lo, hi = window
    merged: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in device):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, t = [], lo
    for s, e in merged + [[hi, hi]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    out = []
    for s, e in gaps:
        name = "host"
        for span, a, b in host_spans:
            if a <= s < b:
                name = span[len(SPAN_PREFIX):]
                break
        out.append((name, (e - s) / 1e6))
    return out


def from_profile(prof) -> Tuple[list, list, Tuple[float, float]]:
    """(device operations, our stage spans, the interval of the profiled
    panoramas) of a ``torch.profiler`` run, on the profiler's clock (us);
    the operations and spans as (name, start, end)."""
    from torch.autograd import DeviceType
    device, host, pano = [], [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors our spans on the device's timeline as
            # annotations: they are not device work
            if not e.name.startswith(("portbench.", PANORAMA_SPAN)):
                device.append(span)
        elif e.name == PANORAMA_SPAN:
            pano.append(span)
        elif e.name.startswith(SPAN_PREFIX):
            host.append(span)
    window = (min(s for _, s, _ in pano), max(e for _, _, e in pano))
    return device, host, window


__all__ = ["Trace", "busy_us", "by_name", "idle_gaps", "from_profile",
           "SPAN_PREFIX", "PANORAMA_SPAN"]
