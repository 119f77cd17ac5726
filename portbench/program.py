"""What a traced run reads of the program's own recorder
(``pano360_tpu_torch.profiling``): the stages that take a ``stats`` dict
leave in it the process's totals (``stats["totals"]``: each span name's
count, total and self ns, the counters, the kernels' launches) and the
spans closed during the call (``stats["spans"]``: (name, parent,
start_ns, end_ns) on ``time.time_ns``'s clock).

A program without the recorder leaves neither: every function here then
returns None, and the metric is left out of the line."""
from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.trace import SPAN_PREFIX


def _ends(trace) -> Optional[Tuple[dict, dict, int]]:
    """(first totals, last totals, panoramas between them) of the
    window's panoramas: the difference covers whole cycles of every
    stage (render, features, match, keypoints, register)."""
    got = [s["totals"] for s in trace.stats if "totals" in s]
    if len(got) < 2:
        return None
    return got[0], got[-1], len(got) - 1


def counter(trace, name: str) -> Optional[float]:
    """The program's counter ``name`` a window panorama."""
    ends = _ends(trace)
    if ends is None or name not in ends[1]["counters"]:
        return None
    first, last, n = ends
    return (last["counters"][name] - first["counters"].get(name, 0)) / n


def span_ms(trace, names, key: str = "total_ns") -> Optional[float]:
    """Milliseconds a window panorama of the program's spans ``names``,
    summed: their total time, or with ``key="self_ns"`` the time their
    child spans do not cover."""
    ends = _ends(trace)
    if ends is None or any(n not in ends[1]["spans"] for n in names):
        return None
    first, last, n = ends
    ns = sum(last["spans"][m][key]
             - first["spans"].get(m, {}).get(key, 0) for m in names)
    return ns / 1e6 / n


def on_profile(trace, name: str) -> Optional[List[List[Tuple[float, float]]]]:
    """Each profiled panorama's program spans ``name`` on the profiler's
    clock (us), or None.

    The profiler gives its events relative to its own start, the program
    its stamps in Unix ns. A panorama's offset between the two is its
    ``register`` span's start against the start of the benchmark's
    ``portbench.register`` host span around the same call, which begins
    a few us before the program's (the call into ``traverse``): every
    span placed this way lies those few us late at most."""
    hosts = sorted((s, e) for n, s, e in trace.host_spans
                   if n == SPAN_PREFIX + "register")
    stats = trace.stats[:trace.panoramas]
    if not stats or len(hosts) < len(stats):
        return None
    out = []
    for (h0, _), st in zip(hosts, stats):
        spans = st.get("spans")
        reg = [s for s in spans or () if s[0] == "register"]
        if not reg:
            return None
        offset = h0 - reg[0][2] / 1e3
        out.append([(s / 1e3 + offset, e / 1e3 + offset)
                    for n, _, s, e in spans if n == name])
    return out


def idle_us(device, window, intervals) -> float:
    """The part of ``intervals`` (start, end us) inside ``window`` in
    which no device operation ran."""
    lo, hi = window
    busy = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in device):
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    total = 0.0
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        covered = sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
        total += (b - a) - covered
    return total


__all__ = ["counter", "span_ms", "on_profile", "idle_us"]
