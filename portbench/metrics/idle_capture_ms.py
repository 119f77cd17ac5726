"""Milliseconds a profiled panorama in which the device was idle while
the host was inside the program's ``graphs.capture`` spans: each span
placed on the profiler's clock by the panorama's ``register`` span
against the benchmark's ``portbench.register`` span (which starts a few
us before it, ``program.on_profile``), intersected with the gaps in the
union of the device's operations."""
from portbench.program import idle_us, on_profile

MOVES = "pano_s"


def read(trace):
    per = on_profile(trace, "graphs.capture")
    if not per or not trace.device:
        return None
    us = sum(idle_us(trace.device, trace.window_us, spans) for spans in per)
    return us / 1e3 / len(per)
