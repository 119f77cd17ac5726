"""The share of the profiled panoramas' wall time in which no operation
ran on the device: 100 (1 - union of device intervals / wall)."""
from portbench.trace import busy_us

MOVES = "pano_s"


def read(trace):
    lo, hi = trace.window_us
    if not trace.device or hi <= lo:
        return None
    busy = busy_us([(max(s, lo), min(e, hi)) for _, s, e in trace.device
                    if e > lo and s < hi])
    return 100.0 * (1.0 - busy / (hi - lo))
