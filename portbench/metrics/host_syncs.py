"""Host syncs a window panorama: the program's counter ``host_syncs``,
counted where the host waits for the device (reads back, blocking
copies, the linear-algebra calls that check their result), from the
totals that the stages leave in ``stats``."""
from portbench.program import counter

MOVES = "pano_s"


def read(trace):
    return counter(trace, "host_syncs")
