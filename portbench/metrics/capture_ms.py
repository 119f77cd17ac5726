"""Host milliseconds a window panorama inside the program's
``graphs.capture`` spans (a step's eager first run and its capture),
from the totals that the stages leave in ``stats``."""
from portbench.program import span_ms

MOVES = "pano_s"


def read(trace):
    return span_ms(trace, ["graphs.capture"])
