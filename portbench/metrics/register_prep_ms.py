"""Host milliseconds a window panorama of the registration before its
LM: the program's spans ``register.schedule`` (the heap walk, the
packing and the uploads) and ``register.rotations`` (the focal and each
add's SVD), from the totals that the stages leave in ``stats``."""
from portbench.program import span_ms

MOVES = "pano_s"


def read(trace):
    return span_ms(trace, ["register.schedule", "register.rotations"])
