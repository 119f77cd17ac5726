"""CUDA graphs the program captures a window panorama: its counter
``graphs.captures`` (``graphs.capture``), from the totals that the
stages leave in ``stats``. Each capture runs its step eagerly once and
records it; ``register.traverse`` captures its add, LM and polish steps
on every call."""
from portbench.program import counter

MOVES = "pano_s"


def read(trace):
    return counter(trace, "graphs.captures")
