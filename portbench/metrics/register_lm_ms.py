"""Host milliseconds a window panorama of the registration's adds, LM
and polish drives, the graphs' captures left out: the self time of the
program's spans ``register.lm`` and ``register.polish`` (their total less
the ``graphs.capture`` spans inside), from the totals that the stages
leave in ``stats``."""
from portbench.program import span_ms

MOVES = "pano_s"


def read(trace):
    return span_ms(trace, ["register.lm", "register.polish"], "self_ns")
