"""Levenberg-Marquardt iterations a panorama's registration runs: the
LM's after every add and the final polish's, as ``register.traverse``
counts them in its ``stats``, averaged over the traced window."""
MOVES = "pano_s"


def read(trace):
    got = [sum(s["lm_iterations"]) + s["polish_iterations"]
           for s in trace.stats if "lm_iterations" in s]
    return sum(got) / len(got) if got else None
