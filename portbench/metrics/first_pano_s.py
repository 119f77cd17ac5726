"""Seconds of the cold first panorama through ``cli.run_images`` in the
run's set-up (a fresh cache directory: the CUDA graphs' captures, lazy
initialisation, the match and BA cache writes), what a CLI user pays on
every invocation. One sample a run, so it swings by 13-20 % between runs
and carries no bound; it is part of ``setup_s``."""
MOVES = "setup_s"


def read(trace):
    return trace.setup.get("first_pano_s")
