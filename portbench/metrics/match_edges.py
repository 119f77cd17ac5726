"""Edges the match graph keeps a window panorama: the program's counter
``match.edges`` (``pipeline.matching``, the pairs whose RANSAC passed,
read from the rows already on the host), from the totals that the
stages leave in ``stats``. Its pairs tried, ``match.pairs``, are
n (n - 1) / 2 of the views. A program without the counter leaves the
metric out."""
from portbench.program import counter

MOVES = "pano_s"


def read(trace):
    return counter(trace, "match.edges")
