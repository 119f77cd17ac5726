"""Mpix of the render's padded patches a window panorama: the program's
counter ``render.patch_px`` (``render.plan_layout``: views x patch
height x patch width, every patch padded to the largest footprint, the
canvas's width where a view spans every azimuth), from the totals that
the stages leave in ``stats``. A program without the counter leaves the
metric out."""
from portbench.program import counter

MOVES = "pano_s"


def read(trace):
    got = counter(trace, "render.patch_px")
    return None if got is None else got / 1e6
