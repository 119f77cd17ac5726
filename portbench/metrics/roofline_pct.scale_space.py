"""The scale space's share of its roofline: the least time of every
octave's Gaussian, DoG and score planes of every view (``cost.py``, from
shapes alone) over the device time of the kernels below per panorama.

The time is read by kernel name: a change that renames or replaces these
kernels leaves the metric silent (absent), never 0. Events recorded
inside the captured graphs would time the stage whatever computes it."""
from portbench.cost import scale_space_bound_ms

MOVES = "pano_s"
KERNELS = ("octave_stack_kernel", "p360_sift_small_octave_kernel")


def read(trace):
    us = sum(e - s for name, s, e in trace.device
             if any(k in name for k in KERNELS))
    if us <= 0 or trace.panoramas <= 0:
        return None
    ms = us / 1e3 / trace.panoramas
    bound = scale_space_bound_ms(trace.shapes["views"], trace.shapes["shape"])
    return 100.0 * bound / ms
