"""The JAX package's grid descriptor turned the way the port turns its
own, for the tests that hold the port to the JAX package.

The port turns its descriptor's 16x16 grid with the keypoint's angle,
counter-clockwise on screen as the angle is (the gradients' y points
up, the pixels' down). The JAX package's
``features.sift._descriptor_from_patch`` turns the grid clockwise, the
other way, so a view turned in plane by theta misaligns its descriptors
by 2 theta there. The two are one exact transform apart:

    port(gx, gy, theta) = mirror(jax(gx, -gy, -theta))

Negating gy and theta makes the JAX package sample the port's positions
and gives every gradient the negated angle against the keypoint;
``mirror`` takes orientation bin k of each of the 16 cells to
(-k) mod 8 (the 8 bins last in the 128) and puts the angle back. At
theta = 0 both are the same descriptor. The transform holds to float32
rounding, so the tests keep their tolerances.
"""
import contextlib

import jax
import pytest

from pano360_tpu.features import sift as jsift

NOB = 8
ORIGINAL = jsift._descriptor_from_patch


def mirror(desc):
    """Orientation bin k -> (-k) mod 8 in every cell of (..., 128)
    descriptors (numpy or JAX arrays)."""
    shape = desc.shape
    cells = desc.reshape(shape[:-1] + (-1, NOB))
    return cells[..., [(-k) % NOB for k in range(NOB)]].reshape(shape)


def turned(gx, gy, yf, xf, cy, cx, sig, angle, h, w, cfg):
    """``_descriptor_from_patch`` with the port's turn of the grid."""
    return mirror(ORIGINAL(gx, -gy, yf, xf, cy, cx, sig, -angle, h, w,
                           cfg))


@contextlib.contextmanager
def port_grid():
    """Inside, the JAX package's extraction (and every pipeline that
    traces it) takes ``turned`` for its grid descriptor. JAX's caches are
    cleared on the way in and out, so that no program traced outside is
    replayed inside, nor the other way."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsift, "_descriptor_from_patch", turned)
        try:
            yield
        finally:
            jax.clear_caches()
